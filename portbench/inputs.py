"""Inputs made on the device from ``--seed``, in a few large calls.

- ``bench_input``: ``chip_smoke.py:bench_input`` (bench.py's input),
  cumulative sums of seeded normals along both axes, float32, for
  ``n`` rasters at once;
- ``synth_dem``: ``tools/demo_mosaic_torch.py:synth_dem``'s formula
  (smooth low-frequency relief plus row-integrated noise, each row's
  noise centred), the same terrain recipe in torch on the device.

The same seed on the same device gives the same inputs.
"""

from __future__ import annotations

import torch


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 64)
    return g


def bench_input(n, shape, seed, device):
    """(n, H, W) float32: ``cumsum(N, rows) + cumsum(N, columns)`` of
    standard normals N."""
    N = torch.randn((n, *shape), generator=generator(seed, device),
                    dtype=torch.float32, device=device)
    return N.cumsum(1).add_(N.cumsum(2))


def synth_dem(side, seed, device):
    """(side, side) float32: 300 cos(y/11000) + 120 sin(y/1700) + 400
    sin(x/9000) + 150 sin(x/1300 + 1.7) plus, per row, the centred
    cumulative sum of normals of standard deviation 1.5 (float64 until
    the last cast)."""
    f64 = dict(dtype=torch.float64, device=device)
    xs = torch.arange(side, **f64)
    lowx = 400 * torch.sin(xs / 9000) + 150 * torch.sin(xs / 1300 + 1.7)
    lowy = 300 * torch.cos(xs / 11000) + 120 * torch.sin(xs / 1700)
    Z = torch.randn((side, side), generator=generator(seed, device), **f64)
    Z.mul_(1.5).cumsum_(1)
    Z.sub_(Z.mean(dim=1, keepdim=True))
    Z.add_(lowy[:, None]).add_(lowx[None, :])
    return Z.to(torch.float32)
