"""Where the SMRF slice's arrays live: one rule for every entry point.

A tensor stays on its own device unless ``device`` is given.  Any other
input (numpy array, pandas column, nested lists) goes to ``device``,
which defaults to CUDA; without a CUDA device that raises rather than
running on the CPU unasked — pass ``device='cpu'`` for the host.

Unlike ``ops/visibility.py:as_raster``, which casts to float32, the
float helper keeps float64: the exact SMRF path runs in float64 on the
chosen device.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None):
    """``device`` as a ``torch.device`` (CUDA when None); a CUDA device
    on a machine without one raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch version on the host")
    return device


def to_device(A, device=None, dtype=None):
    """``A`` as a tensor on ``device`` (see the module docstring), cast to
    ``dtype`` when one is given."""
    if not isinstance(A, torch.Tensor):
        arr = np.asarray(A)
        if dtype is not None:
            arr = arr.astype(_NUMPY[dtype], copy=False)
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # e.g. a read-only memmap
            arr = arr.copy()
        A = torch.from_numpy(arr)
        device = resolve_device(device)
    if device is not None:
        A = A.to(resolve_device(device))
    return A if dtype is None else A.to(dtype)


def float_tensor(A, device=None):
    """``A`` on ``device`` as float32, or float64 where it is float64
    already (the JAX package's rule: float32 and float64 are kept, any
    other dtype becomes float32)."""
    A = to_device(A, device)
    if A.dtype not in (torch.float32, torch.float64):
        A = A.to(torch.float32)
    return A


_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
          torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_,
          torch.uint8: np.uint8}


def to_uint8(X):
    """``X`` cast to uint8 as JAX casts float to uint8: NaN -> 0, values
    clamped to [0, 255], then truncated toward zero.  A plain torch cast
    wraps out-of-range values (300 -> 44, -3 -> 253) and leaves NaN
    unspecified on CUDA, so every uint8 product of the port goes through
    here."""
    X = torch.nan_to_num(X, nan=0.0, posinf=255.0, neginf=0.0)
    return X.clamp(0, 255).to(torch.uint8)
