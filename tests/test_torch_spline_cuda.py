"""The spline's Thomas solve as one kernel launch
(``neilpy_tpu_torch/ops/spline.py``: ``_thomas``, ``_thomas_cuda``,
``_thomas_eager``, ``_device_factors``; ``csrc/thomas_sweep.cu``).

On the CPU: a CPU tensor takes the plain version (the span's ``path``
reads ``eager``) and launches nothing; the factor tensors are built once
per (rows, dtype, device) and hold ``_thomas_factors``' factors.  The
``cuda`` tests hold the kernel to the plain version on the card bit for
bit, in float32 and float64, at SMRF's shapes and at small and tall ones,
and one ``smrf`` call to the eager path; they need no JAX:
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_spline_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

import neilpy_tpu_torch as ntt
from neilpy_tpu_torch import profiling
from neilpy_tpu_torch.ops import spline

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def surface(n, seed=0, dtype=torch.float64, device=CPU):
    """An n x n rough terrain-like raster (a 2-D random walk)."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, n)).cumsum(0).cumsum(1) * 0.01
    return torch.from_numpy(Z).to(device=device, dtype=dtype)


# ----------------------------------------------------------------------
# CPU
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensors_take_the_eager_path(dtype):
    Z = surface(40, dtype=dtype)
    launches = spline._thomas_cuda.launches
    with _profile():
        pass
    profiling.clear_spans()
    with _profile():
        got = spline.spline_coefficients_2d(Z, device=CPU)
    thomas = [s for s in profiling.spans() if s.name == "spline.thomas"]
    assert [s.attr for s in thomas] == [{"path": "eager"}] * 3
    assert spline._thomas_cuda.launches == launches
    # the dispatcher's CPU path is the plain version itself
    rhs = spline._notaknot_rhs(Z)
    assert torch.equal(spline._thomas(rhs), spline._thomas_eager(rhs))
    assert all(t.dtype == dtype for t in got)


def test_the_kernel_wrapper_refuses_a_cpu_tensor():
    launches = spline._thomas_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        spline._thomas_cuda(torch.zeros(5, 3))
    assert spline._thomas_cuda.launches == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_factor_tensors_are_cached_per_rows_dtype_device(dtype):
    m = 1999 if dtype == torch.float32 else 37
    first = spline._device_factors(m, dtype, CPU)
    misses = spline._device_factors.cache_info().misses
    again = spline._device_factors(m, dtype, CPU)
    assert again is first
    assert spline._device_factors.cache_info().misses == misses
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    a, denom, cp = spline._thomas_factors(m, np_dtype)
    assert first.shape == (3, m) and first.dtype == dtype
    assert first.is_contiguous()
    assert first[0].numpy().tolist() == list(a)
    assert first[2].numpy().tolist() == list(cp)
    inv = [np_dtype(1) / d for d in denom]
    assert first[1].numpy().tolist() == inv
    # another row count is another entry
    other = spline._device_factors(m + 1, dtype, CPU)
    assert other is not first and other.shape == (3, m + 1)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def smrf_rhs(case, dtype, device):
    """The three right-hand sides of one SMRF spline coefficient set at
    the 2001^2 grid, 1999 x 2001 each: of Z.T (``Mx``'s solve), of Z
    (``My``'s) and of Mx (``Mxy``'s)."""
    Z = surface(2001, seed=3, dtype=dtype, device=device)
    if case == "Z.T":
        return spline._notaknot_rhs(Z.T.contiguous())
    if case == "Z":
        return spline._notaknot_rhs(Z)
    Mx = spline._thomas_eager(spline._notaknot_rhs(Z.T.contiguous()))
    Mx = torch.cat([2.0 * Mx[:1] - Mx[1:2], Mx, 2.0 * Mx[-1:] - Mx[-2:-1]])
    return spline._notaknot_rhs(Mx.T.contiguous())


SHAPES = [("smrf", "Z"), ("smrf", "Z.T"), ("smrf", "Mx"),
          ((3, 1), None), ((3, 31), None), ((3, 33), None),
          ((3, 2001), None), ((4096, 3), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,case", SHAPES)
def test_kernel_equals_the_eager_loop_on_card(card, dtype, shape, case):
    if shape == "smrf":
        rhs = smrf_rhs(case, dtype, card)
    else:
        rng = np.random.default_rng(sum(shape))
        rhs = torch.from_numpy(rng.normal(size=shape) * 10.0).to(
            device=card, dtype=dtype)
    launches = spline._thomas_cuda.launches
    got = spline._thomas_cuda(rhs)
    want = spline._thomas_eager(rhs)
    torch.cuda.synchronize(card)
    assert spline._thomas_cuda.launches == launches + 1
    assert got.dtype == dtype and got.shape == rhs.shape
    assert bool(torch.isfinite(want).all())
    assert float((got - want).abs().max()) == 0.0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_trailing_shape_is_flattened_on_card(card):
    rhs = torch.randn(50, 4, 6, device=card, dtype=torch.float64)
    got = spline._thomas_cuda(rhs)
    assert got.shape == rhs.shape
    assert torch.equal(got.reshape(50, 24),
                       spline._thomas_eager(rhs.reshape(50, 24)))


@pytest.mark.cuda
def test_the_kernel_wrapper_refuses_what_it_does_not_take_on_card(card):
    launches = spline._thomas_cuda.launches
    with pytest.raises(ValueError, match="float32 or float64"):
        spline._thomas_cuda(torch.zeros(5, 3, device=card,
                                        dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        spline._thomas_cuda(torch.zeros(3, 5, device=card).T)
    assert spline._thomas_cuda.launches == launches


@pytest.mark.cuda
def test_coefficients_make_no_copy_or_sync_on_card(card):
    """After the first call for its rows, a coefficient set neither
    uploads its factors nor waits for the card."""
    Z = surface(301, seed=5, dtype=torch.float32, device=card)
    spline.spline_coefficients_2d(Z)
    torch.cuda.synchronize(card)
    misses = spline._device_factors.cache_info().misses
    torch.cuda.set_sync_debug_mode("error")
    try:
        spline.spline_coefficients_2d(Z)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert spline._device_factors.cache_info().misses == misses


@pytest.mark.cuda
def test_smrf_through_the_kernel_equals_eager_on_card(card, monkeypatch):
    rng = np.random.default_rng(7)
    n, side = 60_000, 160.0
    u, v = rng.uniform(0, side, n), rng.uniform(0, side, n)
    z = 100 + 0.05 * u + np.where((u > 40) & (u < 60) & (v > 50)
                                  & (v < 80), 8.0, 0.0)
    z = z + rng.normal(0, 0.05, n)
    x, y = 500000.0 + u, 4200000.0 + v
    for precision in ("fast", "exact"):
        launches = spline._thomas_cuda.launches
        with _profile():
            pass
        profiling.clear_spans()
        with _profile():
            dtm, _, cells, labels = ntt.smrf(x, y, z, precision=precision,
                                             device=card)
        torch.cuda.synchronize(card)
        assert spline._thomas_cuda.launches == launches + 6
        thomas = [s for s in profiling.spans() if s.name == "spline.thomas"]
        assert [s.attr for s in thomas] == [{"path": "cuda"}] * 6
        with monkeypatch.context() as mp:
            mp.setattr(spline, "_thomas_cuda", spline._thomas_eager)
            dtm_e, _, cells_e, labels_e = ntt.smrf(
                x, y, z, precision=precision, device=card)
        assert spline._thomas_cuda.launches == launches + 6
        assert torch.equal(labels, labels_e)
        assert torch.equal(cells, cells_e)
        assert torch.equal(dtm, dtm_e)
