"""``tiled_apply`` with ``fn`` returning several rasters of one shape and
dtype, at pipeline depths 0 and 2: every result equals the host's, and on
the card the readback pool (one per shape and dtype) holds as many
buffers per tile in flight as the tile has results, so the loop never
waits for a buffer that only the writer could return.

No JAX here, so the ``cuda`` cases run on the card with
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_tiled_readback.py``.  A call that has not returned
within 120 s fails.
"""

import threading

import numpy as np
import pytest
import torch

from neilpy_tpu_torch.dist.tiling import tiled_apply


def run_within(call, seconds=120):
    box = {}
    th = threading.Thread(target=lambda: box.update(out=call()), daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), "tiled_apply waits for a readback buffer"
    return box["out"]


def check_results(device, k, depth, device_input):
    Z = np.random.default_rng(21).normal(size=(256, 256)).cumsum(
        axis=0).astype(np.float32)
    got = run_within(lambda: tiled_apply(
        lambda t: tuple(t * (i + 1) for i in range(k)), Z, 64, 4,
        pipeline_depth=depth, device_input=device_input, device=device))
    assert len(got) == k
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, Z * (i + 1))


@pytest.mark.parametrize("device_input", [False, True])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("depth", [0, 2])
def test_several_results_of_one_shape(k, depth, device_input):
    check_results(torch.device("cpu"), k, depth, device_input)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("device_input", [False, True])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("depth", [0, 2])
def test_several_results_of_one_shape_on_card(cuda_device, k, depth,
                                              device_input):
    check_results(cuda_device, k, depth, device_input)
