"""The JAX package's examples run on the port, on the CPU.

A fixture points ``neilpy_tpu`` and each of its submodules in
``sys.modules`` at the ``neilpy_tpu_torch`` module of the same path and
sets the port's default device to the CPU, so each example's own
``import neilpy_tpu as nt`` gets the port; then each of the ten
non-``slow`` examples of ``tests/test_examples.py`` runs as that test
runs it (``EXAMPLE_FAST=1``, ``OUT_DIR=tmp_path``), with the same
assertions.  Each example's own asserted oracles then check the port's
numbers.  ``sys.modules`` is restored exactly afterwards: the worker runs
JAX test files in this same process.

The examples stay the JAX package's: a port output on the card would
need ``.cpu()`` before ``np.asarray`` (a JAX array converts anywhere),
which is why they run on the port on the CPU.  No example fails on the
port for a method that JAX arrays have and tensors lack, so none is
listed as an exception.
"""

import os
import pkgutil
import runpy
import sys

import numpy as np
import pytest
import torch

import neilpy_tpu_torch as ntt
from neilpy_tpu_torch.core import device as port_device
from neilpy_tpu_torch.dist import api as port_dist_api

pytestmark = pytest.mark.heavy

torch.set_num_threads(1)

_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _aliased(name):
    return name == "neilpy_tpu" or name.startswith("neilpy_tpu.")


@pytest.fixture
def on_port(monkeypatch, tmp_path):
    """``neilpy_tpu`` is the port, on the CPU, for the test's duration."""
    import neilpy_tpu  # noqa: F401  (the JAX package, restored afterwards)
    jax_package = sys.modules["neilpy_tpu"]
    for m in pkgutil.walk_packages(ntt.__path__, "neilpy_tpu_torch."):
        __import__(m.name)
    saved = {k: v for k, v in sys.modules.items()
             if k.startswith("neilpy_tpu") or k == "_common"}
    for k in saved:
        if _aliased(k):
            del sys.modules[k]
    for k, mod in list(sys.modules.items()):
        if k.startswith("neilpy_tpu_torch"):
            sys.modules["neilpy_tpu" + k[len("neilpy_tpu_torch"):]] = mod
    monkeypatch.setattr(port_device, "_DEFAULT_DEVICE", "cpu")
    real_make_mesh = port_dist_api.make_mesh

    def make_mesh(devices=None, *args, **kwargs):
        # the examples' "every visible device" is conftest's 8 CPUs
        if devices is None:
            devices = [torch.device("cpu")] * 8
        return real_make_mesh(devices, *args, **kwargs)

    monkeypatch.setattr(port_dist_api, "make_mesh", make_mesh)
    monkeypatch.setattr(ntt.dist, "make_mesh", make_mesh)
    monkeypatch.setenv("OUT_DIR", str(tmp_path))
    monkeypatch.setenv("EXAMPLE_FAST", "1")
    try:
        yield tmp_path
    finally:
        for k in [k for k in sys.modules
                  if k.startswith("neilpy_tpu") or k == "_common"]:
            del sys.modules[k]
        sys.modules.update(saved)
    assert sys.modules["neilpy_tpu"] is jax_package


def run_example(name):
    # _common caches OUT_DIR/EXAMPLE_FAST at import: a fresh read per test
    sys.modules.pop("_common", None)
    scope = runpy.run_path(os.path.join(_EXAMPLES, name), run_name="__main__")
    assert scope["nt"] is ntt


def test_the_alias_is_the_port_and_is_undone(on_port):
    import neilpy_tpu
    import neilpy_tpu.filters
    assert neilpy_tpu is ntt
    assert neilpy_tpu.filters is ntt.filters
    assert neilpy_tpu.geomorphons(np.zeros((16, 16), np.float32)).device \
        == torch.device("cpu")


def test_the_alias_left_the_jax_package():
    import neilpy_tpu
    assert neilpy_tpu is not ntt
    assert neilpy_tpu.__file__.endswith(os.path.join("neilpy_tpu",
                                                     "__init__.py"))


def test_geomorphons_walkthrough(on_port, capsys):
    run_example("geomorphons_walkthrough.py")
    out = capsys.readouterr().out
    assert "walkthrough complete" in out
    assert (on_port / "sample_dem_geomorphons.png").exists()
    assert (on_port / "sample_dem_geomorphons.pgw").exists()
    assert (on_port / "openness.png").exists()
    assert (on_port / "terrain_code_frequencies.png").exists()


def test_curvature_comparison(on_port, capsys):
    run_example("curvature_comparison.py")
    out = capsys.readouterr().out
    assert "curvature comparison complete" in out
    assert (on_port / "evans_curvatures.png").exists()
    assert (on_port / "curvature_families.png").exists()


def test_terrain_visualization(on_port, capsys):
    run_example("terrain_visualization.py")
    out = capsys.readouterr().out
    assert "terrain visualization complete" in out
    assert (on_port / "terrain_gallery.png").exists()
    assert (on_port / "colortable_variants.png").exists()


def test_dem_filters(on_port, capsys):
    run_example("dem_filters.py")
    out = capsys.readouterr().out
    assert "dem filters complete" in out
    assert "glider advanced" in out
    assert (on_port / "dem_filters.png").exists()


def test_inpainting_dtm(on_port, capsys):
    run_example("inpainting_dtm.py")
    out = capsys.readouterr().out
    assert "inpainting complete" in out
    assert "NaNs after inpaint: 0" in out
    assert (on_port / "ground_inpainted.tif").exists()
    J, _ = ntt.imread(str(on_port / "ground_inpainted.tif"))
    assert not np.isnan(J).any()


def test_poland_tiled_geomorphons(on_port, capsys):
    run_example("poland_tiled_geomorphons.py")
    out = capsys.readouterr().out
    assert "poland tiled geomorphons complete" in out
    assert "interior agreement: 1.000000" in out
    assert (on_port / "poland_geomorphon.png").exists()
    assert (on_port / "poland_geomorphon.pgw").exists()


def test_ypr_to_opk(on_port, capsys):
    run_example("ypr_to_opk.py")
    out = capsys.readouterr().out
    assert "ypr to opk complete" in out
    assert (on_port / "poas_opk.csv").exists()
    import pandas as pd
    df = pd.read_csv(on_port / "poas_opk.csv")
    assert {"fn", "lat", "lon", "azimuth", "omega", "phi",
            "kappa"} <= set(df.columns)
    assert len(df) == 6


def test_near_earth_imaging_lab(on_port, capsys):
    run_example("near_earth_imaging_lab.py")
    out = capsys.readouterr().out
    assert "near earth imaging lab tour complete" in out
    assert "ashift(x, 0) matches" in out
    assert (on_port / "neil_tour.png").exists()
    assert (on_port / "dk22_bonemap.png").exists()
    assert (on_port / "dk22_standin.las").exists()


def test_spatial_autocorrelation(on_port, capsys):
    run_example("spatial_autocorrelation.py")
    out = capsys.readouterr().out
    assert "spatial autocorrelation complete" in out
    # conftest's 8 CPU devices: the sharded cross-check runs on the port
    assert "sharded over 8 devices" in out
    assert (on_port / "gi_hotspots.png").exists()
    assert (on_port / "curvature_hotspots.tif").exists()
    assert (on_port / "curvature_hotspots.tfw").exists()
    G, _ = ntt.imread(str(on_port / "curvature_hotspots.tif"))
    assert set(np.unique(G)) <= {-3, -2, -1, 0, 1, 2, 3}


def test_out_of_core_pipeline(on_port, capsys):
    run_example("out_of_core_pipeline.py")
    out = capsys.readouterr().out
    assert "out-of-core pipeline complete" in out
    assert (on_port / "geomorphons.tif").exists()
    assert (on_port / "cloud_classified.las").exists()
