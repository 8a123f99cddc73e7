"""The PyTorch port imports neither JAX nor the JAX package, nor sklearn or
matplotlib, which the card's machine does not promise: every module
under ``neilpy_tpu_torch/`` (and ``chip_smoke.py`` and
``tools/demo_mosaic_torch.py``, which run where JAX is not installed) is
parsed and each of its imports checked, including
the ones inside functions."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
MODULES = sorted((REPO / "neilpy_tpu_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "neilpy_tpu", "sklearn", "matplotlib")


def imported_modules(path):
    """(line, module) of every absolute import in the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_the_guard_sees_every_module():
    names = {p.relative_to(REPO).as_posix() for p in MODULES}
    for expect in ("neilpy_tpu_torch/__init__.py",
                   "neilpy_tpu_torch/pipelines/smrf.py",
                   "neilpy_tpu_torch/ops/pointgrid.py",
                   "neilpy_tpu_torch/ops/surface.py",
                   "neilpy_tpu_torch/ops/stats.py",
                   "neilpy_tpu_torch/viz/shading.py",
                   "neilpy_tpu_torch/dist/smrf.py",
                   "neilpy_tpu_torch/dist/tiling.py",
                   "neilpy_tpu_torch/pipelines/mosaic.py",
                   "neilpy_tpu_torch/_host_build.py",
                   "neilpy_tpu_torch/io/tiff_codec.py",
                   "neilpy_tpu_torch/io/las_native.py",
                   "neilpy_tpu_torch/ops/binning_native.py",
                   "neilpy_tpu_torch/geo/proj.py",
                   "neilpy_tpu_torch/geo/ntv2.py",
                   "neilpy_tpu_torch/geo/geoid.py",
                   "neilpy_tpu_torch/photo/gnss.py",
                   "neilpy_tpu_torch/photo/exif.py",
                   "neilpy_tpu_torch/utils.py",
                   "neilpy_tpu_torch/filters.py",
                   "neilpy_tpu_torch/profiling.py"):
        assert expect in names
    assert forbidden("jax.numpy") and forbidden("neilpy_tpu.ops.inpaint")
    assert forbidden("sklearn.metrics") and forbidden("matplotlib.pyplot")
    assert not forbidden("neilpy_tpu_torch.ops.inpaint")


@pytest.mark.parametrize("path", MODULES + [REPO / "chip_smoke.py",
                                             REPO / "tools" /
                                             "demo_mosaic_torch.py"],
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_module_imports_no_jax(path):
    bad = [(line, m) for line, m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"
