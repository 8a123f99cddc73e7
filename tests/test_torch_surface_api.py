"""The port's public surface held to the JAX package's, module by module.

Every public function and class of every ``neilpy_tpu`` module (its
``__all__`` where it has one) is in the ``neilpy_tpu_torch`` module of the
same path, and every shared callable takes the JAX parameters in the JAX
order; the port may add ``device`` (where numpy input goes).  Each
difference that is by design is in ``WHITELIST`` with its reason, and the
test fails if an entry is no longer needed.
"""

import importlib
import importlib.util
import inspect
import pkgutil

import pytest

import neilpy_tpu as nt
import neilpy_tpu_torch as ntt

WHITELIST = {
    "aot": "not carried over: the JAX package's persistent cache of "
           "compiled executables; the port's build cache (_build.py, "
           "_host_build.py: libraries keyed by a hash of their sources) "
           "already avoids paying for a compile again in a fresh process",
    "dist.halo.halo_exchange_2d": "single-process mesh (dist/halo.py:1-10): "
           "one call exchanges the halos of all blocks of the mesh, where "
           "the JAX function runs per shard inside shard_map and takes its "
           "axis names and the mesh shape",
    "dist.halo.block_origin": "single-process mesh (dist/halo.py:1-10): "
           "the block's mesh index is passed in, where the JAX function "
           "reads it from shard_map's axis names",
    "ops.visibility.count_openness(engine=)": "the port chooses the CUDA "
           "kernel or its plain PyTorch version by engine=, as the other "
           "visibility functions do; the JAX function has the Pallas "
           "kernel only",
    "ops.visibility.directional_ratio_extrema(engine=)": "as "
           "count_openness: engine= picks the CUDA kernel K3 or its plain "
           "version",
    "dist.Mesh": "the port's own 2-D grid of torch devices, where the JAX "
           "package takes jax.sharding.Mesh",
}

# ops.pallas_scan's Pallas entries are the CUDA kernels' wrappers here
PALLAS_TO_CUDA = "ops.pallas_scan", "ops.cuda_scan"

# the reference's export list (tests/test_stats_viz_aux.py,
# test_public_api_surface; reference neilpy/__init__.py:1)
REFERENCE_NAMES = """coord_transform imread imwrite gi_formula
gistar_formula rasterGi esri_slope edges_from_IT slope aspect
curvature esri_curvature zevenbergen_and_thorne_curvature
evans_curvature wilson_gallant_curvature hillshade
multiple_illumination pssm z_factor great_circle_distance read_las
create_dem inpaint_nans_by_fda unique_rows inpaint_nans_by_springs
inpaint_nearest ashift progressive_window openness skyview_factor
ternary_pattern_from_openness int2base get_lowest_equivalent
terrain_code_to_geomorphon geomorphon_cmap geomorphon_cmap_old
write_worldfile geomorphons2 count_openness geomorphons
progressive_filter smrf triangle_height vip_score swiss_shading
colortable_shade rmse cutter normalize
brassel_atmospheric_perspective reduce_peaks
topographic_position_index read_llh read_pos exif_dict_to_dd
dd_to_exif_tuple read_geotags_into_df stringify_time
fix_gopro_bad_time_resolution set_print_options ypr2opk
track2azimuth distance_kernel scaled_morphometry score
shi_landslides posprocessor voxelize ppk_images
fix_gopro_bad_time_resolution2 bdr chamfer_distance
hungarian_algorithm bdr_bootstrap""".split()


def jax_modules():
    """Every module of the JAX package by its path below the package,
    but the one not carried over."""
    return sorted(m.name[len("neilpy_tpu."):]
                  for m in pkgutil.walk_packages(nt.__path__, "neilpy_tpu.")
                  if m.name != "neilpy_tpu.aot")


def public(mod):
    """The module's public functions and classes: its ``__all__``, else
    what it defines without a leading underscore."""
    if hasattr(mod, "__all__"):
        names = mod.__all__
    else:
        names = [n for n, v in vars(mod).items() if not n.startswith("_")
                 and getattr(v, "__module__", None) == mod.__name__]
    return [n for n in names
            if inspect.isfunction(getattr(mod, n))
            or inspect.isclass(getattr(mod, n))]


def port_twin(rel, name):
    """(port module path, name) of the JAX module ``rel``'s ``name``."""
    if rel == PALLAS_TO_CUDA[0]:
        return PALLAS_TO_CUDA[1], name.replace("_pallas", "") + "_cuda"
    return rel, name


def signature(obj):
    return inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)


def test_public_api_surface():
    """The port twin of tests/test_stats_viz_aux.py's reference list."""
    missing = [n for n in REFERENCE_NAMES if not hasattr(ntt, n)]
    assert not missing, f"missing API parity names: {missing}"


def test_top_level_names_are_the_jax_packages_but_aot():
    ours = {n for n in dir(ntt) if not n.startswith("_")}
    theirs = {n for n in dir(nt) if not n.startswith("_")}
    assert theirs - ours == {"aot"}
    assert "aot" in WHITELIST
    assert ntt.neilpy_dir.endswith("neilpy_tpu_torch")
    assert ntt.utils.voxelize is ntt.voxelize
    assert ntt.profiling.Throughput is ntt.Throughput


def test_every_jax_module_is_walked():
    mods = jax_modules()
    assert {"utils", "filters", "profiling", "core.shift", "dist.halo",
            "ops.pallas_scan", "pipelines.mosaic"} <= set(mods)
    assert "aot" not in mods


@pytest.mark.parametrize("rel", jax_modules())
def test_module_names_and_signatures_match(rel):
    mod = importlib.import_module(f"neilpy_tpu.{rel}")
    for name in public(mod):
        trel, tname = port_twin(rel, name)
        tmod = importlib.import_module(f"neilpy_tpu_torch.{trel}")
        assert hasattr(tmod, tname), f"neilpy_tpu_torch.{trel}.{tname}"
        if rel == PALLAS_TO_CUDA[0]:
            continue  # kernels' wrappers: Pallas tiling vs CUDA launch
        obj = getattr(tmod, tname)
        key = f"{obj.__module__[len('neilpy_tpu_torch.'):]}.{tname}"
        if key in WHITELIST:
            continue
        jax_params = list(signature(getattr(mod, name)).parameters.values())
        ours = list(signature(obj).parameters.values())
        jax_names = [p.name for p in jax_params]
        added = [p.name for p in ours if p.name not in jax_names]
        allowed = {"device"} | {p for p in ("engine",)
                                if f"{key}(engine=)" in WHITELIST}
        assert set(added) <= allowed, f"{key} adds {added}"
        kept = [(p.name, p.kind) for p in ours if p.name in jax_names]
        assert kept == [(p.name, p.kind) for p in jax_params], key


@pytest.mark.parametrize("entry", sorted(WHITELIST))
def test_every_whitelist_entry_is_still_needed(entry):
    """Each exemption names a real difference."""
    if entry == "aot":
        assert not hasattr(ntt, "aot")
        assert importlib.util.find_spec("neilpy_tpu_torch.aot") is None
        return
    path, _, param = entry.partition("(")
    rel, name = path.rsplit(".", 1)
    ours = getattr(importlib.import_module(f"neilpy_tpu_torch.{rel}"), name)
    theirs = getattr(importlib.import_module(f"neilpy_tpu.{rel}"), name,
                     None)
    if theirs is None:  # a name only the port has
        assert inspect.isclass(ours)
        return
    ours, theirs = signature(ours), signature(theirs)
    if param:
        p = param.rstrip("=)")
        assert p in ours.parameters and p not in theirs.parameters
    else:
        assert list(ours.parameters) != list(theirs.parameters)
