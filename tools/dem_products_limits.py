#!/usr/bin/env python3
"""Readings that set the limits and tie bands of the benchmark cell
``dem_products.resident``: per seed, at the cell's size on a CUDA card,
one job on each of two of the cell's DEMs judged against the float64
reference, with what the judgement's numbers do not show, and, on the
first DEM, the bfloat16 and float16 references and five faults put in
the program's place.

    python3 tools/dem_products_limits.py --seeds 1 2 3 \
        [--device cuda:0] [--raster 512]

Prints one JSON line per seed.  Per DEM: ``numbers`` (the cell's
judged numbers), ``mask_share_pct`` (the float64 mask's share of the
finite pixels), ``void_share_pct``, ``shade_px_off`` and
``shade_worst_tie_dist`` (the hillshade pixels a level off, and the
largest distance of their float64 255 H from x.5), ``mask_px_off`` and
``mask_worst_edge_dist`` (the mask pixels that differ, and the largest
distance of their nearest float64 z from the bin's edge), ``z_max_err``
(per radius, the largest |z - float64 z| of the port's Gi* anywhere).
``--raster`` cuts the DEMs to a side for a rehearsal on the CPU.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELL = "dem_products.resident"


def faults(cfg):
    import torch
    small, big = cfg["radii"]
    return {"bfloat16": dict(dtype=torch.bfloat16),
            "float16": dict(dtype=torch.float16),
            "gi_not_star": dict(star=False),
            "larger_radius_dropped": dict(radii=[small]),
            "square_for_the_disk": dict(square={big: big}),
            "voids_filled_with_0": dict(void_fill=0.0),
            "azimuth_316": dict(azimuth=316.0)}


def dem_readings(dut, i, cfg, reference, with_faults):
    import torch
    import neilpy_tpu_torch as ntt
    from portbench import harness
    Z = dut.dems[i]
    got = dut._run(i, harness.spans(False))
    ktan = ntt.evans_curvature(Z, cfg["cellsize"])[3]
    zs = [ntt.rasterGi(ktan, ntt.disk(r), star=True)[0]
          for r in cfg["radii"]]
    del ktan
    want = reference.products(Z, cfg)
    shade = want["shade"]
    off = got[0].int() != want["hillshade"].int()
    tie = (shade - shade.floor() - 0.5).abs()
    diff = got[2] != want["mask"]
    edge = torch.stack([(z + reference.Z_EDGE).abs()
                        for z in want["z"]]).amin(0)
    out = {"numbers": reference.differences(got, want, Z, cfg),
           "mask_share_pct": reference.mask_share(want),
           "void_share_pct": 100 * float(torch.isnan(Z).float().mean()),
           "shade_px_off": int(off.sum()),
           "shade_worst_tie_dist": (float(tie[off].max()) if off.any()
                                    else None),
           "mask_px_off": int(diff.sum()),
           "mask_worst_edge_dist": (float(edge[diff].max()) if diff.any()
                                    else None),
           "z_max_err": [float((a.double() - b).abs().nan_to_num(0).max())
                         for a, b in zip(zs, want["z"])]}
    if with_faults:
        for name, kw in faults(cfg).items():
            low = reference.products(Z, cfg, **kw)
            out[f"fault.{name}"] = reference.differences(
                (low["hillshade"], low["curvature"], low["mask"]), want, Z,
                cfg)
            del low
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--raster", type=int)
    args = ap.parse_args(argv)
    import torch
    from portbench import harness
    over = ({"config": {"raster": [args.raster] * 2}} if args.raster
            else None)
    for seed in args.seeds:
        t = time.perf_counter()
        cell, cfg, _, dut = harness.prepare(CELL, seed, args.device,
                                            overrides=over)
        reference = cell.reference()
        try:
            rec = {"seed": seed}
            for i in (0, 1):
                rec[f"dem{i}"] = dem_readings(dut, i, cfg, reference, i == 0)
                if torch.device(args.device).type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            dut.close()
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
