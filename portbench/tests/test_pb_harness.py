"""A run of every cell on the CPU at a small size: correct, and the
control and each fault a cell can have come out not correct; a
configuration, traffic mix and metric added as new files only; run.py's
refusals."""

import hashlib
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import control, harness

from .conftest import ROOT, small

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(cell, tracing=False, seconds=0.3, **kw):
    return harness.run_cell(cell, 2 ** 33 + 1, seconds, tracing, "cpu", 0.0,
                            overrides=small(cell), log=lambda *a, **k: None,
                            **kw)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("tracing", [False, True])
def test_cell_runs_correct_on_the_cpu(cell, tracing):
    out = run(cell, tracing)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    names = set(out["metrics"])
    if tracing:
        assert any(n.startswith("device.idle_pct") for n in names)
        assert out["device"]["window_s"] > 0
    else:
        cell_ = harness.CellSpec(cell)
        assert names == {m["name"] for m in cell_.metrics("end_to_end")}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = control.readings(cell, 7, 0.3, "cpu", small(cell))
    assert all(v <= r["limits"][k] for k, v in r["program"].items())
    assert any(v > r["limits"][k] for k, v in r["control"].items())


def _geomorphons_fault(kind):
    import neilpy_tpu_torch as ntt
    real = ntt.geomorphons
    state = {}

    def broken(Z, **kw):
        G = real(Z, **kw)
        if kind == "altered":
            G = G.clone()
            G[G.shape[0] // 2, 5] = G[G.shape[0] // 2, 5] % 10 + 1
        elif kind == "half":
            G = G.clone()
            G[G.shape[0] // 2:] = 0
        elif kind == "unchanged":
            # the first output returned again, the call doing nothing new
            G = state.setdefault("G", G)
        return G
    return broken


@pytest.mark.parametrize("kind", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("cell", ["geomorphons_l50.resident",
                                  "geomorphons_l50.host"])
def test_geomorphons_faults_are_not_correct(monkeypatch, cell, kind):
    import neilpy_tpu_torch as ntt
    monkeypatch.setattr(ntt, "geomorphons", _geomorphons_fault(kind))
    out = run(cell)
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("kind", ["altered", "half", "unchanged"])
def test_mosaic_faults_are_not_correct(monkeypatch, tmp_path, kind):
    import neilpy_tpu_torch as ntt
    from neilpy_tpu_torch.pipelines import mosaic
    if kind == "altered":
        real = mosaic.classes_from_counts

        def altered(num_pos, num_neg):
            G = real(num_pos, num_neg)
            G[60, 60] = G[60, 60] % 10 + 1
            return G
        monkeypatch.setattr(mosaic, "classes_from_counts", altered)
    elif kind == "half":
        # half of the tiles marked done: never computed nor stored
        real = mosaic.tiled_apply
        ck = tmp_path / "half.json"

        def half(*a, **kw):
            ck.write_text(json.dumps([[0, 0], [0, 1], [1, 0], [1, 1]]))
            return real(*a, **{**kw, "checkpoint": str(ck)})
        monkeypatch.setattr(mosaic, "tiled_apply", half)
    else:
        monkeypatch.setattr(ntt, "mosaic_terrain_products",
                            lambda Z, out=None, **kw: out)
    out = run("mosaic_trio.stream16k")
    assert not out["correct"]
    # a skipped or idle call leaves every job's poisoned samples unwritten
    assert kind == "altered" or out["failed"] >= 1


def _digest(tree):
    return {p.relative_to(tree): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


TOY_SYSTEM = '''
import numpy as np
import torch


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        self.pixels_per_job = cfg["n"]
        self.x = torch.arange(cfg["n"], dtype=torch.float64) + seed % 7
        self.out = None

    def warm(self, span):
        pass

    def job(self, k, span):
        with span("call"):
            self.out = self.x * 2

    def work(self):
        return None

    def counters(self):
        return {"jobs_seen": 1.0}

    def judge(self, reference, limits):
        return {"max_err": float((self.out - reference.double(self.x))
                                 .abs().max())}, 0

    def close(self):
        pass
'''


def test_a_config_traffic_and_metric_need_only_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    (pb / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "n": 1000, "limits": {"max_err": 0.0},
         "reduced_from": {}}))
    (pb / "systems" / "toy.py").write_text(TOY_SYSTEM)
    (pb / "reference" / "toy.py").write_text(
        "def double(x):\n    return x + x\n")
    (pb / "traffic" / "toy_mix.json").write_text("{}")
    (pb / "metrics" / "toy.jobs_seen.py").write_text(
        "def read(run):\n    return run.counters.get('jobs_seen')\n")
    man["configs"].append({"name": "toy", "source": "a test",
                           "file": "portbench/configs/toy.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "toy.toy_mix", "config": "toy",
                             "traffic": "toy_mix", "chips": 1,
                             "why": "a test"})
    man["end_to_end"][0].setdefault("workloads", [])
    man["per_layer"].append({"name": "toy.jobs_seen", "unit": "jobs",
                             "better": "higher", "source": "program_counter",
                             "layer": "toy", "moves": "setup_s",
                             "workloads": ["toy.toy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digest(pb)
    assert all(after[k] == v for k, v in before.items())
    for tracing, metric in ((False, "setup_s"), (True, "toy.jobs_seen")):
        out = harness.run_cell("toy.toy_mix", 3, 0.1, tracing, "cpu", 0.0,
                               manifest=tmp_path / "BENCHMARK.json",
                               base=pb, log=lambda *a, **k: None)
        assert out["correct"] and metric in out["metrics"]


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "geomorphons_l50.resident", "--seed", "1", "--seconds", "1"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and "correct" not in res.stdout
    # a directory with only BENCHMARK.json and portbench/: no port
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and "correct" not in res.stdout


def test_a_cpu_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness; "
            "from portbench.tests.conftest import small; "
            "c = 'mosaic_trio.stream16k'; "
            "harness.run_cell(c, 5, 0.2, False, 'cpu', 0.0, "
            "overrides=small(c), log=lambda *a, **k: None); "
            "print(harness.banned_modules())" % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_mosaic_writes_its_dem_under_tmpdir_and_removes_it(
        monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    run("mosaic_trio.stream16k")
    assert list(tmp_path.iterdir()) == []
    np.testing.assert_equal(tempfile.gettempdir(), str(tmp_path))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card_at_a_small_size(cuda_device, cell):
    out = harness.run_cell(cell, 2 ** 33 + 3, 0.5, True, cuda_device, 0.0,
                           overrides=small(cell), log=lambda *a, **k: None)
    assert out["correct"] and out["device"]["busy_s"] > 0
