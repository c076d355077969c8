"""A deployment is files: a configuration names its pipeline and its
reference, a mix names its loop, and the frontend takes its settings under
the program's own names."""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run, spec
from benchmark.spec import Cell
from benchmark.tests.conftest import ROOT, run_on_cpu

from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
from sift_parallel_optimization_tpu_torch.models import detect
from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend

TOY_PIPELINE = '''"""Each frame's mean brightness times the configuration's ``gain``."""


def settings():
    return {"gain"}


def build(cell, dev, factory=None):
    gain = float(cell.config["gain"])

    def forward(x):
        return x.double().mean(dim=(-2, -1)) * gain
    return (forward if factory is None else factory(forward)), None


def to_host(out):
    return [{"mean": float(v)} for v in out.reshape(-1).cpu()]


def check(cell, pairs, dev):
    reference = cell.module("reference", cell.reference)
    gap = max(abs(rec["mean"] - reference.features(frame, cell.config)) for frame, rec in pairs)
    limit = cell.config["limits"]["mean_gap"]
    return gap <= limit, [("mean_gap", gap, limit)], 0, {"frames_checked": len(pairs)}
'''

TOY_REFERENCE = '''"""A frame's mean brightness times ``gain``, in NumPy."""

import numpy as np


def features(frame, cfg):
    return float(np.asarray(frame, np.float64).mean() * cfg["gain"])
'''

TOY_LOOP = '''"""Every unit once, back to back, each due as the last one completes."""

import time


def drive(upload, forward, keep, run, dev, args, profiler):
    units = []
    t0 = time.perf_counter()
    for i in range(int(run.mix["units"])):
        start = time.perf_counter()
        out = forward(upload(i))
        done = time.perf_counter()
        keep(i, out)
        units.append({"due": start, "start": start, "returned": done, "done": done,
                      "frames": run.mix["batch"]})
    return t0, units
'''


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add_toy_deployment(root):
    """The toy deployment, as new files and appended entries only."""
    tiny = json.loads((root / "benchmark" / "configs" / "tiny.json").read_text())
    cfg = {k: v for k, v in tiny.items() if k in spec.HARNESS_KEYS}
    cfg.update(name="toy", pipeline="toy", reference="toy_mean", gain=2.5,
               limits={"mean_gap": 1e-9})
    bench = root / "benchmark"
    (bench / "configs" / "toy.json").write_text(json.dumps(cfg))
    (bench / "pipelines" / "toy.py").write_text(TOY_PIPELINE)
    (bench / "reference" / "toy_mean.py").write_text(TOY_REFERENCE)
    (bench / "loops" / "toy_steps.py").write_text(TOY_LOOP)
    (bench / "mixes" / "steps.json").write_text(json.dumps(
        {"loop": "toy_steps", "batch": 2, "pool_mb": 0.5, "warmup": 1, "check_frames": 4,
         "units": 5}))
    entries = json.loads((root / "BENCHMARK.json").read_text())
    entries["configs"].append({"name": "toy", "source": "tests",
                               "file": "benchmark/configs/toy.json", "reduced": [],
                               "why": "tests"})
    entries["workloads"].append({"name": "toy.steps", "config": "toy", "traffic": "steps",
                                 "chips": 1, "why": "tests"})
    for m in entries["end_to_end"]:
        if m["name"] == "frame_ms_p95":
            m["workloads"].append("toy.steps")
    (root / "BENCHMARK.json").write_text(json.dumps(entries))


def test_new_deployment_from_files_and_entries_only(tiny_root, capsys):
    before = _files(tiny_root)
    _add_toy_deployment(tiny_root)
    out = run_on_cpu(tiny_root, "toy.steps", capsys)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == 10
    assert set(out["metrics"]) == {"frame_ms_p95", "setup_s"}
    assert list(out["checks"]) == ["mean_gap"] and list(out)[-1] == "checks"
    after = _files(tiny_root)
    assert {p: after[p] for p in before} == before
    for name in ("run.py", "spec.py", "correct.py", "loops/camera.py", "loops/batches.py"):
        assert before[Path("benchmark", name)] == (ROOT / "benchmark" / name).read_bytes()


def test_new_deployment_is_judged_by_its_reference(tiny_root, capsys):
    _add_toy_deployment(tiny_root)
    off = lambda forward: (lambda x: forward(x) + 1e-6)
    out = run_on_cpu(tiny_root, "toy.steps", capsys, frontend_factory=off)
    assert out["correct"] is False


@pytest.mark.parametrize("name", ["jax", "flax"])
def test_reference_that_loads_jax_gets_no_result(tiny_root, tmp_path, capsys, monkeypatch, name):
    """A module of JAX's that only the reference loads, after the window,
    still ends the run with no result."""
    stub = tmp_path / "stubs"
    (stub / name).mkdir(parents=True)
    (stub / name / "__init__.py").write_text('"""A stand-in of the real package."""\n')
    monkeypatch.syspath_prepend(str(stub))
    _add_toy_deployment(tiny_root)
    ref = tiny_root / "benchmark" / "reference" / "toy_mean.py"
    ref.write_text(ref.read_text().replace("import numpy as np", f"import numpy as np\nimport {name}"))
    args = argparse.Namespace(workload="toy.steps", seed=7, seconds=0.3, trace=0)
    capsys.readouterr()
    assert name not in sys.modules
    try:
        rc = run.run_cell(Cell("toy.steps", tiny_root), args, torch.device("cpu"))
        loaded = sys.modules.get(name)
    finally:
        sys.modules.pop(name, None)
    out, err = capsys.readouterr()
    assert loaded is not None and loaded.__file__.startswith(str(stub))
    assert rc == 2 and out == ""
    assert f"JAX modules loaded in the run: {name}" in err


def _old_frontend(cfg: dict) -> SiftFrontend:
    """The harness's mapping before configurations named the program's
    settings: eleven keys, spelt out."""
    pcfg = PyramidConfig(length=min(cfg["height"], cfg["width"]), S=cfg["S"],
                         mode=ScaleSpaceMode.SIFT, sigma0=cfg["sigma0"],
                         assumed_blur=cfg["assumed_blur"],
                         min_octave_size=cfg["min_octave_size"],
                         blur_precision=cfg["blur_precision"])
    return SiftFrontend(pcfg, cfg["height"], cfg["width"], max_keypoints=cfg["max_keypoints"],
                        dual_orientation=cfg["dual_orientation"], device=torch.device("cpu"),
                        contrast_threshold=cfg["contrast_threshold"],
                        edge_ratio=cfg["edge_ratio"], use_approx_topk=True)


@pytest.mark.parametrize("cell", ["kitti_live", "tum_offline"])
def test_configurations_build_the_frontend_they_built_before(cell):
    c = Cell(cell)
    fe, octaves = c.module("pipelines", "frontend").build(c, torch.device("cpu"))
    old = _old_frontend(c.config)
    assert fe.cfg == old.cfg
    assert (fe.max_keypoints, fe.dual_orientation, fe.device, fe.thresholds) == (
        old.max_keypoints, old.dual_orientation, old.device, old.thresholds)
    assert octaves == [tuple(s) for s in old.pyramid.shapes]
    new_state, old_state = fe.state_dict(), old.state_dict()
    assert list(new_state) == list(old_state)
    assert all(torch.equal(new_state[k], old_state[k]) for k in old_state)


def test_frontend_settings_are_the_programs_own():
    """Every setting the frontend pipeline accepts names a field of
    ``PyramidConfig`` or a keyword that ``SiftFrontend`` takes or hands to
    detection, and every such field and ``SiftFrontend`` keyword is either
    accepted or fixed by the pipeline."""
    frontend = Cell("kitti_live").module("pipelines", "frontend")
    fields = {f.name for f in dataclasses.fields(PyramidConfig)}
    keywords = lambda fn: set(inspect.signature(fn).parameters)
    own = keywords(SiftFrontend.__init__) - {"self", "cfg", "height", "width", "device",
                                             "thresholds"}
    handed_on = keywords(detect.detect_pyramid) | keywords(detect.detect_octave_groups_batched)
    assert set(frontend.PYRAMID) <= fields
    assert fields - set(frontend.PYRAMID) == {"dtype"} | (fields & set(frontend.FIXED))
    assert set(frontend.FRONTEND) <= own | handed_on
    assert own <= set(frontend.FRONTEND) | set(frontend.FIXED)
    assert frontend.settings() == set(frontend.PYRAMID) | set(frontend.FRONTEND)


def _with_key(root, key, value):
    path = root / "benchmark" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    cfg[key] = value
    path.write_text(json.dumps(cfg))


@pytest.mark.parametrize("key,value", [("max_keypiont", 64), ("length", 96), ("device", "cpu")])
def test_unknown_configuration_key_ends_the_run(tiny_root, capsys, key, value):
    _with_key(tiny_root, key, value)
    args = argparse.Namespace(workload="tiny_live", seed=7, seconds=0.3, trace=0)
    capsys.readouterr()
    rc = run.run_cell(Cell("tiny_live", tiny_root), args, torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc == 2 and out == ""
    assert repr(key) in err


@pytest.mark.parametrize("key,value,seen", [
    ("max_octaves", 2, lambda fe: (fe.cfg.max_octaves, len(fe.pyramid.shapes)) == (2, 2)),
    ("refine_iters", 2, lambda fe: fe.thresholds["refine_iters"] == 2),
    ("adaptive_hop", True, lambda fe: fe.thresholds["adaptive_hop"] is True),
])
def test_program_setting_reaches_the_frontend(tiny_root, capsys, key, value, seen):
    _with_key(tiny_root, key, value)
    built = []
    run_on_cpu(tiny_root, "tiny_live", capsys, seconds=0.3,
               frontend_factory=lambda fe: built.append(fe) or fe)
    assert len(built) == 1 and seen(built[0])
