"""Shared fixtures of the benchmark's CPU tests.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A small configuration of the TUM shape's kind: 120 x 160 frames, a scene
# dense enough for some tens of keypoints a frame.
TINY = {"name": "tiny", "height": 120, "width": 160, "max_keypoints": 64,
        "camera": {"fx": 130.0, "fy": 130.0, "cx": 80.0, "cy": 60.0}}
TINY_SCENE = {"blobs": 1500, "z_near": 1.5, "wsig_min": 0.02, "wsig_span": 0.05}


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / "tum_rgbd.json").read_text())
    cfg.update(TINY)
    cfg["scene"].update(TINY_SCENE)
    return cfg


def make_root(tmp: Path) -> Path:
    """A checkout-like root in ``tmp``: ``BENCHMARK.json`` and a copy of
    ``benchmark/``, plus the tiny configuration and its cells ``tiny_live``
    and ``tiny_offline`` (registered for every metric their mix's cells
    report), the mixes' pools cut to 7 frames (live) and 3 batches
    (offline), two units of warm-up (so that a stale answer is wrong from
    the window's first unit on, however few units a loaded host runs) and
    their traced slices moved to the first units."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    bench["configs"].append({"name": "tiny", "source": "benchmark tests",
                             "file": "benchmark/configs/tiny.json", "reduced": [],
                             "why": "tests"})
    for mix in ("live", "offline"):
        name = f"tiny_{mix}"
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": mix,
                                   "chips": 1, "why": "tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.endswith(mix) for w in m["workloads"]):
                m["workloads"].append(name)
        path = tmp / "benchmark" / "mixes" / f"{mix}.json"
        spec = json.loads(path.read_text())
        spec.update(pool_mb=0.5 if mix == "live" else 2.0, warmup=2, trace_from=1)
        path.write_text(json.dumps(spec))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def run_on_cpu(root: Path, workload: str, capsys, seed: int = 2**31 + 5, seconds: float = 1.0,
               trace: int = 0, frontend_factory=None) -> dict:
    """One CPU run of a cell of ``root`` through the harness (its look for
    a card skipped); returns the result line."""
    import torch

    from benchmark import run
    from benchmark.spec import Cell

    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    capsys.readouterr()
    rc = run.run_cell(Cell(workload, root), args, torch.device("cpu"),
                      frontend_factory=frontend_factory)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])
