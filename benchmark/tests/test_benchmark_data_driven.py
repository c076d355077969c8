"""A cell, configuration, mix and metric come from files and entries alone,
and the command refuses to time anything without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark.spec import Cell
from benchmark.tests.conftest import ROOT, run_on_cpu, tiny_config

READER = '''"""``units_seen.<split>``: units run in the window (a test metric)."""


def read(run):
    return float(len(run.units))
'''


def test_new_cell_from_files_and_entries_only(tiny_root, capsys):
    cfg = dict(tiny_config(), name="tiny_wide", height=72, width=200, camera_hz=15,
               camera={"fx": 120.0, "fy": 120.0, "cx": 100.0, "cy": 36.0})
    (tiny_root / "benchmark" / "configs" / "tiny_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny_root / "benchmark" / "mixes" / "live.json").read_text())
    mix.update(check_frames=4, trace_from=0, trace_units=3)
    (tiny_root / "benchmark" / "mixes" / "live_short.json").write_text(json.dumps(mix))
    (tiny_root / "benchmark" / "metrics" / "units_seen.py").write_text(READER)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_wide", "source": "tests",
                             "file": "benchmark/configs/tiny_wide.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": "tiny_wide.live_short", "config": "tiny_wide",
                               "traffic": "live_short", "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "units_seen.live", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "serving loop",
                               "moves": "frame_ms_p95", "workloads": ["tiny_wide.live_short"]})
    for m in bench["end_to_end"]:
        if m["name"] == "frame_ms_p95":
            m["workloads"].append("tiny_wide.live_short")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = Cell("tiny_wide.live_short", tiny_root)
    assert (cell.config["width"], cell.mix["check_frames"]) == (200, 4)
    assert [m["name"] for m in cell.metrics(True)] == ["units_seen.live"]
    traced = run_on_cpu(tiny_root, "tiny_wide.live_short", capsys, seconds=0.4, trace=1)
    assert traced["metrics"]["units_seen.live"] == {"value": 6.0, "unit": "units"}
    timed = run_on_cpu(tiny_root, "tiny_wide.live_short", capsys, seconds=0.4)
    assert set(timed["metrics"]) == {"frame_ms_p95", "setup_s"}
    assert list(timed)[-1] == "checks"


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "kitti_live",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
