"""The plain reference against the program on small frames, and what a
run and the reference load."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import correct, frames
from benchmark.reference import sift as reference
from benchmark.tests.conftest import ROOT, tiny_config

from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend


def program_features(cfg: dict, frame: np.ndarray) -> dict:
    pcfg = PyramidConfig(length=min(cfg["height"], cfg["width"]), S=cfg["S"],
                         mode=ScaleSpaceMode.SIFT, sigma0=cfg["sigma0"],
                         assumed_blur=cfg["assumed_blur"],
                         min_octave_size=cfg["min_octave_size"])
    fe = SiftFrontend(pcfg, cfg["height"], cfg["width"], max_keypoints=cfg["max_keypoints"],
                      dual_orientation=cfg["dual_orientation"], device="cpu",
                      contrast_threshold=cfg["contrast_threshold"],
                      edge_ratio=cfg["edge_ratio"], use_approx_topk=True)
    out = fe(torch.from_numpy(frame))
    return correct.as_numpy(dict(out.keypoints._asdict(), desc=out.descriptors))


@pytest.mark.parametrize("height,width", [(96, 160), (120, 160)])
@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_reference_agrees_with_the_program(height, width, seed):
    cfg = dict(tiny_config(), height=height, width=width)
    pool = frames.render_pool(cfg, 2, seed)
    stats = []
    for frame in pool:
        prog = program_features(cfg, frame)
        ref = correct.as_numpy(reference.features(torch.from_numpy(frame), cfg))
        stats.append(correct.frame_stats(prog, ref, cfg))
    assert min(s["valid"] for s in stats) >= 10
    ok, rows = correct.verdict(correct.numbers(stats), cfg["limits"], stats)
    assert ok, rows


def test_reference_selects_by_block_top2_keys():
    """Three candidates in one 64-voxel run of a large octave: the third
    is dropped by the run's top two, as the program's tables drop it."""
    key = torch.zeros((3, 40, 40), dtype=torch.int64)
    score = torch.zeros((3, 40, 40), dtype=torch.float64)
    for x, v in ((3, 0.5), (9, 0.7), (20, 0.6)):
        score[0, 0, x] = v
        key[0, 0, x] = int(np.float32(v).view(np.int32)) & ~31 | 13
    keys, idx = reference._octave_entries({"key": key, "score": score}, 10)
    nblk = -(-key.numel() // 64)
    assert keys.shape[0] == 2 * nblk
    assert set(idx[keys > 0].tolist()) == {9, 20}


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


TOPS = "import sys, json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
JAX = {"jax", "jaxlib", "flax", "sift_parallel_optimization_tpu"}


def test_reference_loads_nothing_of_jax_or_the_program():
    tops = _loaded_after("import benchmark.reference.sift, benchmark.correct\n" + TOPS)
    assert not tops & (JAX | {"sift_parallel_optimization_tpu_torch"})


def test_a_run_loads_no_jax():
    code = f"""
import argparse, io, contextlib, sys, tempfile, pathlib, torch
sys.path.insert(0, {str(ROOT)!r})
from benchmark.tests.conftest import make_root
from benchmark import run
from benchmark.spec import Cell
root = make_root(pathlib.Path(tempfile.mkdtemp()))
for name in ("tiny_live", "tiny_offline"):
    args = argparse.Namespace(workload=name, seed=11, seconds=0.5, trace=1)
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert run.run_cell(Cell(name, root), args, torch.device("cpu")) == 0
""" + TOPS
    tops = _loaded_after(code)
    assert "sift_parallel_optimization_tpu_torch" in tops and "benchmark" in tops
    assert not tops & JAX
