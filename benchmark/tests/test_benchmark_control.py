"""The control and the planted faults come out not correct; the program
comes out correct. CPU runs of the harness on the tiny cells."""

from __future__ import annotations

import pytest
import torch

from benchmark.control import ControlFrontend
from benchmark.tests.conftest import run_on_cpu

SEEDS = [5, 2**31 + 9, 4_000_000_007]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["tiny_live", "tiny_offline"])
def test_program_is_correct(tiny_root, capsys, cell, seed):
    out = run_on_cpu(tiny_root, cell, capsys, seed=seed, seconds=0.5)
    assert out["correct"] is True and out["failed"] == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["tiny_live", "tiny_offline"])
def test_tf32_control_is_not_correct(tiny_root, capsys, cell, seed):
    from benchmark.spec import Cell

    cfg = Cell(cell, tiny_root).config
    out = run_on_cpu(tiny_root, cell, capsys, seed=seed, seconds=0.5,
                     frontend_factory=lambda _fe: ControlFrontend(cfg))
    assert out["correct"] is False


def _stale(fe):
    """The previous call's features for every call but the first."""
    last = []

    def forward(x):
        out = fe(x)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return forward


def _half_batch(fe):
    """Half of each batch left out: frames [B/2, B) get frames [0, B/2)'s features."""
    def forward(x):
        out = fe(x)
        h = x.shape[0] // 2
        fix = lambda t: torch.cat([t[:h], t[:t.shape[0] - h]])
        return type(out)(type(out.keypoints)(*map(fix, out.keypoints)), fix(out.descriptors))
    return forward


def _shifted_keypoints(fe):
    """Every frame's answer altered where it is produced: its keypoints'
    columns off by 0.05 px."""
    def forward(x):
        out = fe(x)
        return type(out)(out.keypoints._replace(x=out.keypoints.x + 0.05), out.descriptors)
    return forward


def _altered_descriptors(fe):
    """Every frame's answer altered where it is produced: element 0 of each
    descriptor off by 0.01."""
    def forward(x):
        out = fe(x)
        d = out.descriptors.clone()
        d[..., 0] += 0.01
        return type(out)(out.keypoints, d)
    return forward


FAULTS = [("tiny_live", _stale), ("tiny_offline", _stale), ("tiny_offline", _half_batch),
          ("tiny_live", _shifted_keypoints), ("tiny_offline", _shifted_keypoints),
          ("tiny_live", _altered_descriptors), ("tiny_offline", _altered_descriptors)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda v: getattr(v, "__name__", v))
def test_planted_fault_is_not_correct(tiny_root, capsys, cell, fault):
    out = run_on_cpu(tiny_root, cell, capsys, seed=2**31 + 21, seconds=0.5,
                     frontend_factory=fault)
    assert out["correct"] is False


def test_result_line_keys(tiny_root, capsys):
    out = run_on_cpu(tiny_root, "tiny_live", capsys, seed=3, seconds=0.3)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
