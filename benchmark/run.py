"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the run renders the mix's frame
pool from ``--seed`` on the host, builds the program on the card through
the configuration's pipeline (:mod:`benchmark.pipelines`), warms up the
cell's own shapes, then drives the program for ``--seconds`` through the
mix's loop (:mod:`benchmark.loops`), each unit of frames uploaded by the
program's ``cli.upload_frame``. After the window the pipeline checks a
sample of the window's outputs against the configuration's plain
reference (:mod:`benchmark.reference`), and the run prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``breakdown``), and last ``checks``, each number compared beside its limit
(repeated as the last lines of standard error).

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs the
same window with ``torch.profiler`` on over a slice of it and reports the
per-layer metrics. Every metric comes from its reader in
``benchmark/metrics``. Without a card (or with fewer cards than the cell
asks for) the run exits with code 2 and prints no result; so it does if a
JAX module is loaded when the result is due (after the window, the check
and the readers), and if the configuration has a key that is neither the
harness's nor a setting of the pipeline.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "sift_parallel_optimization_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(time.clock_gettime(time.CLOCK_BOOTTIME) - start, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_START = time.perf_counter() - process_age_s()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return code


class Run:
    """What a reader sees of one run: the cell's configuration and mix, the
    metric being read, the window's units (one per frame or batch; host ``perf_counter``
    seconds), the traced slice, the trace, and the traced units' outputs
    on the host (the pipeline's records, a list a unit)."""

    def __init__(self, cell, args, octaves: list[tuple[int, int]] | None):
        self.cfg, self.mix = cell.config, cell.mix
        self.seconds = args.seconds
        self.metric = ""
        self.units: list[dict] = []
        self.t0 = 0.0
        self.setup_s = 0.0
        self.traced: range = range(0)
        self.trace = None
        self.trace_window = (0.0, 0.0)       # trace clock, us
        self.traced_out: dict[int, object] = {}
        self.traced_keypoints: dict[int, list[dict]] = {}
        self.clock_us = 0.0                  # trace clock (us) at perf_counter 0
        self.device_name = ""
        self.octaves = octaves               # (H, W) of each octave, or None

    def frames(self, units) -> int:
        return sum(u["frames"] for u in units)

    def to_trace(self, t: float) -> float:
        """A host ``perf_counter`` time on the trace's clock (us)."""
        return t * 1e6 + self.clock_us

    def traced_units(self) -> list[dict]:
        return [self.units[i] for i in self.traced if i < len(self.units)]


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_to_one_core() -> None:
    """Keep this process, and every thread it starts later, on one fixed
    core of those it may use: the host-bound cells' times otherwise move
    with the core the scheduler picks (on the H100 host, three runs of
    ``kitti_live`` read a p95 of 15.1-19.1 ms unpinned, 16.8-17.6 pinned)."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[max(len(cores) // 2 - 1, 0)]})


def main(argv=None) -> int:
    args = parse(argv)
    pin_to_one_core()
    from benchmark.spec import Cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and does not run on the CPU")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"the cell asks for {cell.chips} cards, {torch.cuda.device_count()} present")
    return run_cell(cell, args, torch.device("cuda", 0))


def run_cell(cell, args, dev, frontend_factory=None) -> int:
    """The run on ``dev``. The control and the tests pass a factory that
    wraps or replaces the program the pipeline builds, and the tests a CPU
    device; the command line does neither."""
    import torch

    from benchmark import frames, spec
    from sift_parallel_optimization_tpu_torch.cli import upload_frame

    cfg, mix = cell.config, cell.mix
    pipeline = cell.module("pipelines", cell.pipeline)
    known = set(spec.HARNESS_KEYS) | pipeline.settings()
    unknown = [k for k in cfg if k not in known]
    if unknown:
        return fail(f"configuration {cfg.get('name')!r}: {', '.join(map(repr, unknown))} is "
                    f"neither a key of the harness (benchmark/spec.py) nor a setting that "
                    f"pipeline {cell.pipeline!r} hands to the program")
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    torch.set_float32_matmul_precision("high" if cfg["tf32"] else "highest")
    torch.set_num_threads(min(4, torch.get_num_threads()))
    t_setup = time.perf_counter()

    batch = int(mix["batch"])
    n_pool = frames.pool_size(cfg["height"], cfg["width"], mix["pool_mb"], batch)
    pool = frames.render_pool(cfg, n_pool, args.seed)
    t_rendered = time.perf_counter()

    forward, octaves = pipeline.build(cell, dev, frontend_factory)
    units_pool = pool.reshape(n_pool // batch, batch, cfg["height"], cfg["width"])
    if batch == 1:
        units_pool = units_pool[:, 0]
    run = Run(cell, args, octaves)
    run.device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def upload(i: int):
        return upload_frame(units_pool[i % len(units_pool)], dev)

    def unit_frames(i: int):
        unit = units_pool[i % len(units_pool)]
        return unit if batch > 1 else [unit]

    # Warm up the cell's own shape: every kernel is built and every buffer
    # allocated before the window.
    for i in range(int(mix["warmup"])):
        forward(upload(i))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    profiler = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        profiler = profile(activities=acts, acc_events=True)
    t_warm = time.perf_counter()

    # Outputs checked against the reference: a sample of the window's units
    # drawn from the seed (reservoir sampling over all units run).
    rng = random.Random(args.seed ^ 0x5EED)
    n_check = max(1, math.ceil(int(mix["check_frames"]) / batch))
    kept: list[tuple[int, object]] = []

    def keep(i: int, out) -> None:
        if len(kept) < n_check:
            kept.append((i, out))
        else:
            j = rng.randrange(i + 1)
            if j < n_check:
                kept[j] = (i, out)

    loop = cell.module("loops", mix["loop"])
    run.t0, run.units = loop.drive(upload, forward, keep, run, dev, args, profiler)
    sync()
    run.setup_s = run.t0 - PROCESS_START
    memory_peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)

    if profiler is not None and len(run.traced):
        from benchmark.trace import Trace

        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            profiler.export_chrome_trace(path)
            run.trace = Trace.load(path)
        finally:
            os.unlink(path)
        _place_trace(run)

    # The window is over: the program's outputs to the host, its state freed,
    # then the reference on the same frames.
    checked = [pair for i, out in kept
               for pair in zip(unit_frames(i), pipeline.to_host(out), strict=True)]
    run.traced_keypoints = {i: pipeline.to_host(out) for i, out in run.traced_out.items()}
    run.traced_out.clear()
    del kept, forward
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ok, rows, failed, checked_info = pipeline.check(cell, checked, dev)
    t_checked = time.perf_counter()

    metrics = {}
    for entry in cell.metrics(bool(args.trace)):
        run.metric = entry["name"]
        value = spec.reader(entry["name"], cell.root).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": run.device_name,
              "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": ok, "attempted": run.frames(run.units), "failed": failed,
              "metrics": metrics, "device": device}
    if run.trace:
        from benchmark import breakdown

        lo, hi = run.trace_window
        device["busy_s"] = run.trace.busy_us(lo, hi) / 1e6
        device["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = breakdown.of(run.trace, lo, hi)
        for name, seconds in result["breakdown"]["device_ops"]:
            print(f"trace device op {seconds:.6f} s  {name}", file=sys.stderr)
        for name, seconds in result["breakdown"]["idle_gaps"]:
            print(f"trace idle gap {seconds:.6f} s  host in {name}", file=sys.stderr)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}

    late = [u["start"] - u["due"] for u in run.units if "due" in u]
    info = {"pool_frames": n_pool, "render_s": t_rendered - t_setup,
            "build_warm_s": t_warm - t_rendered, "setup_s": run.setup_s,
            "check_s": t_checked - run.t0 - args.seconds,
            "generator_late_ms_max": max(late) * 1e3 if late else None,
            "device": run.device_name, **checked_info}
    for k, v in info.items():
        print(f"info {k} {v}", file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    # Last, so that it sees what the window, the pipeline's check, its
    # reference and the readers loaded.
    found = forbidden_modules()
    if found:
        return fail(f"JAX modules loaded in the run: {', '.join(found)}")
    print(json.dumps(result))
    return 0


def _place_trace(run) -> None:
    """Tie the host clock to the trace's through the traced units'
    ``bench.upload`` spans, and set the traced window: from the first
    traced unit's upload to the end of the last traced unit's device work
    or host wait."""
    spans = run.trace.spans_named("bench.upload")
    units = run.traced_units()
    if not spans or not units:
        return
    run.clock_us = spans[0].ts - units[0]["start"] * 1e6
    lo = spans[0].ts
    ends = [s.end for s in run.trace.spans_named("bench.sync")]
    ends += [op.end for op in run.trace.device if op.ts >= lo]
    run.trace_window = (lo, max(ends) if ends else run.to_trace(units[-1]["done"]))


if __name__ == "__main__":
    sys.exit(main())
