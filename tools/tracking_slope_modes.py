"""Spread of ``cli bench``'s tracking slope on the card.

    python3 tools/tracking_slope_modes.py        # on the card

Runs ``bench/suite.bench_tracking`` at 256^2 three times, each building and
capturing its steady steps anew, and measures every step's slope four times
on the same captured graph (``bench/suite._replay_slope``: the same carry
and generator state for every run), without and with loop closure. Each
slope comes with the SM clock nvidia-smi sampled while it ran (``sm_mhz``)
and the device time of a replayed frame with its costliest kernels, from
the records ``utils/profiling.profile_device`` counts. After each slope,
16 more replays from the same carry, not synchronized between frames: the
host's ms a frame to launch them (``host_ms``; 16 frames do not fill the
launch queue, so the host never waits on the card there) beside their wall
ms a frame to the end of the last (``wall_ms``); then the carry and the
generator go back to where the probe began. One JSON line a step, then
the two records each run wrote.
"""

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sift_parallel_optimization_tpu_torch.bench import suite  # noqa: E402
from sift_parallel_optimization_tpu_torch.models.odometry import _clone, _tensors  # noqa: E402

RECORDS = []
SLOPE = suite._replay_slope


class _Writer:
    def write(self, metric, value, unit, **kw):
        RECORDS.append((metric, value, kw.get("sm_mhz"), kw.get("device_ms")))


def slopes_with_clocks(runner, i, do_loop, gen, **kw):
    runs = []
    for _ in range(4):
        ms, fields = SLOPE(runner, i, do_loop, gen, **kw)
        start, draws = _clone(runner.carry), gen.get_state()
        torch.cuda.synchronize()
        host, t0 = 0.0, time.perf_counter()
        for _ in range(16):
            t = time.perf_counter()
            runner.run(i, True, do_loop, generator=gen)
            host += time.perf_counter() - t
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for dst, src in zip(_tensors(runner.carry), _tensors(start)):
            dst.copy_(src)
        gen.set_state(draws)
        runs.append({"ms": round(ms, 3), "sm_mhz": fields["sm_mhz"],
                     "device_ms": fields["device_ms"], "host_ms": round(host / 16 * 1e3, 3),
                     "wall_ms": round(wall / 16 * 1e3, 3)})
    print(json.dumps({"do_loop": do_loop, "runs": runs, "top": fields["device_top"]}),
          flush=True)
    return ms, fields


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    suite._replay_slope = slopes_with_clocks
    for _ in range(3):
        suite.bench_tracking(_Writer(), size=256)
        print(json.dumps(RECORDS[-2:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
