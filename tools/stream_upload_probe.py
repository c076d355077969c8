"""Host time of a frame's way to the card, alone and beside the ring loader.

    python3 tools/stream_upload_probe.py        # on the card

For 256^2 and 512^2 frames: the median and least host ms of a numpy copy,
``pin_memory()``, ``cli.upload_frame`` (pinned, non-blocking), a pageable
``.to("cuda")``, a copy into a preallocated pinned buffer, the host
library's ``FrameLoader.next_frame`` in a tight loop (the loader's own rate),
and ``next_frame`` followed by an upload: the serving loop's two host steps
with the loader's worker threads running beside them; the upload once as
``upload_frame`` (a one-thread numpy copy into pinned memory), once through
``pin_memory()`` (a copy by the intra-op thread pool), and once more through
``pin_memory()`` with the pool cut to one thread. Then ``cli stream``'s loop
(``cli.serve_stream``) with each upload in turns, ``pin_memory()`` first and
last: (a) 200 frames of 512^2, frontend only, four runs; (c) 200 frames of
512^2, W=8, loop closure, two runs.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sift_parallel_optimization_tpu_torch import cli  # noqa: E402
from sift_parallel_optimization_tpu_torch.cli import upload_frame  # noqa: E402
from sift_parallel_optimization_tpu_torch.utils import native  # noqa: E402


def timed(label, fn, n=50):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    print(f"  {label}: median {1e3 * np.median(ts):.3f} ms, least {1e3 * min(ts):.3f} ms")


def pool_upload(frame, dev):
    """The upload through ``pin_memory()`` (a copy by the intra-op pool)."""
    return torch.from_numpy(frame).pin_memory().to(dev, non_blocking=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for size in (256, 512):
        a = native.synth_frame(size, 0)
        pinned = torch.empty((size, size), dtype=torch.float32, pin_memory=True)
        print(f"{size}^2 ({torch.cuda.get_device_name(0)})")
        timed("numpy copy", lambda: a.copy())
        timed("pin_memory", lambda: torch.from_numpy(a).pin_memory())
        timed("upload_frame", lambda: upload_frame(a, dev))
        timed("pageable to", lambda: torch.from_numpy(a).to(dev))
        timed("preallocated pinned copy + to", lambda: pinned.copy_(torch.from_numpy(a)).to(
            dev, non_blocking=True))
        with native.FrameLoader(size, n_buffers=4, n_threads=2) as ld:
            timed("next_frame", ld.next_frame)
            timed("next_frame + upload_frame", lambda: upload_frame(ld.next_frame()[1], dev))
            timed("next_frame + pin_memory + to", lambda: pool_upload(ld.next_frame()[1], dev))
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                timed(f"next_frame + pin_memory + to, 1 intra-op thread (of {threads})",
                      lambda: pool_upload(ld.next_frame()[1], dev))
            finally:
                torch.set_num_threads(threads)
    runs = [("a", 0, False)] * 4 + [("c", 8, True)] * 2
    for k, (name, window, loops) in enumerate(runs):
        pool = k % 4 in (0, 3) if name == "a" else k % 2 == 0
        cli.upload_frame = pool_upload if pool else upload_frame
        try:
            res = cli.serve_stream(200, 512, 512, 0, window, loops, dev)
        finally:
            cli.upload_frame = upload_frame
        print(f"serve ({name}) 512^2{f' W={window}' if window else ''}, upload through "
              f"{'pin_memory()' if pool else 'a numpy copy'}: "
              f"{res['seconds'] * 1e3 / res['frames']:.3f} ms/frame end to end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
