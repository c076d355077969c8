"""The program's ``SiftFrontend``, per frame or on (B, H, W) batches, judged
keypoint by keypoint against a plain reference (:mod:`benchmark.correct`).

Settings, each under the program's own name: a key of :data:`PYRAMID`
(the fields of ``PyramidConfig``) goes to ``PyramidConfig``; one of
:data:`FRONTEND` (``max_keypoints``, ``dual_orientation`` and the detection
thresholds that ``SiftFrontend`` hands to ``detect_pyramid``) goes to
``SiftFrontend``. A setting the program gains is listed here before a
configuration may carry it. The pipeline fixes the rest (:data:`FIXED`),
and ``dtype``, which JSON cannot give: ``length`` min(height, width), ``mode``
SIFT, and ``use_approx_topk``: block-top-2 selection, the program's own
on the card, taken on the CPU too, since the reference selects so. The
reference's ``features(frame, cfg)`` gives the features compared.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import correct

FIXED = ("length", "mode", "use_approx_topk")
# ``PyramidConfig``'s fields, less FIXED and ``dtype`` (a ``torch.dtype``).
PYRAMID = ("S", "sigma0", "assumed_blur", "min_octave_size", "max_octaves", "blur_precision")
# ``SiftFrontend``'s own keywords and the detection thresholds it hands on.
FRONTEND = ("max_keypoints", "dual_orientation", "contrast_threshold", "edge_ratio",
            "refine_iters", "adaptive_hop", "tail_batch_side")


def settings() -> set[str]:
    return set(PYRAMID) | set(FRONTEND)


def build(cell, dev, factory=None):
    from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
    from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend

    cfg = cell.config
    pcfg = PyramidConfig(length=min(cfg["height"], cfg["width"]), mode=ScaleSpaceMode.SIFT,
                         **{k: v for k, v in cfg.items() if k in PYRAMID})
    fe = SiftFrontend(pcfg, cfg["height"], cfg["width"], device=dev, use_approx_topk=True,
                      **{k: v for k, v in cfg.items() if k in FRONTEND})
    return (fe if factory is None else factory(fe)), [tuple(s) for s in fe.pyramid.shapes]


def to_host(out) -> list[dict]:
    """A unit's Features, (K,) or (B, K), as one flat dict of host arrays a
    frame."""
    kp, desc = out.keypoints._asdict(), out.descriptors
    if desc.dim() != 3:
        return [correct.as_numpy(dict(kp, desc=desc))]
    return [correct.as_numpy(dict({f: v[j] for f, v in kp.items()}, desc=desc[j]))
            for j in range(desc.shape[0])]


def check(cell, pairs, dev):
    cfg = cell.config
    reference = cell.module("reference", cell.reference)
    stats, kp_counts = [], []
    for frame, prog in pairs:
        img = torch.from_numpy(np.ascontiguousarray(frame)).to(dev)
        stats.append(correct.frame_stats(prog, correct.as_numpy(reference.features(img, cfg)),
                                         cfg))
        kp_counts.append(int(prog["valid"][:cfg["max_keypoints"]].sum()))
    ok, rows = correct.verdict(correct.numbers(stats), cfg["limits"], stats)
    # A checked frame fails when its answer is missing: no valid keypoint
    # from the program where the reference finds some.
    failed = sum(1 for s in stats if s["valid"] == 0 and s["valid_ref"] > 0)
    info = {"frames_checked": len(pairs),
            "keypoints_per_frame": sum(kp_counts) / max(len(kp_counts), 1)}
    info.update({f"widest_{k}": v for k, v in correct.widest(stats).items()})
    return ok, rows, failed, info
