"""Batched frontend: B frames in, Features with a leading (B,) axis out (port
of ``parallel/frontend.py``, single device).

The port folds the frames into every launch: the pyramid's Toeplitz products
broadcast over a leading frame axis, the block-reduce kernel scores every
octave of every frame in one launch, selection sorts run along the last axis
of (B, n) tables, one batched gather copies all B * K patches, and the
per-keypoint orientation and descriptor steps run on the folded (B * K, ...)
axis. The JAX package batches only the pyramid and unrolls detection and
description per frame, because XLA's relayout copies at the batched stage
boundaries cost more there than the batching saved. An eager PyTorch
program has no such boundaries and pays per launch instead: the per-frame
frontend is host-bound on the card, and a batch makes about as many
launches as one frame does, whatever B is. Measured by ``chip_smoke.py`` on
an NVIDIA H100 80GB HBM3 (700 W limit) at 512^2, K=512: one frame is 536
device ops, a batch of 8 is 555 (69 per frame), with one launch of the
gather kernel and one of the score-table kernel per batch; PERF.md has the
times per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from sift_parallel_optimization_tpu_torch.config import PyramidConfig
from sift_parallel_optimization_tpu_torch.models.frontend import Features, SiftFrontend
from sift_parallel_optimization_tpu_torch.utils.device import resolve_device


def batched_extract_features(
    imgs: torch.Tensor | np.ndarray,
    cfg: PyramidConfig,
    max_keypoints: int = 512,
    dual_orientation: bool = False,
    device=None,
    **thresholds,
) -> Features:
    """(B, H, W) frames in [0, 1] -> Features with a leading (B,) axis, equal
    per frame to :class:`SiftFrontend` on that frame (up to the batched
    matrix products' summation order).

    Runs on ``device``; None follows ``imgs`` when it is a tensor and means
    the card for a numpy array. ``thresholds`` go to
    ``models.detect.detect_pyramid_batched``. Hold a :class:`SiftFrontend`
    and call it on (B, H, W) to reuse its matrices across batches. The
    ``mesh`` argument of the JAX function (frames sharded over devices) is
    not ported yet: it belongs with ``parallel/`` on ``torch.distributed``.
    """
    device = resolve_device(device, imgs)
    imgs = torch.as_tensor(imgs).to(device)
    if imgs.dim() != 3:
        raise ValueError(f"expected (B, H, W) frames, got {tuple(imgs.shape)}")
    fe = SiftFrontend(cfg, imgs.shape[1], imgs.shape[2], max_keypoints=max_keypoints,
                      dual_orientation=dual_orientation, device=device, **thresholds)
    return fe(imgs)
