"""The SIFT frontend: grayscale frame -> keypoints + descriptors (port of
``models/frontend.py``).

SIFT Gaussian pyramid (``core/pyramid_ref.SiftPyramid``) -> DoG ->
detection (``models/detect``) -> orientation and 128-d descriptors
(``models/descriptor``, through the patch-gather kernel on the card). A
(B, H, W) batch of frames goes through the same three stages with the frames
folded into every launch (``parallel/frontend`` is its functional entry
point) and comes back with a leading (B,) axis on every field.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
from sift_parallel_optimization_tpu_torch.core.pyramid_ref import SiftPyramid, dog_planes
from sift_parallel_optimization_tpu_torch.models.descriptor import (
    max_patch_radius,
    orient_and_describe,
)
from sift_parallel_optimization_tpu_torch.models.detect import (
    detect_pyramid,
    detect_pyramid_batched,
)
from sift_parallel_optimization_tpu_torch.models.keypoints import (
    Keypoints,
    keypoints_from_numpy,
)
from sift_parallel_optimization_tpu_torch.utils.convert import field, tensor_from_numpy
from sift_parallel_optimization_tpu_torch.utils.device import resolve_device
from sift_parallel_optimization_tpu_torch.utils.profiling import setup_span, span, stage_span


class Features(NamedTuple):
    keypoints: Keypoints
    descriptors: torch.Tensor  # (K, 128) f32, zero in invalid slots


def features_from_numpy(arrays, device=None) -> Features:
    """Features from numpy arrays, field for field: a mapping or named tuple
    with ``keypoints`` (itself a mapping or named tuple of the Keypoints
    fields) and ``descriptors``, e.g. the JAX frontend's output after
    ``np.asarray``. Any leading batch axis is kept. ``device`` None means the
    card, and raises without one."""
    device = resolve_device(device)
    kp = field(arrays, "keypoints")
    return Features(
        keypoints=keypoints_from_numpy({f: field(kp, f) for f in Keypoints._fields}, device),
        descriptors=tensor_from_numpy(field(arrays, "descriptors"), torch.float32, device),
    )


def features_to_numpy(feats: Features) -> dict:
    """The inverse of :func:`features_from_numpy`: nested dicts of numpy arrays."""
    return {
        "keypoints": {f: v.cpu().numpy() for f, v in feats.keypoints._asdict().items()},
        "descriptors": feats.descriptors.cpu().numpy(),
    }


def sift_config(length: int, S: int = 3, **kw) -> PyramidConfig:
    return PyramidConfig(length=length, S=S, mode=ScaleSpaceMode.SIFT, **kw)


class SiftFrontend(nn.Module):
    """Frontend for (height, width) frames on one device (None means the
    card, and raises without one).

    Holds the configuration, the pyramid's blur matrices (buffers of the
    ``pyramid`` submodule), the device and the keypoint capacity.
    ``dual_orientation`` doubles the output capacity with Lowe's 80%-rule
    secondary orientations in slots [K:2K).
    """

    def __init__(
        self,
        cfg: PyramidConfig,
        height: int | None = None,
        width: int | None = None,
        max_keypoints: int = 512,
        dual_orientation: bool = False,
        device=None,
        **thresholds,
    ):
        with setup_span("sift.setup.frontend"):
            super().__init__()
            height = cfg.length if height is None else height
            self.cfg = cfg
            self.device = resolve_device(device)
            self.max_keypoints = max_keypoints
            self.dual_orientation = dual_orientation
            self.thresholds = thresholds
            self.pyramid = SiftPyramid(cfg, height, width, device=self.device)
            self._first_forward = True

    @torch.no_grad()
    def forward(self, img: torch.Tensor) -> Features:
        """(H, W) grayscale image in [0, 1] on ``self.device`` -> Features;
        (B, H, W) frames -> Features with a leading (B,) axis."""
        if self._first_forward:
            # Kernel builds, lazy module loads and library handles land here.
            self._first_forward = False
            with setup_span("sift.setup.first_forward"):
                return self._features(img)
        return self._features(img)

    def _features(self, img: torch.Tensor) -> Features:
        gauss = self.gaussian(img)
        return self.describe(gauss, self.detect(gauss))

    # The three stages, each a stage span (utils/profiling: host start and
    # end in the span ring; a torch.profiler range only while a profiler
    # runs), detection's and description's parts sub-spans inside them;
    # profile_frontend.py times the stages one by one.

    @torch.no_grad()
    def gaussian(self, img: torch.Tensor) -> list[torch.Tensor]:
        with stage_span("sift.pyramid"):
            return self.pyramid(img)

    @torch.no_grad()
    def detect(self, gauss: list[torch.Tensor]) -> Keypoints:
        with stage_span("sift.detect"):
            with span("sift.detect.dog"):
                dogs = [dog_planes(g) for g in gauss]
            detect = detect_pyramid_batched if dogs[0].dim() == 4 else detect_pyramid
            return detect(dogs, self.cfg, max_keypoints=self.max_keypoints,
                          **self.thresholds)

    @torch.no_grad()
    def describe(self, gauss: list[torch.Tensor], kp: Keypoints) -> Features:
        with stage_span("sift.describe"):
            kp, desc = orient_and_describe(
                gauss, kp, dual_orientation=self.dual_orientation,
                max_radius=max_patch_radius(self.cfg.S, self.cfg.sigma0),
            )
            return Features(keypoints=kp, descriptors=desc)


def extract_features(
    img: torch.Tensor,
    cfg: PyramidConfig,
    max_keypoints: int = 512,
    dual_orientation: bool = False,
    **thresholds,
) -> Features:
    """Functional frontend on one (H, W) image (builds a SiftFrontend on the
    image's device; hold a SiftFrontend to reuse its matrices)."""
    fe = SiftFrontend(cfg, img.shape[0], img.shape[1], max_keypoints=max_keypoints,
                      dual_orientation=dual_orientation, device=img.device,
                      **thresholds)
    return fe(img)
