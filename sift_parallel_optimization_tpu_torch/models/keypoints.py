"""Fixed-capacity keypoint containers (port of ``models/keypoints.py``).

Every stage produces fixed-capacity tensors with a ``valid`` mask; dead
slots are masked, not compacted, exactly as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.utils.convert import tuple_from_numpy
from sift_parallel_optimization_tpu_torch.utils.device import resolve_device


class Keypoints(NamedTuple):
    """A fixed-capacity batch of keypoints; every field has shape (K,).

    Coordinates are ORIGINAL-image pixels (``x`` column, ``y`` row);
    ``sigma`` is the absolute scale; ``octave``/``scale`` locate the source
    DoG plane. Invalid slots have ``valid == False``.
    """

    x: torch.Tensor            # f32
    y: torch.Tensor            # f32
    sigma: torch.Tensor        # f32
    score: torch.Tensor        # f32, |contrast| after subpixel interpolation
    orientation: torch.Tensor  # f32, radians in [-pi, pi); 0 until assigned
    octave: torch.Tensor       # int32
    scale: torch.Tensor        # int32, 1..S
    valid: torch.Tensor        # bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)


_DTYPES = {
    "octave": torch.int32,
    "scale": torch.int32,
    "valid": torch.bool,
}


def empty_keypoints(capacity: int, device=None) -> Keypoints:
    """All-invalid keypoints on ``device``; None means the card, and raises
    without one."""
    device = resolve_device(device)
    z = torch.zeros(capacity, dtype=torch.float32, device=device)
    zi = torch.zeros(capacity, dtype=torch.int32, device=device)
    return Keypoints(
        x=z, y=z, sigma=z, score=z, orientation=z, octave=zi, scale=zi,
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def concat_keypoints(kps: list[Keypoints]) -> Keypoints:
    return Keypoints(*[torch.cat(f, dim=-1) for f in zip(*kps)])


def stable_top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties broken by the lower index, as
    ``lax.top_k`` does (``torch.topk`` makes no such promise)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_keypoints(kp: Keypoints, k: int) -> Keypoints:
    """Keep the k highest-score valid keypoints (static output shape)."""
    score = torch.where(kp.valid, kp.score, torch.full_like(kp.score, -torch.inf))
    top, idx = stable_top_k(score, k)
    out = Keypoints(*[f[..., idx] for f in kp])
    return out._replace(valid=out.valid & torch.isfinite(top))


def keypoints_from_numpy(arrays, device=None) -> Keypoints:
    """Keypoints from per-field numpy arrays (a dict, or e.g. the JAX
    detector's output converted with ``np.asarray``). ``device`` None means
    the card, and raises without one."""
    return tuple_from_numpy(Keypoints, arrays, _DTYPES, device)
