"""Incremental structure-from-motion: the map, the two-view bootstrap and
PnP registration (port of the first part of ``models/sfm.py``).

* The map has FIXED capacities (cameras, points, observations) with valid
  masks; every frame owns statically-placed slot blocks (frame i writes
  points into [i*B, (i+1)*B) and observations into fixed blocks), so every
  step sees static shapes and nothing is compacted or synchronised with the
  host.
* PnP registration is BATCHED RANSAC like ``models/matching``: all minimal
  6-point hypotheses are solved (batched DLT + GN refine) and scored in one
  shot.

The functions are pure, as in the JAX package: they return a new map and
leave the tensors of the one they were given untouched (each written field
is copied once). Ported so far: ``init_two_view`` and ``ransac_pnp``;
``register_frame``, ``run_sfm`` and covisibility-order registration need bundle
adjustment and are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sift_parallel_optimization_tpu_torch.models.ba import BAState, Observations
from sift_parallel_optimization_tpu_torch.models.frontend import Features, field
from sift_parallel_optimization_tpu_torch.models.geometry import (
    Camera,
    essential_from_fundamental,
    pnp_dlt,
    project,
    recover_pose,
    refine_pose,
    reprojection_error,
    rotation_log,
)
from sift_parallel_optimization_tpu_torch.models.keypoints import stable_top_k
from sift_parallel_optimization_tpu_torch.models.matching import (
    _sample_indices,
    match_descriptors,
    matched_points,
    ransac_fundamental,
)
from sift_parallel_optimization_tpu_torch.utils.device import resolve_device

# Fundamental-matrix hypotheses of the two-view bootstrap.
BOOTSTRAP_HYPOTHESES = 512


class SfmMap(NamedTuple):
    """Fixed-capacity incremental map (capacities are static)."""

    rvecs: torch.Tensor      # (C, 3)
    tvecs: torch.Tensor      # (C, 3)
    cam_valid: torch.Tensor  # (C,)
    points: torch.Tensor     # (P, 3)
    pt_valid: torch.Tensor   # (P,)
    pt_desc: torch.Tensor    # (P, 128) descriptor of first observation
    obs: Observations        # capacity M observations

    def n_cameras(self) -> torch.Tensor:
        return self.cam_valid.sum()

    def n_points(self) -> torch.Tensor:
        return self.pt_valid.sum()

    def ba_state(self) -> BAState:
        return BAState(rvecs=self.rvecs, tvecs=self.tvecs, points=self.points)


_OBS_DTYPES = {"cam_idx": torch.int32, "pt_idx": torch.int32, "uv": torch.float32,
               "valid": torch.bool}
_MAP_DTYPES = {"cam_valid": torch.bool, "pt_valid": torch.bool}


def sfm_map_from_numpy(arrays, device=None) -> SfmMap:
    """SfmMap from numpy arrays, field for field: a mapping or named tuple of
    the SfmMap fields whose ``obs`` is a mapping or named tuple of the
    Observations fields (e.g. the JAX package's map after ``np.asarray``).
    ``device`` None means the card, and raises without one."""
    device = resolve_device(device)
    as_t = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt).to(device)
    obs = field(arrays, "obs")
    return SfmMap(
        **{f: as_t(field(arrays, f), _MAP_DTYPES.get(f, torch.float32))
           for f in SfmMap._fields if f != "obs"},
        obs=Observations(**{f: as_t(field(obs, f), dt) for f, dt in _OBS_DTYPES.items()}),
    )


def sfm_map_to_numpy(m: SfmMap) -> dict:
    """The inverse of :func:`sfm_map_from_numpy`: nested dicts of numpy arrays."""
    out = {f: v.cpu().numpy() for f, v in m._asdict().items() if f != "obs"}
    out["obs"] = {f: v.cpu().numpy() for f, v in m.obs._asdict().items()}
    return out


def _empty_obs(capacity: int, device=None) -> Observations:
    return Observations(
        cam_idx=torch.zeros(capacity, dtype=torch.int32, device=device),
        pt_idx=torch.zeros(capacity, dtype=torch.int32, device=device),
        uv=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def empty_map(n_cams: int, pts_per_frame: int, max_loops: int = 8, device=None) -> SfmMap:
    """Capacities: P = n_cams * pts_per_frame, M = 3 * P + max_loops * B
    (each point gets up to one obs at birth in two frames + one PnP obs
    per later frame, amortized to 3 blocks per frame; accepted loop closures
    append up to ``max_loops`` extra blocks of 2D-3D re-observations of old
    landmarks). The map lives on ``device``; None means the card, and raises
    without one."""
    device = resolve_device(device)
    C = n_cams
    P = n_cams * pts_per_frame
    M = 3 * P + max_loops * pts_per_frame
    f32 = dict(dtype=torch.float32, device=device)
    return SfmMap(
        rvecs=torch.zeros((C, 3), **f32),
        tvecs=torch.zeros((C, 3), **f32),
        cam_valid=torch.zeros(C, dtype=torch.bool, device=device),
        points=torch.zeros((P, 3), **f32),
        pt_valid=torch.zeros(P, dtype=torch.bool, device=device),
        pt_desc=torch.zeros((P, 128), **f32),
        obs=_empty_obs(M, device),
    )


def _write_obs_block(obs: Observations, start, cam, pt_idx, uv, valid) -> Observations:
    """A copy of ``obs`` with one contiguous observation block written at
    ``start`` (a Python int or a 0-d tensor: no host sync either way). As
    ``lax.dynamic_update_slice`` does, the start clamps so that the block
    fits the capacity."""
    n = pt_idx.shape[0]
    dev = obs.valid.device
    start = torch.as_tensor(start, device=dev).clamp(0, obs.valid.shape[0] - n)
    rows = start + torch.arange(n, device=dev)
    cam = torch.as_tensor(cam, device=dev).to(torch.int32).expand(n)
    upd = lambda arr, vals: arr.index_copy(0, rows, vals.to(arr.dtype))
    return Observations(
        cam_idx=upd(obs.cam_idx, cam),
        pt_idx=upd(obs.pt_idx, pt_idx),
        uv=upd(obs.uv, uv),
        valid=upd(obs.valid, valid),
    )


def _mark(size: int, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """(size,) bool mask, True at ``idx`` where ``ok``: the rejected entries
    are sent to a spare slot past the end, which is then dropped."""
    out = torch.zeros(size + 1, dtype=torch.bool, device=idx.device)
    out[torch.where(ok, idx, size)] = True
    return out[:size]


# ---------------------------------------------------------------------------
# Two-view bootstrap
# ---------------------------------------------------------------------------


def init_two_view(
    generator: torch.Generator | None,
    f0: Features,
    f1: Features,
    K: torch.Tensor,
    m: SfmMap,
    pts_per_frame: int,
    max_reproj: float = 2.0,
    slot_a=0,
    slot_b=1,
    return_used_pair: bool = False,
    sample_idx: torch.Tensor | None = None,
):
    """Bootstrap the map from a frame pair: F -> E -> (R, t) -> triangulate.

    Writes cameras ``slot_a``/``slot_b`` (defaults 0/1 -- frames registered
    in sequence), point block ``slot_a``, and two observation blocks in
    frame ``slot_a``'s block region (3*slot_a*B + {0, B} -- slots a
    never-registered bootstrap frame leaves free). Keeps at most
    ``pts_per_frame`` best landmarks (static top-k, ties to the lower
    slot). Camera ``slot_a`` gets the identity pose.

    The fundamental-matrix RANSAC draws with ``generator`` or takes
    ``sample_idx``, (BOOTSTRAP_HYPOTHESES, 8) indices (``models/matching``).

    Returns (map, used_b), or (map, used_a, used_b) with
    ``return_used_pair`` -- the masks of each frame's keypoints consumed
    by bootstrap landmarks, so a later frame triangulating against
    either bootstrap frame does not duplicate them.
    """
    match = match_descriptors(
        f0.descriptors, f1.descriptors, f0.keypoints.valid, f1.keypoints.valid,
    )
    p0, p1, pair_ok = matched_points(f0.keypoints, f1.keypoints, match)
    res = ransac_fundamental(generator, p0, p1, pair_ok, n_hypotheses=BOOTSTRAP_HYPOTHESES,
                             sample_idx=sample_idx)
    E = essential_from_fundamental(res.model, K)
    R, t, X, front = recover_pose(E, p0, p1, K, res.inliers)

    rvec1 = rotation_log(R)
    # Gate: in front of both cameras + reprojection error in both views.
    zero3 = torch.zeros(3, dtype=K.dtype, device=K.device)
    e0 = reprojection_error(Camera(zero3, zero3), X, p0, K)
    e1 = reprojection_error(Camera(rvec1, t), X, p1, K)
    good = front & (e0 < max_reproj) & (e1 < max_reproj)
    score = torch.where(good, match.similarity, -torch.inf)
    top, keep = stable_top_k(score, pts_per_frame)
    keep_ok = torch.isfinite(top)

    B = pts_per_frame
    dev = K.device
    slot_a = torch.as_tensor(slot_a, device=dev).long()
    slot_b = torch.as_tensor(slot_b, device=dev).long()
    pt_idx = slot_a * B + torch.arange(pts_per_frame, device=dev)
    true = torch.ones(2, dtype=torch.bool, device=dev)
    m = m._replace(
        rvecs=m.rvecs.index_copy(0, slot_b[None], rvec1[None]),
        tvecs=m.tvecs.index_copy(0, slot_b[None], t[None]),
        cam_valid=m.cam_valid.index_copy(0, torch.stack([slot_a, slot_b]), true),
        points=m.points.index_copy(0, pt_idx, X[keep]),
        pt_valid=m.pt_valid.index_copy(0, pt_idx, keep_ok),
        pt_desc=m.pt_desc.index_copy(0, pt_idx, f0.descriptors[keep]),
    )
    obs = _write_obs_block(m.obs, 3 * slot_a * B, slot_a, pt_idx, p0[keep], keep_ok)
    obs = _write_obs_block(obs, 3 * slot_a * B + B, slot_b, pt_idx, p1[keep], keep_ok)
    m = m._replace(obs=obs)
    used_b = _mark(f1.keypoints.valid.shape[0], match.idx2[keep], keep_ok)
    if not return_used_pair:
        return m, used_b
    return m, _mark(f0.keypoints.valid.shape[0], keep, keep_ok), used_b


# ---------------------------------------------------------------------------
# PnP RANSAC registration
# ---------------------------------------------------------------------------


def ransac_pnp(
    generator: torch.Generator | None,
    pts3d: torch.Tensor,
    pts2d: torch.Tensor,
    mask: torch.Tensor,
    K: torch.Tensor,
    n_hypotheses: int = 128,
    threshold: float = 3.0,
    sample_idx: torch.Tensor | None = None,
) -> tuple[Camera, torch.Tensor, torch.Tensor]:
    """Batched-hypothesis PnP: (cam, inliers, n_inliers). Draws its minimal
    6-point samples with ``generator`` or takes ``sample_idx``,
    (n_hypotheses, 6) indices (``models/matching``)."""
    idx = _sample_indices(generator, mask, n_hypotheses, 6, sample_idx)   # (N, 6)
    # Each minimal sample's 6 points, not one-hot weights over the full set:
    # the DLT design is (12, 12) per hypothesis, not (2*P, 12).
    ones = torch.ones((n_hypotheses, 6), dtype=pts3d.dtype, device=pts3d.device)
    cams = pnp_dlt(pts3d[idx], pts2d[idx], K, ones)
    thetas = torch.cat([cams.rvec, cams.tvec], dim=-1)                    # (N, 6)
    ok = torch.isfinite(thetas).all(dim=-1)
    thetas = torch.where(ok[:, None], thetas, 0.0)

    def score(rvec, tvec):
        uv, z = project(pts3d, rvec, tvec, K)
        err = torch.linalg.vector_norm(uv - pts2d, dim=-1)
        return (err < threshold) & (z > 0) & mask

    inl = score(thetas[:, :3], thetas[:, 3:])                             # (N, K)
    counts = torch.where(ok, inl.sum(-1), -1)
    best = torch.argmax(counts)
    cam = Camera(rvec=thetas[best, :3], tvec=thetas[best, 3:])
    cam = refine_pose(
        cam, pts3d, pts2d, K, inl[best].to(torch.float32), n_iters=5, solver="lu",
    )
    inliers = score(cam.rvec, cam.tvec)
    return cam, inliers, inliers.sum()
