"""Loop closure: place recognition + pose-graph correction for the SfM
driver (port of ``models/loop_closure.py``).

* Place recognition is the brute-force matcher (``models/matching``): the
  current frame's descriptors are matched against the landmark bank
  RESTRICTED to old map blocks (landmarks born >= ``min_gap`` frames ago --
  block ownership is static, ``models/sfm``), one masked (K, P) product.
* The loop constraint is a PnP RANSAC pose against those old landmarks --
  metric scale comes from the map, resolving the monocular scale ambiguity
  that a 2D-2D essential-matrix edge would leave open.
* Constraints feed the pose graph (``models/pose_graph``) as edges anchored
  at node 0 (the PnP pose is absolute in the old-map frame, which IS camera
  0's frame); odometry edges come from the current incremental estimates.
  After PGO, landmarks are re-anchored by their birth keyframe's pose
  correction and a final BA polishes everything.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.models.frontend import Features
from sift_parallel_optimization_tpu_torch.models.geometry import Camera, rodrigues
from sift_parallel_optimization_tpu_torch.models.keypoints import stable_top_k
from sift_parallel_optimization_tpu_torch.models.matching import match_descriptors
from sift_parallel_optimization_tpu_torch.models.pose_graph import (
    PoseGraphEdges,
    Poses,
    optimize_pose_graph,
    relative_pose,
)
from sift_parallel_optimization_tpu_torch.models.sfm import SfmMap, _write_obs_block, ransac_pnp
from sift_parallel_optimization_tpu_torch.utils.convert import tuple_from_numpy, tuple_to_numpy


class LoopProposal(NamedTuple):
    rvec: torch.Tensor       # (3,) PnP pose of the query frame vs the old map
    tvec: torch.Tensor       # (3,)
    n_inliers: torch.Tensor  # () -- the host gates acceptance on this
    pt_idx: torch.Tensor     # (B,) matched old-landmark indices (top inliers)
    uv: torch.Tensor         # (B, 2) their pixel observations in this frame
    valid: torch.Tensor      # (B,) slot mask


def loop_proposal_from_numpy(arrays, device=None) -> LoopProposal:
    """LoopProposal from numpy arrays (a mapping or named tuple of its fields,
    e.g. the JAX package's proposal). ``device`` None means the card, and
    raises without one."""
    return tuple_from_numpy(LoopProposal, arrays,
                            {"n_inliers": torch.int64, "pt_idx": torch.int64,
                             "valid": torch.bool}, device)


loop_proposal_to_numpy = tuple_to_numpy


def propose_loop_closure(
    generator: torch.Generator | None,
    feats: Features,
    m: SfmMap,
    frame_i,
    K: torch.Tensor,
    pts_per_frame: int,
    min_gap: int = 4,
    threshold: float = 3.0,
    sample_idx: torch.Tensor | None = None,
) -> LoopProposal:
    """PnP the current frame against landmarks born >= min_gap frames ago.

    ``frame_i`` may be a Python int or a 0-d tensor (no host sync);
    acceptance (n_inliers >= bar) is the caller's host-side decision. The
    top ``pts_per_frame`` inlier matches (ties to the lower slot) come back
    as ready-to-write observations. The PnP RANSAC draws with ``generator``
    or takes ``sample_idx`` ((128, 6) indices, ``models/matching``).
    """
    P = m.points.shape[0]
    birth_frame = torch.arange(P, device=m.points.device) // pts_per_frame
    old = m.pt_valid & (birth_frame <= torch.as_tensor(frame_i, device=m.points.device) - min_gap)
    match = match_descriptors(feats.descriptors, m.pt_desc, feats.keypoints.valid, old)
    uv = torch.stack([feats.keypoints.x, feats.keypoints.y], -1)
    pts3d = m.points[match.idx2]
    mask = match.valid & old[match.idx2]
    cam, inl, n = ransac_pnp(generator, pts3d, uv, mask, K, threshold=threshold,
                             sample_idx=sample_idx)
    score = torch.where(inl, match.similarity, -torch.inf)
    top, keep = stable_top_k(score, pts_per_frame)
    return LoopProposal(
        rvec=cam.rvec, tvec=cam.tvec, n_inliers=n,
        pt_idx=match.idx2[keep], uv=uv[keep], valid=torch.isfinite(top),
    )


def write_loop_observations(
    m: SfmMap, prop: LoopProposal, frame_i, loop_slot, pts_per_frame: int
) -> SfmMap:
    """Append an accepted loop's 2D-3D matches as observation block
    ``loop_slot`` in the loop region of the obs list (``models/sfm.
    empty_map`` reserves max_loops blocks past the per-frame layout)."""
    B = pts_per_frame
    C = m.rvecs.shape[0]
    start = 3 * C * B + torch.as_tensor(loop_slot, device=m.points.device) * B
    obs = _write_obs_block(m.obs, start, frame_i, prop.pt_idx, prop.uv, prop.valid)
    return m._replace(obs=obs)


def build_pose_graph_edges(
    m: SfmMap,
    n_frames: int,
    loop_frames: list[int],
    loop_poses: list[Camera],
    capacity: int | None = None,
    loop_weight: float = 4.0,
    loop_sources: list[int] | None = None,
) -> PoseGraphEdges:
    """Odometry chain from the current estimates + loop edges.

    Each accepted loop becomes an edge (loop_sources[k] -> loop_frames[k])
    whose measurement is the PnP pose composed with the source node's
    estimate. ``loop_sources`` defaults to node 0 for every loop (the PnP
    pose is absolute in camera-0's frame). Padding edges (i = j = 0, zero
    measurement, weight 0) fill the list up to ``capacity``.
    """
    if capacity is None:
        capacity = (n_frames - 1) + max(len(loop_frames), 1)
    if loop_sources is None:
        loop_sources = [0] * len(loop_frames)
    n_edges = (n_frames - 1) + len(loop_frames)
    if capacity < n_edges:
        raise ValueError(f"edge capacity {capacity} < {n_edges} edges")
    dev = m.rvecs.device
    src = list(range(n_frames - 1)) + [int(s) for s in loop_sources]
    dst = list(range(1, n_frames)) + [int(f) for f in loop_frames]
    # The chain edges, all in one batched call.
    rr, rt = relative_pose(m.rvecs[: n_frames - 1], m.tvecs[: n_frames - 1],
                           m.rvecs[1:n_frames], m.tvecs[1:n_frames])
    rel_r, rel_t = [rr], [rt]
    if loop_frames:
        s = torch.as_tensor(src[n_frames - 1:], device=dev)
        lr, lt = relative_pose(m.rvecs[s], m.tvecs[s],
                               torch.stack([c.rvec for c in loop_poses]),
                               torch.stack([c.tvec for c in loop_poses]))
        rel_r.append(lr)
        rel_t.append(lt)
    pad = capacity - n_edges
    rel_r.append(torch.zeros((pad, 3), device=dev))
    rel_t.append(torch.zeros((pad, 3), device=dev))
    w = [1.0] * (n_frames - 1) + [loop_weight] * len(loop_frames) + [0.0] * pad
    return PoseGraphEdges(
        i=torch.tensor(src + [0] * pad, dtype=torch.int32, device=dev),
        j=torch.tensor(dst + [0] * pad, dtype=torch.int32, device=dev),
        rel_rvec=torch.cat(rel_r).to(torch.float32),
        rel_tvec=torch.cat(rel_t).to(torch.float32),
        weight=torch.tensor(w, dtype=torch.float32, device=dev),
    )


def apply_pose_correction(m: SfmMap, new_poses: Poses, pts_per_frame: int) -> SfmMap:
    """Re-anchor landmarks by their birth keyframe's pose correction.

    A landmark born at keyframe k keeps its camera-frame coordinates under
    k's correction: X' = R_new^T (R_old X + t_old - t_new). Observations are
    untouched (they live in pixel space); the follow-up BA consumes the
    corrected geometry as its initialization.
    """
    P = m.points.shape[0]
    birth = torch.arange(P, device=m.points.device) // pts_per_frame
    birth = torch.clamp(birth, 0, m.rvecs.shape[0] - 1)
    r_old = rodrigues(m.rvecs[birth])             # (P, 3, 3)
    r_new = rodrigues(new_poses.rvecs[birth])
    x_cam = torch.einsum("pij,pj->pi", r_old, m.points) + m.tvecs[birth]
    x_new = torch.einsum("pji,pj->pi", r_new, x_cam - new_poses.tvecs[birth])
    return m._replace(
        rvecs=new_poses.rvecs,
        tvecs=new_poses.tvecs,
        points=torch.where(m.pt_valid[:, None], x_new, m.points),
    )


def close_loops(
    m: SfmMap,
    n_frames: int,
    loop_frames: list[int],
    loop_poses: list[Camera],
    pts_per_frame: int,
    loop_weight: float = 4.0,
    pgo_iters: int = 12,
    damping: float = 1e-3,
    mesh=None,
) -> SfmMap:
    """PGO over the odometry chain + loop edges, then landmark re-anchor.

    ``mesh`` (the JAX package's edge-sharded distributed PGO) waits for
    ``parallel/`` on ``torch.distributed``: it must be None.
    """
    if mesh is not None:
        raise NotImplementedError(
            "close_loops(mesh=...): the distributed pose-graph solve is not ported yet "
            "(ROADMAP.md, parallel/ on torch.distributed); pass mesh=None")
    edges = build_pose_graph_edges(m, n_frames, loop_frames, loop_poses, loop_weight=loop_weight)
    new_poses = optimize_pose_graph(Poses(rvecs=m.rvecs, tvecs=m.tvecs), edges,
                                    n_iters=pgo_iters, damping=damping)
    return apply_pose_correction(m, new_poses, pts_per_frame)
