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

* New landmarks are triangulated against the partner keyframe with
  cheirality + reprojection gating; descriptors are cached per landmark for
  2D-3D matching of later frames.
* Refinement is the Schur-complement BA of ``models/ba``; with loop closure,
  a pose-graph correction (``models/loop_closure``) comes before the final
  BA.

The functions are pure, as in the JAX package: they return a new map and
leave the tensors of the one they were given untouched (each written field
is copied once). Frame slots are Python ints, so a write is a slice and
nothing is copied from the host. The driver reads one number per loop
proposal on the host (its inlier count, the accept decision), as the JAX
driver does.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from sift_parallel_optimization_tpu_torch.models.ba import (
    BAState,
    Observations,
    bundle_adjust,
    resolve_solver,
)
from sift_parallel_optimization_tpu_torch.models.frontend import Features
from sift_parallel_optimization_tpu_torch.models.geometry import (
    Camera,
    essential_from_fundamental,
    pnp_dlt,
    project,
    recover_pose,
    refine_pose,
    reprojection_error,
    rodrigues,
    rotation_log,
    triangulate,
)
from sift_parallel_optimization_tpu_torch.models.keypoints import stable_top_k
from sift_parallel_optimization_tpu_torch.models.matching import (
    _sample_indices,
    match_descriptors,
    matched_points,
    ransac_fundamental,
)
from sift_parallel_optimization_tpu_torch.utils.convert import (
    field,
    tensor_from_numpy,
    tuple_from_numpy,
    tuple_to_numpy,
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
    return SfmMap(
        **{f: tensor_from_numpy(field(arrays, f), _MAP_DTYPES.get(f, torch.float32), device)
           for f in SfmMap._fields if f != "obs"},
        obs=tuple_from_numpy(Observations, field(arrays, "obs"), _OBS_DTYPES, device),
    )


def sfm_map_to_numpy(m: SfmMap) -> dict:
    """The inverse of :func:`sfm_map_from_numpy`: nested dicts of numpy arrays."""
    out = {f: v.cpu().numpy() for f, v in m._asdict().items() if f != "obs"}
    return out | {"obs": tuple_to_numpy(m.obs)}


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
    ``start``. ``start`` and ``cam`` may be Python ints (written through
    slices, nothing copied from the host) or 0-d tensors (no host sync either
    way). As ``lax.dynamic_update_slice`` does, the start clamps so that the
    block fits the capacity."""
    n = pt_idx.shape[0]
    cap = obs.valid.shape[0]
    dev = obs.valid.device
    if isinstance(start, int):
        start = min(max(start, 0), cap - n)

        def upd(arr, vals):
            out = arr.clone()
            out[start:start + n] = vals.to(arr.dtype)
            return out
    else:
        rows = torch.as_tensor(start, device=dev).clamp(0, cap - n) + torch.arange(n, device=dev)
        upd = lambda arr, vals: arr.index_copy(0, rows, vals.to(arr.dtype))
    if isinstance(cam, int):
        cam = torch.full((n,), cam, dtype=torch.int32, device=dev)
    else:
        cam = torch.as_tensor(cam, device=dev).to(torch.int32).expand(n)
    return Observations(
        cam_idx=upd(obs.cam_idx, cam),
        pt_idx=upd(obs.pt_idx, pt_idx),
        uv=upd(obs.uv, uv),
        valid=upd(obs.valid, valid),
    )


def _mark(size: int, idx: torch.Tensor, ok: torch.Tensor, base=None) -> torch.Tensor:
    """(size,) bool mask (a copy of ``base``, else all False) set True at
    ``idx`` where ``ok``: the rejected entries are sent to a spare slot past
    the end, which is then dropped (``.at[].set(mode="drop")``)."""
    out = torch.zeros(size + 1, dtype=torch.bool, device=idx.device)
    if base is not None:
        out[:size] = base
    # index_fill_, not ``out[rows] = True``: that copies a host scalar to the
    # card, which a CUDA graph capture refuses.
    out.index_fill_(0, torch.where(ok, idx, size), True)
    return out[:size]


def _set_rows(arr: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor, vals) -> torch.Tensor:
    """A copy of ``arr`` with rows ``idx`` set to ``vals`` where ``ok``; the
    other writes go to a spare row past the end, which is then dropped."""
    n = arr.shape[0]
    out = torch.cat([arr, torch.zeros_like(arr[:1])])
    out[torch.where(ok, idx, n)] = vals.to(arr.dtype)
    return out[:n]


def _set(arr: torch.Tensor, index, val) -> torch.Tensor:
    """A copy of ``arr`` with ``arr[index]`` (a Python int or slice: nothing
    is copied from the host) set to ``val``. A Python scalar is written by a
    fill: ``out[i] = True`` would copy a host scalar into the 0-d slot, which
    waits on the card and a CUDA graph capture refuses."""
    out = arr.clone()
    if isinstance(val, torch.Tensor):
        out[index] = val
    else:
        out[index].fill_(val)
    return out


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
    # A (1,) index, not a 0-d one: indexing with a 0-d tensor reads it on the
    # host, which a CUDA graph capture refuses.
    best = torch.argmax(counts).view(1)
    theta = thetas[best][0]
    cam = Camera(rvec=theta[:3], tvec=theta[3:])
    cam = refine_pose(
        cam, pts3d, pts2d, K, inl[best][0].to(torch.float32), n_iters=5, solver="lu",
    )
    inliers = score(cam.rvec, cam.tvec)
    return cam, inliers, inliers.sum()


# ---------------------------------------------------------------------------
# Frame registration
# ---------------------------------------------------------------------------


def register_frame(
    generator: torch.Generator | None,
    m: SfmMap,
    feats: Features,
    prev_feats: Features,
    frame_i: int,
    K: torch.Tensor,
    prev_used: torch.Tensor,
    pts_per_frame: int,
    max_reproj: float = 2.0,
    local_window: int | None = None,
    partner_i: int | None = None,
    sample_idx=None,
) -> tuple[SfmMap, torch.Tensor]:
    """Register frame ``frame_i`` (>= 2): PnP against the map, then
    triangulate fresh landmarks against its PARTNER frame.

    ``partner_i`` is the triangulation partner's frame slot (default
    ``frame_i - 1``; the covisibility-order driver passes each frame's most
    covisible registered frame, with ``prev_feats`` being THAT frame's).

    ``prev_used`` marks the partner frame's keypoints already associated with
    map landmarks (PnP inliers or new-landmark births); those are excluded
    from fresh triangulation so an existing landmark whose match missed the
    PnP inlier set is not duplicated. Returns the map and this frame's own
    used mask for the next call.

    ``local_window`` restricts PnP matching to landmarks born within the
    last ``local_window`` frames. None = global matching. The PnP RANSAC
    draws with ``generator`` or takes ``sample_idx`` (``models/matching``).

    Static block layout (B = pts_per_frame):
      * points block  [frame_i*B, (frame_i+1)*B)          -- new landmarks
      * obs block 3*frame_i*B + [0, B)                    -- PnP (2D-3D) obs
      * obs block 3*frame_i*B + [B, 2B)                   -- new pts, this frame
      * obs block 3*frame_i*B + [2B, 3B)                  -- new pts, partner
    Every top-B selection breaks ties by the lower slot, as ``lax.top_k``.
    """
    B = pts_per_frame
    if partner_i is None:
        partner_i = frame_i - 1
    dev = m.points.device
    P = m.points.shape[0]

    # 2D-3D: this frame's descriptors against the landmark descriptors.
    pt_bank = m.pt_valid
    if local_window is not None:
        birth = torch.arange(P, device=dev) // B
        pt_bank = pt_bank & (birth >= frame_i - local_window)
    m3 = match_descriptors(feats.descriptors, m.pt_desc, feats.keypoints.valid, pt_bank)
    uv = torch.stack([feats.keypoints.x, feats.keypoints.y], -1)            # (K, 2)
    mask3 = m3.valid & pt_bank[m3.idx2]
    cam, inl, _n = ransac_pnp(generator, m.points[m3.idx2], uv, mask3, K,
                              sample_idx=sample_idx)
    m = m._replace(
        rvecs=_set(m.rvecs, frame_i, cam.rvec),
        tvecs=_set(m.tvecs, frame_i, cam.tvec),
        cam_valid=_set(m.cam_valid, frame_i, True),
    )
    # PnP observations (capped to B by similarity rank).
    top, keep = stable_top_k(torch.where(inl, m3.similarity, -torch.inf), B)
    keep_ok = torch.isfinite(top)
    obs = _write_obs_block(m.obs, 3 * frame_i * B, frame_i, m3.idx2[keep], uv[keep], keep_ok)
    # Refresh matched landmarks' descriptors with the CURRENT view:
    # descriptors frozen at first observation stop matching once the
    # viewpoint drifts.
    m = m._replace(pt_desc=_set_rows(m.pt_desc, m3.idx2[keep], keep_ok,
                                     feats.descriptors[keep]))

    # 2D-2D against the partner frame: triangulate new landmarks.
    m2 = match_descriptors(prev_feats.descriptors, feats.descriptors,
                           prev_feats.keypoints.valid, feats.keypoints.valid)
    p_prev, p_cur, pair_ok = matched_points(prev_feats.keypoints, feats.keypoints, m2)
    # Exclude keypoints already explained by the map: a current keypoint
    # used as a PnP obs is not "new", and a partner keypoint already
    # associated with a landmark (prev_used) must not seed a duplicate.
    kc = uv.shape[0]
    used = _mark(kc, keep, keep_ok)
    fresh = pair_ok & ~used[m2.idx2] & ~prev_used

    prev_cam = Camera(m.rvecs[partner_i], m.tvecs[partner_i])
    X = triangulate(prev_cam.matrix(K), cam.matrix(K), p_prev, p_cur)
    z_prev = (X @ rodrigues(prev_cam.rvec).T + prev_cam.tvec)[:, 2]
    z_cur = (X @ rodrigues(cam.rvec).T + cam.tvec)[:, 2]
    e_prev = reprojection_error(prev_cam, X, p_prev, K)
    e_cur = reprojection_error(cam, X, p_cur, K)
    good = (fresh & (z_prev > 0) & (z_cur > 0)
            & (e_prev < max_reproj) & (e_cur < max_reproj))
    top2, keep2 = stable_top_k(torch.where(good, m2.similarity, -torch.inf), B)
    keep2_ok = torch.isfinite(top2)

    block = slice(frame_i * B, (frame_i + 1) * B)
    pt_idx = frame_i * B + torch.arange(B, device=dev)
    m = m._replace(
        points=_set(m.points, block, X[keep2]),
        pt_valid=_set(m.pt_valid, block, keep2_ok),
        pt_desc=_set(m.pt_desc, block, feats.descriptors[m2.idx2[keep2]]),
    )
    obs = _write_obs_block(obs, 3 * frame_i * B + B, frame_i, pt_idx, p_cur[keep2], keep2_ok)
    obs = _write_obs_block(obs, 3 * frame_i * B + 2 * B, partner_i, pt_idx, p_prev[keep2],
                           keep2_ok)
    return m._replace(obs=obs), _mark(kc, m2.idx2[keep2], keep2_ok, base=used)


# ---------------------------------------------------------------------------
# Incremental driver
# ---------------------------------------------------------------------------


def _draws(sampler, kind: str, frame: int):
    """The ``sample_idx`` of one RANSAC of the driver: None (draw with the
    generator) or ``sampler`` bound to (kind, frame)."""
    if sampler is None:
        return None
    return lambda valid, n_hyp, n_pts: sampler(kind, frame, valid, n_hyp, n_pts)


def run_sfm(
    generator: torch.Generator | None,
    features: Sequence[Features],
    K: torch.Tensor,
    pts_per_frame: int = 128,
    ba_every: int = 4,
    final_ba_iters: int = 15,
    damping: float = 1e-4,
    huber_delta: float | None = 2.0,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    loop_closure: bool = True,
    loop_min_gap: int = 5,
    loop_min_inliers: int = 30,
    loop_weight: float = 4.0,
    max_loops: int = 8,
    pgo_mesh=None,
    local_window: int | None = None,
    solver: str = "auto",
    pair_selection: str = "sequential",
    pair_mesh=None,
    sampler=None,
) -> SfmMap:
    """Full incremental pipeline over a list of per-frame features, on the
    device of ``K`` and the features.

    ``pair_selection``: "sequential" (default) registers frame i against
    frame i-1. "covisibility" first builds the (F, F) pairwise match-count
    table (``parallel/matching.pairwise_match_counts``) and registers frames
    in maximum-covisibility spanning-tree order, each against its most
    covisible already-registered PARTNER (``covisibility_order``).
    Checkpointing requires sequential order.

    With ``checkpoint_dir`` set, the map is saved every ``checkpoint_every``
    frames and the run RESUMES from the latest checkpoint if one exists
    (``utils/checkpoint``); a checkpoint of a differently-configured run is
    refused.

    With ``loop_closure`` (default), every frame past ``loop_min_gap + 2`` is
    PnP-matched against landmarks born >= ``loop_min_gap`` frames earlier
    (``models/loop_closure``); accepted constraints (the host reads each
    proposal's inlier count, as the JAX driver does) feed a pose-graph
    optimization + landmark re-anchoring before the final BA.

    ``local_window`` switches registration to local-map odometry. ``solver``
    selects the BA Schur solver ("auto" resolves from the map capacities:
    a ~50-frame map takes the implicit-Schur CG). The CG group capacity is
    the structural bound on observations per landmark in this layout:
    2 birth obs + at most one PnP re-observation per later frame + up to
    ``max_loops`` loop re-observations -> n + max_loops.

    RANSAC draws come from ``generator``, or from ``sampler(kind, frame,
    valid, n_hypotheses, n_points) -> indices`` with kind "init" (frame 0),
    "pnp" or "loop": how a test feeds the driver another implementation's
    draws. ``pgo_mesh`` / ``pair_mesh`` (the JAX package's sharded solvers)
    wait for ``parallel/`` on ``torch.distributed`` and must be None.
    """
    if pgo_mesh is not None or pair_mesh is not None:
        raise NotImplementedError(
            "run_sfm(pgo_mesh=/pair_mesh=): the sharded pose-graph solve and ring matcher "
            "are not ported yet (ROADMAP.md, parallel/ on torch.distributed)")
    from sift_parallel_optimization_tpu_torch.models.loop_closure import (
        close_loops,
        propose_loop_closure,
        write_loop_observations,
    )

    n = len(features)
    B = pts_per_frame
    m = empty_map(n, B, max_loops=max_loops, device=K.device)

    # Config fingerprint: refuses to resume a checkpoint written by a
    # differently-configured run.
    ckpt_meta = {
        "n_frames": n,
        "pts_per_frame": B,
        "desc_capacity": int(features[0].descriptors.shape[0]),
    }
    start_frame = 2
    if checkpoint_dir is not None:
        from sift_parallel_optimization_tpu_torch.utils import checkpoint as ckpt

        step = ckpt.latest_step(checkpoint_dir)
        if step is not None:
            m, step = ckpt.load_pytree(checkpoint_dir, m, meta=ckpt_meta)
            start_frame = step + 1

    solver = resolve_solver(n, n * B, solver)
    ba_kwargs: dict = dict(damping=damping, huber_delta=huber_delta, solver=solver)
    if solver == "cg":
        # Structural per-landmark observation bound, rounded up to 8.
        ba_kwargs["max_obs_per_point"] = -(-(n + max_loops) // 8) * 8

    def ba(m, n_iters):
        st = bundle_adjust(m.ba_state(), m.obs, K, n_iters=n_iters, **ba_kwargs)
        return m._replace(rvecs=st.rvecs, tvecs=st.tvecs, points=st.points)

    loop_frames: list[int] = []
    loop_poses: list[Camera] = []

    def propose(m, f):
        """Loop proposal of frame f; writes it into the map if accepted."""
        prop = propose_loop_closure(generator, features[f], m, f, K, B, min_gap=loop_min_gap,
                                    sample_idx=_draws(sampler, "loop", f))
        if int(prop.n_inliers) >= loop_min_inliers and len(loop_frames) < max_loops:
            m = write_loop_observations(m, prop, f, len(loop_frames), B)
            loop_frames.append(f)
            loop_poses.append(Camera(rvec=prop.rvec, tvec=prop.tvec))
        return m

    def finish(m):
        if loop_closure and loop_frames:
            m = close_loops(m, n, loop_frames, loop_poses, B, loop_weight=loop_weight)
        return ba(m, final_ba_iters)

    if pair_selection == "covisibility":
        if checkpoint_dir is not None:
            raise ValueError("pair_selection='covisibility' does not support checkpointing "
                             "(resume assumes sequential frame order)")
        return finish(_run_sfm_covisibility(
            generator, features, K, m, B, ba_every, ba, loop_closure, loop_min_gap, propose,
            sampler))
    if pair_selection != "sequential":
        raise ValueError(f"pair_selection must be 'sequential' or 'covisibility', "
                         f"got {pair_selection!r}")

    # Per-frame keypoint-used mask (duplicate-landmark suppression). After a
    # checkpoint resume the previous frame's mask is unknown: start
    # conservative (all unused; at worst one frame may birth duplicates).
    used = torch.zeros(features[0].keypoints.valid.shape[0], dtype=torch.bool, device=K.device)
    if start_frame == 2:
        m, used = init_two_view(generator, features[0], features[1], K, m, B,
                                sample_idx=_draws(sampler, "init", 0))
    for i in range(start_frame, n):
        m, used = register_frame(generator, m, features[i], features[i - 1], i, K, used, B,
                                 local_window=local_window,
                                 sample_idx=_draws(sampler, "pnp", i))
        if loop_closure and i >= loop_min_gap + 2:
            m = propose(m, i)
        if ba_every and (i % ba_every == 0 or i == n - 1):
            m = ba(m, 5)
        if checkpoint_dir is not None and checkpoint_every and (
            i % checkpoint_every == 0 or i == n - 1
        ):
            from sift_parallel_optimization_tpu_torch.utils import checkpoint as ckpt

            ckpt.save_pytree(checkpoint_dir, m, step=i, meta=ckpt_meta)
    return finish(m)


def _run_sfm_covisibility(generator, features, K, m, B, ba_every, ba, loop_closure,
                          loop_min_gap, propose, sampler) -> SfmMap:
    """Covisibility-order registration (``run_sfm`` pair_selection mode):
    frames register in maximum-spanning-tree order of the pairwise match
    table, each against its most covisible partner. Frame ids keep their
    original slots (the block layout is order-independent), so BA, loop
    closure and trajectory indexing are untouched. Returns the map before
    the loop correction and the final BA (``run_sfm`` applies both)."""
    from sift_parallel_optimization_tpu_torch.parallel.matching import (
        covisibility_order,
        pairwise_match_counts,
    )

    n = len(features)
    desc = torch.stack([f.descriptors for f in features])
    val = torch.stack([f.keypoints.valid for f in features])
    order, partner = covisibility_order(pairwise_match_counts(desc, val).cpu().numpy())

    a, b = order[0], order[1]
    m, used_a, used_b = init_two_view(generator, features[a], features[b], K, m, B,
                                      slot_a=a, slot_b=b, return_used_pair=True,
                                      sample_idx=_draws(sampler, "init", 0))
    used = {a: used_a, b: used_b}
    for pos, f in enumerate(order[2:], start=2):
        p = partner[f]
        m, used[f] = register_frame(generator, m, features[f], features[p], f, K, used[p], B,
                                    partner_i=p, sample_idx=_draws(sampler, "pnp", f))
        if loop_closure and pos >= loop_min_gap + 2:
            m = propose(m, f)
        if ba_every and (pos % ba_every == 0 or pos == n - 1):
            m = ba(m, 5)
    return m
