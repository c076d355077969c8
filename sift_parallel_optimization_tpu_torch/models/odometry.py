"""Sliding-window visual odometry: O(window) memory for sequences of any
length (port of ``models/odometry.py``: ``run_odometry``, its online form
``OdometryStream`` and their parts).

``models/sfm``'s map capacities scale with the total frame count. This module
is the constant-memory companion: a fixed WINDOW of the most recent frames is
kept in a map of static capacity (C = W cameras, P = W*B points, M = 3*W*B
observations); older frames are EVICTED by shifting every block-structured
array down one frame slot, and their poses are frozen into the output
trajectory.

* The shift is a static-shape roll: cameras move down one slot, point blocks
  down B slots, observation blocks down 3*B slots, and the observation
  indices are decremented in place.
* Because eviction renumbers slots, a full window always registers the new
  frame at slot W-1 against slot W-2: the steady state is one step with
  fixed shapes and constant slots, whatever the frame.
* Window BA gauge-fixes slot 0, the oldest surviving camera, whose pose is
  already consistent with the frozen past.
* With loop closure, evicted landmark blocks go into a fixed-capacity ring
  (:class:`LandmarkArchive`); every frame is PnP-matched against it and the
  accepted constraints land in a device-side :class:`LoopBuffer`, read once
  at the end and fed to one pose-graph correction of the whole trajectory
  (:func:`correct_trajectory`, Sim(3) by default).

The JAX package scans the fused steady step with ``lax.scan``. Here the step
(:func:`make_steady_step`) is captured as a CUDA graph on the card, one graph
per variant that occurs (window BA or not, loop proposal or not: both known
on the host from the frame index) and replayed frame after frame on static
buffers (:class:`SteadyStepRunner`). Nothing in the steady state reads the
device on the host. RANSAC draws are made outside the graph: a (2, 768)
uniform buffer filled from the caller's generator before each frame, mapped
onto the valid slots inside the step, so a replay draws fresh numbers and the
eager and the captured step draw the same ones. The runner is fed
frame by frame through a two-slot ring of static feature buffers:
:class:`OdometryStream` serves frames one at a time on it, and
:func:`run_odometry` pushes its sequence through a stream.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Sequence

import torch

from sift_parallel_optimization_tpu_torch.models.ba import (
    Anchors,
    Observations,
    bundle_adjust,
    empty_anchors,
    resolve_solver,
)
from sift_parallel_optimization_tpu_torch.models.frontend import Features
from sift_parallel_optimization_tpu_torch.models.geometry import Camera, rodrigues, rotation_log
from sift_parallel_optimization_tpu_torch.models.keypoints import Keypoints
from sift_parallel_optimization_tpu_torch.models.matching import match_descriptors
from sift_parallel_optimization_tpu_torch.models.sfm import (
    SfmMap,
    empty_map,
    init_two_view,
    ransac_pnp,
    register_frame,
)
from sift_parallel_optimization_tpu_torch.utils.convert import tuple_from_numpy
from sift_parallel_optimization_tpu_torch.utils.device import f32_precision, resolve_device

# Uniforms one PnP RANSAC of the step draws: ransac_pnp's 128 hypotheses of
# 6 points. A frame draws (2, PNP_DRAWS): registration and loop proposal.
PNP_DRAWS = 128 * 6


class Trajectory(NamedTuple):
    """Full-sequence pose estimates (world->cam axis-angle + translation)."""

    rvecs: torch.Tensor  # (n, 3)
    tvecs: torch.Tensor  # (n, 3)


def _i32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a Python int or a tensor) as an int32 tensor on ``like``'s
    device; an int is written by a fill, never copied from the host, so this
    is safe inside a CUDA graph capture."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# Landmark archive (loop-closure place memory)
# ---------------------------------------------------------------------------


class LandmarkArchive(NamedTuple):
    """Fixed-capacity ring of EVICTED landmarks for loop closure.

    When a frame leaves the window its landmark block is frozen -- world
    positions, descriptors, birth frame -- into this ring (capacity A, write
    head wraps). The current frame's descriptors are matched against it and
    a PnP against the archived world points yields an ABSOLUTE pose
    constraint: metric scale comes from the archived map.
    """

    positions: torch.Tensor  # (A, 3) world coordinates, frozen at eviction
    desc: torch.Tensor       # (A, 128)
    birth: torch.Tensor      # (A,) int32 global frame id of the birth keyframe
    valid: torch.Tensor      # (A,) bool


def empty_archive(capacity: int, device=None) -> LandmarkArchive:
    """An empty archive on ``device`` (None means the card, and raises
    without one)."""
    device = resolve_device(device)
    return LandmarkArchive(
        positions=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        desc=torch.zeros((capacity, 128), dtype=torch.float32, device=device),
        birth=torch.zeros(capacity, dtype=torch.int32, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def archive_from_numpy(arrays, device=None) -> LandmarkArchive:
    """LandmarkArchive from numpy arrays (``utils/convert.tuple_from_numpy``:
    e.g. the JAX package's archive). ``device`` None means the card."""
    return tuple_from_numpy(LandmarkArchive, arrays,
                            {"birth": torch.int32, "valid": torch.bool}, device)



def archive_evicted_block(arch: LandmarkArchive, m: SfmMap, write_slot, birth_frame,
                          pts_per_frame: int) -> LandmarkArchive:
    """Freeze window slot 0's landmark block into the ring before a shift.

    ``write_slot`` counts evictions (a Python int or a 0-d tensor); the
    block lands at ring offset (write_slot * B) mod A, its start clamped so
    that the block fits, as ``lax.dynamic_update_slice`` does. Under the
    coverage policy ``write_slot`` is the block :func:`coverage_write_slot`
    chose (< A/B, so the mod is a no-op).
    """
    B = pts_per_frame
    A = arch.valid.shape[0]
    start = torch.remainder(_i32(write_slot, arch.birth) * B, A).clamp(0, A - B)
    rows = start.long() + torch.arange(B, device=arch.birth.device)

    def upd(arr, vals):
        return arr.index_copy(0, rows, vals.to(arr.dtype))

    return LandmarkArchive(
        positions=upd(arch.positions, m.points[:B]),
        desc=upd(arch.desc, m.pt_desc[:B]),
        birth=upd(arch.birth, _i32(birth_frame, arch.birth).expand(B)),
        valid=upd(arch.valid, m.pt_valid[:B]),
    )


def coverage_write_slot(arch: LandmarkArchive, m: SfmMap, birth_frame, min_gap: int,
                        pts_per_frame: int, now_frame=None) -> torch.Tensor:
    """Pick the archive BLOCK to overwrite by age-stratified redundancy.

    FIFO eviction forgets by AGE: a ring of A/B blocks wraps after that many
    evictions, so a revisit later than one ring period finds its place
    memory overwritten. The policy protects OLD coverage:

    * a block is OLD if its birth precedes ``now_frame - min_gap`` (the age
      at which the loop proposer treats it as loop fodder; ``now_frame``
      defaults to ``birth_frame``);
    * a YOUNG block is redundant if any other occupied block or the incoming
      block covers its place;
    * an OLD block can only be made redundant by another OLD block; the
      incoming block never displaces old memory;
    * among equals the YOUNGER of a redundant pair goes (exact lexicographic
      min novelty, then max birth among near-ties);
    * empty blocks are filled first in index order (FIFO while filling).

    O((A/B)^2) centroid distances per eviction, on the device; returns the
    int32 block index for :func:`archive_evicted_block`.
    """
    B = pts_per_frame
    nb = arch.valid.shape[0] // B
    big = 1e30
    now = birth_frame if now_frame is None else now_frame
    pos = arch.positions.reshape(nb, B, 3)
    val = arch.valid.reshape(nb, B).to(torch.float32)
    cnt = val.sum(-1)
    cent = (pos * val[..., None]).sum(1) / torch.clamp(cnt, min=1.0)[:, None]
    occupied = cnt > 0
    bb = arch.birth.reshape(nb, B)[:, 0]
    old = occupied & (bb <= _i32(now, bb) - min_gap)
    iv = m.pt_valid[:B].to(torch.float32)
    icent = (m.points[:B] * iv[:, None]).sum(0) / torch.clamp(iv.sum(), min=1.0)
    d2 = ((cent[:, None] - cent[None]) ** 2).sum(-1)                     # (nb, nb)
    # c may mark b redundant unless b is OLD and c is not.
    allow = occupied[None, :] & ~(old[:, None] & ~old[None, :])
    eye = torch.eye(nb, dtype=d2.dtype, device=d2.device)
    d2 = torch.where(allow, d2, big) + eye * big
    d_in = ((cent - icent) ** 2).sum(-1)
    d_in = torch.where((iv.sum() > 0) & ~old, d_in, big)
    novelty = torch.minimum(d2.amin(dim=1), d_in)
    # Fill empty blocks first (index order = FIFO during the fill);
    # otherwise exact lexicographic (min novelty, youngest among ties).
    first_empty = torch.argmax((~occupied).to(torch.int32))
    m0 = torch.where(occupied, novelty, big).amin()
    tie = occupied & (novelty <= m0 * (1.0 + 1e-6) + 1e-30)
    youngest_tie = torch.argmax(torch.where(tie, bb, -(2 ** 30)))
    return torch.where((~occupied).any(), first_empty, youngest_tie).to(torch.int32)


# ---------------------------------------------------------------------------
# Loop proposal and the device-side loop buffer
# ---------------------------------------------------------------------------


class ArchiveLoop(NamedTuple):
    rvec: torch.Tensor       # (3,) absolute world->cam PnP pose
    tvec: torch.Tensor       # (3,)
    n_inliers: torch.Tensor  # () gates acceptance
    birth: torch.Tensor      # () int32 median birth frame of the inlier landmarks


def propose_archive_loop(
    generator: torch.Generator | None,
    feats: Features,
    arch: LandmarkArchive,
    frame_i,
    K: torch.Tensor,
    min_gap: int = 8,
    threshold: float = 3.0,
    sample_idx=None,
) -> ArchiveLoop:
    """PnP the current frame against archived landmarks born >= ``min_gap``
    frames ago; ``frame_i`` may be a Python int or a 0-d tensor (no host
    read). The RANSAC draws with ``generator`` or takes ``sample_idx``
    (``models/matching._sample_indices``).

    ``birth`` (median birth frame of the PnP inliers) is the loop's anchor
    node: archived positions carry the trajectory error accumulated up to
    their BIRTH frame, so an edge (birth -> frame_i) cancels that common
    error to first order.
    """
    old = arch.valid & (arch.birth <= frame_i - min_gap)
    match = match_descriptors(feats.descriptors, arch.desc, feats.keypoints.valid, old)
    uv = torch.stack([feats.keypoints.x, feats.keypoints.y], -1)
    mask = match.valid & old[match.idx2]
    cam, inl, n = ransac_pnp(generator, arch.positions[match.idx2], uv, mask, K,
                             threshold=threshold, sample_idx=sample_idx)
    births = arch.birth[match.idx2]
    # Median inlier birth: sort invalids to +inf, take the middle one (a (1,)
    # index: a 0-d one would be read on the host).
    keep = inl & mask
    cnt = torch.clamp(keep.sum(), min=1)
    b_sorted = torch.sort(torch.where(keep, births, 2 ** 30)).values
    mid = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, births.shape[0] - 1)
    birth = torch.where(keep.any(), b_sorted[mid.view(1)][0], 0)
    return ArchiveLoop(rvec=cam.rvec, tvec=cam.tvec, n_inliers=n.to(torch.int32),
                       birth=birth.to(torch.int32))


class LoopBuffer(NamedTuple):
    """Device-side accepted-loop accumulator.

    Acceptance (inlier threshold + cooldown + capacity) is computed on the
    device and accepted constraints land in this fixed-capacity buffer; the
    host reads it back ONCE at the end of a run. ``n_dropped`` counts
    would-be-accepted proposals lost to a full buffer, so saturation is
    logged instead of silently dropping closures.
    """

    rvecs: torch.Tensor      # (cap, 3) accepted PnP poses
    tvecs: torch.Tensor      # (cap, 3)
    frames: torch.Tensor     # (cap,) int32 global frame ids
    inliers: torch.Tensor    # (cap,) int32
    births: torch.Tensor     # (cap,) int32 anchor node per loop
    count: torch.Tensor      # () int32 accepted so far
    last_loop: torch.Tensor  # () int32 frame id of the last acceptance (cooldown)
    n_dropped: torch.Tensor  # () int32 accepted-quality proposals dropped


def empty_loop_buffer(capacity: int, device=None) -> LoopBuffer:
    """An empty buffer on ``device`` (None means the card, and raises
    without one)."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return LoopBuffer(
        rvecs=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        tvecs=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        frames=torch.zeros(capacity, **i32),
        inliers=torch.zeros(capacity, **i32),
        births=torch.zeros(capacity, **i32),
        count=torch.zeros((), **i32),
        last_loop=torch.full((), -(2 ** 30), **i32),
        n_dropped=torch.zeros((), **i32),
    )


def accept_loop_proposal(buf: LoopBuffer, prop: ArchiveLoop, frame_i, min_inliers: int,
                         cooldown: int) -> LoopBuffer:
    """Masked device-side acceptance: no host read, fixed shapes."""
    cap = buf.frames.shape[0]
    fi = _i32(frame_i, buf.frames)
    good = (prop.n_inliers >= min_inliers) & (fi - buf.last_loop > cooldown)
    ok = good & (buf.count < cap)
    idx = torch.clamp(buf.count, max=cap - 1).long().view(1)

    def put(arr, val):
        cur = arr[idx]
        return arr.index_copy(0, idx, torch.where(ok, val.to(arr.dtype).expand_as(cur), cur))

    return LoopBuffer(
        rvecs=put(buf.rvecs, prop.rvec),
        tvecs=put(buf.tvecs, prop.tvec),
        frames=put(buf.frames, fi),
        inliers=put(buf.inliers, prop.n_inliers),
        births=put(buf.births, prop.birth),
        count=buf.count + ok.to(torch.int32),
        last_loop=torch.where(ok, fi, buf.last_loop),
        n_dropped=buf.n_dropped + (good & ~ok).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# Sim(3) drift helpers (tested studies in the JAX package: run_odometry
# corrects at the end of a run, through correct_trajectory)
# ---------------------------------------------------------------------------


class Sim3(NamedTuple):
    """World similarity X_arch = s * (r @ X_win) + t (drift correction
    mapping the window's drifted frame onto the archive's world frame)."""

    s: torch.Tensor        # () scale
    r: torch.Tensor        # (3, 3)
    t: torch.Tensor        # (3,)
    n_pairs: torch.Tensor  # () int32 trimmed landmark pairs


def _umeyama(src, dst, w):
    """Weighted similarity fit dst ~ s * r @ src + t."""
    sw = torch.clamp(w.sum(), min=1e-9)
    mu_s = (src * w[:, None]).sum(0) / sw
    mu_d = (dst * w[:, None]).sum(0) / sw
    xs, xd = src - mu_s, dst - mu_d
    cov = (xd * w[:, None]).T @ xs / sw
    u, d, vt = torch.linalg.svd(cov)
    sgn = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn])
    r = (u * diag[None, :]) @ vt
    var_s = ((xs * xs).sum(-1) * w).sum() / sw
    s = (d * diag).sum() / torch.clamp(var_s, min=1e-12)
    return s, r, mu_d - s * (r @ mu_s)


@f32_precision
def landmark_sim3(m: SfmMap, arch: LandmarkArchive, frame_i, min_gap: int = 8,
                  trim_factor: float = 3.0) -> Sim3:
    """Sim(3) drift estimate from landmark-to-landmark correspondences.

    The window's CURRENT landmark positions and the archive's FROZEN
    positions of the same physical points (matched by descriptor) differ by
    the accumulated drift, scale included. A weighted Umeyama fit over the
    matched pairs, trimmed once at ``trim_factor`` x rms, recovers the
    similarity. (Uses an SVD: eager only, not inside the captured step.)
    """
    old = arch.valid & (arch.birth <= frame_i - min_gap)
    match = match_descriptors(m.pt_desc, arch.desc, m.pt_valid, old)
    src = m.points
    dst = arch.positions[match.idx2]
    w = (match.valid & old[match.idx2]).to(torch.float32)
    s1, r1, t1 = _umeyama(src, dst, w)
    resid = torch.linalg.vector_norm(s1 * src @ r1.T + t1 - dst, dim=-1)
    rms = torch.sqrt((resid ** 2 * w).sum() / torch.clamp(w.sum(), min=1e-9))
    w2 = w * (resid <= trim_factor * rms + 1e-9)
    s2, r2, t2 = _umeyama(src, dst, w2)
    return Sim3(s=s2, r=r2, t=t2, n_pairs=w2.sum().to(torch.int32))


def pnp_sim3(m: SfmMap, slot: int, rvec_p: torch.Tensor, tvec_p: torch.Tensor) -> Sim3:
    """SE(3) fallback correction (scale 1) aligning window camera ``slot``
    to its archive-PnP pose: r = R_p^T R_s, t = R_p^T (t_s - t_p)."""
    rs = rodrigues(m.rvecs[slot])
    rp = rodrigues(rvec_p)
    return Sim3(s=torch.ones((), device=rs.device), r=rp.T @ rs,
                t=rp.T @ (m.tvecs[slot] - tvec_p),
                n_pairs=torch.zeros((), dtype=torch.int32, device=rs.device))


@f32_precision
def apply_sim3_poses(rvecs: torch.Tensor, tvecs: torch.Tensor,
                     g: Sim3) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the drift correction to a stack of world->cam poses:
    R' = R r^T, t' = s t - R' @ t_g."""
    r_new = rodrigues(rvecs) @ g.r.T
    t_new = g.s * tvecs - (r_new @ g.t[:, None])[..., 0]
    return rotation_log(r_new), t_new


@f32_precision
def apply_sim3_map(m: SfmMap, g: Sim3) -> SfmMap:
    """Apply the drift correction to every window camera and landmark
    (X' = s (r X) + t). Reprojections are invariant (R'X' + t' = s (RX + t),
    and projection is homogeneous), so the map stays self-consistent."""
    rv, tv = apply_sim3_poses(m.rvecs, m.tvecs, g)
    return m._replace(rvecs=rv, tvecs=tv, points=g.s * (m.points @ g.r.T) + g.t)


# ---------------------------------------------------------------------------
# Window-map operations
# ---------------------------------------------------------------------------


def _shift(arr: torch.Tensor, k: int) -> torch.Tensor:
    """``arr`` moved down ``k`` rows, the freed tail zeroed."""
    return torch.cat([arr[k:], torch.zeros_like(arr[:k])])


def shift_window(m: SfmMap, pts_per_frame: int) -> SfmMap:
    """Evict frame slot 0: shift every per-frame block down one slot.

    Cameras shift by 1, point blocks by B, observation blocks by 3*B
    (``register_frame``'s static block layout). Observation camera and point
    indices are decremented; rows that now reference the evicted camera
    (cam_idx < 0) or an evicted landmark block (pt_idx < 0) are invalidated.
    """
    B = pts_per_frame
    obs = m.obs
    cam_idx = obs.cam_idx - 1
    pt_idx = obs.pt_idx - B
    valid = obs.valid & (cam_idx >= 0) & (pt_idx >= 0)
    obs = Observations(
        cam_idx=_shift(torch.clamp(cam_idx, min=0), 3 * B),
        pt_idx=_shift(torch.clamp(pt_idx, min=0), 3 * B),
        uv=_shift(obs.uv, 3 * B),
        valid=_shift(valid, 3 * B),
    )
    return SfmMap(
        rvecs=_shift(m.rvecs, 1),
        tvecs=_shift(m.tvecs, 1),
        cam_valid=_shift(m.cam_valid, 1),
        points=_shift(m.points, B),
        pt_valid=_shift(m.pt_valid, B),
        pt_desc=_shift(m.pt_desc, B),
        obs=obs,
    )


def harvest_anchors(m: SfmMap, anchors: Anchors, pts_per_frame: int,
                    per_eviction: int = 128) -> Anchors:
    """Called just BEFORE :func:`shift_window`: turn the departing landmark
    block's surviving observations into fixed-landmark factors.

    Rows of ``m.obs`` that reference the evicted block (pt_idx < B) from
    cameras that survive the shift would be invalidated by the shift,
    discarding the constraints that tie the remaining window to the geometry
    it just left. Here they become :class:`~models.ba.Anchors` against the
    landmarks' frozen world positions. Up to ``per_eviction`` candidates are
    kept per eviction (valid first, then the LATEST camera first: later
    cameras survive the most future evictions); existing anchors shift down
    one camera slot and expire when their camera leaves; the merge compacts
    valid-first (stable) into the fixed capacity.
    """
    B = pts_per_frame
    A = anchors.valid.shape[0]
    obs = m.obs
    W = m.rvecs.shape[0]
    pt = obs.pt_idx.long()
    # cam_idx >= 2: after the shift the camera must land on slot >= 1 (slot 0
    # is gauge-fixed in the window BA, so an anchor there constrains nothing).
    new_valid = obs.valid & (obs.pt_idx < B) & (obs.cam_idx >= 2) & m.pt_valid[pt]
    cand = Anchors(cam_idx=torch.clamp(obs.cam_idx - 1, min=0), xyz=m.points[pt], uv=obs.uv,
                   valid=new_valid)
    # Rank: valid first, then latest camera first; stable for obs order.
    key_new = torch.where(new_valid, W - cand.cam_idx, 10_000)
    sel = torch.argsort(key_new, stable=True)[:per_eviction]
    cand = Anchors(*(a[sel] for a in cand))
    old_cam = anchors.cam_idx - 1
    old = anchors._replace(cam_idx=torch.clamp(old_cam, min=0),
                           valid=anchors.valid & (old_cam >= 1))
    merged = Anchors(*(torch.cat([a, b]) for a, b in zip(old, cand)))
    order = torch.argsort((~merged.valid).to(torch.uint8), stable=True)[:A]
    return Anchors(*(a[order] for a in merged))


# ---------------------------------------------------------------------------
# The steady step
# ---------------------------------------------------------------------------


class OdometryCarry(NamedTuple):
    """What the steady step carries from frame to frame (``anc``, ``arch``
    and ``buf`` are None where marginalization or loop closure is off)."""

    m: SfmMap
    used: torch.Tensor
    anc: Anchors | None
    arch: LandmarkArchive | None
    buf: LoopBuffer | None


def uniform_draws(u: torch.Tensor) -> Callable:
    """A ``sample_idx`` callable (``models/matching._sample_indices``) that
    maps the uniforms ``u`` (>= n_hyp * n_pts of them, in [0, 1)) onto the
    valid slots: the inverse of their cumulative count, so every valid slot
    is equally likely and repeats are allowed, as in a multinomial draw.
    With no valid slot every slot is drawn from. No host read."""

    def draw(valid, n_hyp, n_pts):
        w = valid.to(torch.float32) + (~valid.any()).to(torch.float32)
        cdf = torch.cumsum(w, 0)
        idx = torch.searchsorted(cdf, u[: n_hyp * n_pts] * cdf[-1], right=True)
        return torch.clamp(idx, max=valid.shape[0] - 1).view(n_hyp, n_pts)

    return draw


def make_steady_step(
    K: torch.Tensor,
    *,
    window: int,
    pts_per_frame: int,
    ba_iters: int,
    ba_kwargs: dict,
    marginalize: bool,
    loop_closure: bool,
    loop_min_gap: int = 8,
    loop_min_inliers: int = 25,
    loop_cooldown: int = 3,
    archive_policy: str = "fifo",
):
    """The steady-state frame step (frame i >= window), the JAX package's
    ``lax.scan`` body:

        step(carry, i, feats_i, feats_prev, draws, do_ba, do_loop)
            -> (carry, (frozen rvec, frozen tvec))

    ``i`` is the global frame index as a 0-d int32 tensor on the device;
    ``draws(kind)`` gives the ``sample_idx`` of the registration ("pnp") and
    loop ("loop") PnPs. The JAX package's two ``lax.cond``s are Python bools
    here, known on the host from the frame index: ``do_ba`` (window BA, on
    frames i % ba_every == 0 and the last) and ``do_loop`` (the loop
    proposal, on i > window). The op sequence is the JAX step's: eviction
    (archive write under the configured policy), anchor harvest, shift,
    register at slot W-1, window BA, loop propose + accept. It returns the
    evicted slot-0 pose: the frozen trajectory. Every op keeps its shape and
    reads nothing back on the host, so the step can be captured as a CUDA
    graph (:class:`SteadyStepRunner`).
    """
    W, B = window, pts_per_frame

    def step(carry: OdometryCarry, i, feats_i, feats_p, draws, do_ba: bool, do_loop: bool):
        m, used, anc, arch, buf = carry
        frozen = (m.rvecs[0].clone(), m.tvecs[0].clone())
        if loop_closure:
            birth = i - W
            wslot = (coverage_write_slot(arch, m, birth, loop_min_gap, B, now_frame=i)
                     if archive_policy == "coverage" else birth)
            arch = archive_evicted_block(arch, m, wslot, birth, B)
        if marginalize:
            anc = harvest_anchors(m, anc, B, per_eviction=B)
        m = shift_window(m, B)
        m, used = register_frame(None, m, feats_i, feats_p, W - 1, K, used, B,
                                 sample_idx=draws("pnp"))
        if do_ba:
            st = bundle_adjust(m.ba_state(), m.obs, K, n_iters=ba_iters, anchors=anc,
                               **ba_kwargs)
            m = m._replace(rvecs=st.rvecs, tvecs=st.tvecs, points=st.points)
        if loop_closure and do_loop:
            prop = propose_archive_loop(None, feats_i, arch, i, K, min_gap=loop_min_gap,
                                        sample_idx=draws("loop"))
            buf = accept_loop_proposal(buf, prop, i, loop_min_inliers, loop_cooldown)
        return OdometryCarry(m, used, anc, arch, buf), frozen

    return step


def _stack_features(features: Sequence[Features]) -> Features:
    return Features(Keypoints(*(torch.stack(f) for f in zip(*(x.keypoints for x in features)))),
                    torch.stack([x.descriptors for x in features]))


def _frame_of(stacked: Features, idx: torch.Tensor) -> Features:
    """Frame ``idx`` (a (1,) device index) of stacked features: a gather on
    the device, so it can be captured."""
    pick = lambda a: a.index_select(0, idx)[0]
    return Features(Keypoints(*map(pick, stacked.keypoints)), pick(stacked.descriptors))


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a (nested) named tuple, None fields skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree for t in _tensors(v)]


def _clone(tree):
    """A copy of a (nested) named tuple of tensors, None fields kept."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.clone()
    return type(tree)(*map(_clone, tree))


class SteadyStepRunner:
    """Runs the steady step on static buffers, captured as CUDA graphs.

    The carry lives in this object's tensors (``carry``): the window map,
    ``used``, the anchors, the archive and the loop buffer. Each frame's
    inputs are static too: the frame index ``i`` (0-d int32), the uniforms
    ``u`` (2, PNP_DRAWS) for the two PnPs, and a two-slot ring of feature
    buffers shaped as ``ring`` (one frame's Features: every frame keeps its
    capacity). Frame ``i`` sits in slot ``i % 2`` and its predecessor in
    ``(i - 1) % 2``, both indexed on the device from ``i``; :meth:`feed`
    fills a slot outside the graph. The evicted slot-0 pose goes into the
    static (3,) pair ``frozen_r``, ``frozen_t``.

    The body reads the carry, computes the next one and copies it back in
    place, so one graph per variant serves every frame.

    With ``graph`` (on a CUDA device), the first frame of each variant
    (do_ba, do_loop) runs the body eagerly on a side stream, which warms up
    the libraries' handles and workspaces; the second captures it into a
    graph with its own memory pool, and every later frame of that variant
    replays it. At most four graphs. An op that cannot be captured raises:
    there is no quiet fallback to the eager step. Without ``graph`` every
    frame runs the same body eagerly (the CPU tests and the ``sampler`` path).
    """

    def __init__(self, step, carry: OdometryCarry, graph: bool, ring: Features):
        dev = carry.used.device
        if graph and dev.type != "cuda":
            raise ValueError("graph=True needs the run on a CUDA device")
        self.step, self.carry, self.graph = step, carry, graph
        self.ring = _stack_features([ring, ring])
        self.frozen_r = torch.zeros(3, dtype=torch.float32, device=dev)
        self.frozen_t = torch.zeros_like(self.frozen_r)
        self.i = torch.zeros((), dtype=torch.int32, device=dev)
        self.u = torch.zeros((2, PNP_DRAWS), dtype=torch.float32, device=dev)
        self.graphs: dict[tuple[bool, bool], torch.cuda.CUDAGraph] = {}
        self.warm: set[tuple[bool, bool]] = set()
        self.replays = 0

    def feed(self, i: int, feats: Features) -> None:
        """Copy frame ``i``'s features into ring slot ``i % 2`` (outside any
        graph; device to device, no host read). Frame ``i``'s step reads
        this slot and the one frame ``i - 1`` was fed into."""
        slot = i % 2
        for dst, src in zip(_tensors(self.ring), _tensors(feats)):
            if dst.shape[1:] != src.shape:
                raise ValueError(f"features of shape {tuple(src.shape)} fed to a ring of "
                                 f"{tuple(dst.shape[1:])}: every frame keeps the capacity of "
                                 "the first")
            dst[slot].copy_(src)

    def _uniform(self, kind: str):
        return uniform_draws(self.u[0 if kind == "pnp" else 1])

    def body(self, do_ba: bool, do_loop: bool, draws=None) -> None:
        """One steady frame on the static buffers (what a graph captures)."""
        idx = self.i.long().view(1)
        new, (fr, ft) = self.step(
            self.carry, self.i, _frame_of(self.ring, idx % 2), _frame_of(self.ring, (idx - 1) % 2),
            draws or self._uniform, do_ba, do_loop)
        self.frozen_r.copy_(fr)
        self.frozen_t.copy_(ft)
        for dst, src in zip(_tensors(self.carry), _tensors(new)):
            dst.copy_(src)

    def run(self, i: int, do_ba: bool, do_loop: bool, generator=None, sampler=None) -> None:
        """Frame ``i``: draws from ``generator`` (outside any graph) or
        ``sampler(kind, i, valid, n_hyp, n_pts)``, then the step."""
        self.i.fill_(i)
        if sampler is not None:
            if self.graph:
                raise ValueError("a sampler is a host callback: it runs with graph=False")
            self.body(do_ba, do_loop, lambda kind: _draws(None, sampler, kind, i))
            return
        self.u.uniform_(generator=generator)
        if not self.graph:
            self.body(do_ba, do_loop)
            return
        key = (do_ba, do_loop)
        g = self.graphs.get(key)
        if g is None and key not in self.warm:
            side = torch.cuda.Stream(self.u.device)
            side.wait_stream(torch.cuda.current_stream(self.u.device))
            with torch.cuda.stream(side):
                self.body(do_ba, do_loop)
            torch.cuda.current_stream(self.u.device).wait_stream(side)
            self.warm.add(key)
            return
        if g is None:
            g = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(g):
                    self.body(do_ba, do_loop)
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing the steady step (do_ba={do_ba}, do_loop={do_loop}) as a CUDA graph "
                    "failed: an op in it reads the card on the host, copies from the host or "
                    "draws from a generator, which a capture refuses; run_odometry(graph=False) "
                    "runs the step eagerly") from e
            self.graphs[key] = g
        g.replay()
        self.replays += 1


# ---------------------------------------------------------------------------
# run_odometry
# ---------------------------------------------------------------------------


def _window_ba_kwargs(W: int, B: int, solver: str, damping: float, huber_delta) -> dict:
    """The window BA's solver keywords ("auto" resolved from the window's
    capacities, ``models/ba.resolve_solver``)."""
    solver = resolve_solver(W, W * B, solver)
    kw: dict = dict(damping=damping, huber_delta=huber_delta, solver=solver)
    if solver == "cg":
        # A window landmark sees at most every window frame (2 birth obs +
        # one PnP re-observation per remaining frame).
        kw["max_obs_per_point"] = -(-W // 8) * 8
    return kw


def _check_archive(policy: str, size: int, B: int) -> None:
    if policy not in ("fifo", "coverage"):
        raise ValueError(f"archive_policy must be 'fifo' or 'coverage', got {policy!r}")
    if policy == "coverage" and size % B != 0:
        raise ValueError("archive_policy='coverage' needs archive_size to be a multiple of "
                         f"pts_per_frame ({B}); got {size}")


def _drain_loop_buffer(buf: LoopBuffer, max_loops: int):
    """ONE host read of the device-side loop buffer: (loop frames, their
    ArchiveLoops, closures dropped), with a warning if it saturated."""
    host = LoopBuffer(*(t.cpu() for t in buf))
    cnt, n_dropped = int(host.count), int(host.n_dropped)
    frames = [int(f) for f in host.frames[:cnt]]
    poses = [ArchiveLoop(rvec=buf.rvecs[k], tvec=buf.tvecs[k], n_inliers=host.inliers[k],
                         birth=host.births[k]) for k in range(cnt)]
    if n_dropped > 0:
        logging.getLogger(__name__).warning(
            "loop buffer saturated: %d accepted-quality closures dropped (max_loops=%d); "
            "raise max_loops for this sequence length", n_dropped, max_loops)
    return frames, poses, n_dropped


def _draws(generator, sampler, kind: str, frame: int):
    """The ``sample_idx`` of one eager RANSAC: ``sampler`` bound to (kind,
    frame), else uniforms from ``generator`` (:func:`uniform_draws`)."""
    if sampler is not None:
        return lambda valid, nh, npts: sampler(kind, frame, valid, nh, npts)

    def draw(valid, nh, npts):
        u = torch.rand(nh * npts, generator=generator, device=valid.device)
        return uniform_draws(u)(valid, nh, npts)

    return draw


def run_odometry(
    generator: torch.Generator | None,
    features: Sequence[Features],
    K: torch.Tensor,
    window: int = 8,
    pts_per_frame: int = 128,
    ba_every: int = 2,
    ba_iters: int = 8,
    damping: float = 1e-4,
    huber_delta: float | None = 2.0,
    solver: str = "auto",
    loop_closure: bool = False,
    loop_min_gap: int | None = None,
    loop_min_inliers: int = 25,
    loop_weight: float = 4.0,
    loop_cooldown: int = 3,
    max_loops: int | None = None,
    archive_size: int | None = None,
    archive_policy: str = "fifo",
    pgo_iters: int = 15,
    return_info: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    marginalize: bool = True,
    sampler=None,
    graph: bool | None = None,
):
    """Constant-memory odometry over a frame sequence of ANY length, on the
    device of ``K`` and the features.

    Returns the full (n, 3) + (n, 3) :class:`Trajectory` and the final window
    map (capacities depend only on ``window`` and ``pts_per_frame``), and
    with ``return_info`` a dict: ``loop_frames``, ``loop_inliers``,
    ``loops_dropped`` (and ``graph_replays``, the frames that replayed a
    captured step). Poses of evicted frames are frozen at eviction; frames
    still in the window carry the last window-BA refinement.

    ``marginalize`` keeps evicted-landmark observations alive as
    fixed-landmark anchor factors in the window BA (:func:`harvest_anchors`).
    ``solver`` picks the window-BA Schur solver ("auto" resolves from the
    window capacities, ``models/ba.resolve_solver``).

    ``loop_closure`` freezes evicted landmark blocks into a
    :class:`LandmarkArchive` ring of ``archive_size`` slots (default 64
    eviction blocks), PnP-matches every frame past the window against it
    (:func:`propose_archive_loop`), accepts on the device
    (:class:`LoopBuffer`, read once at the end) and corrects the whole
    trajectory with one pose-graph optimization (:func:`correct_trajectory`:
    Sim(3), chain + Woodbury above the dense limit). ``loop_min_gap``
    defaults to ``window + 1``; ``loop_cooldown`` suppresses acceptances for
    that many frames after one; ``max_loops`` (the buffer's capacity)
    defaults to the structural acceptance bound of this sequence; pass it to
    pin the capacity (a checkpointed run resumed and extended past its
    original length needs that). ``archive_policy``: "fifo" (overwrite by
    age) or "coverage" (:func:`coverage_write_slot`).

    With ``checkpoint_dir`` the resumable state (window map, used mask,
    frozen poses, archive, loop buffer, anchors) is saved every
    ``checkpoint_every`` frames and the run RESUMES from the latest
    checkpoint; the fingerprint refuses a checkpoint written under other
    capacities and deliberately excludes the frame count.

    RANSAC draws come from ``generator`` (on the run's device) or from
    ``sampler(kind, frame, valid, n_hypotheses, n_points) -> indices`` with
    kind "init" (frame 0), "pnp" or "loop": how a test feeds run_odometry the
    JAX package's draws. ``graph`` runs the steady step as CUDA graphs
    (:class:`SteadyStepRunner`); None means True on a CUDA device without a
    sampler, else False.

    The frames go one by one through an :class:`OdometryStream`. What the
    known length adds: ``max_loops`` from ``n``, the last frame's window BA
    inside its own step, and checkpoints.
    """
    n = len(features)
    W, B = window, pts_per_frame
    if loop_closure:
        if max_loops is None:
            # Proposals start at frame W + 1 and the cooldown admits at most
            # one acceptance per loop_cooldown + 1 frames.
            max_loops = max(8, (n - W) // (loop_cooldown + 1) + 1)
        if archive_size is None:
            archive_size = 64 * B
    stream = OdometryStream(
        generator, K, window=W, pts_per_frame=B, ba_every=ba_every, ba_iters=ba_iters,
        damping=damping, huber_delta=huber_delta, solver=solver, loop_closure=loop_closure,
        loop_min_gap=loop_min_gap, loop_min_inliers=loop_min_inliers, loop_weight=loop_weight,
        loop_cooldown=loop_cooldown, max_loops=max_loops, archive_size=archive_size,
        archive_policy=archive_policy, pgo_iters=pgo_iters, marginalize=marginalize,
        sampler=sampler, graph=graph)
    stream._final = n - 1
    # The JAX package's run_odometry corrects at correct_trajectory's own
    # damping, its OdometryStream at the BA's.
    del stream._correct_kw["damping"]

    # --- checkpoint / resume (as run_sfm; utils/checkpoint) ---------------
    start = 0
    if checkpoint_dir is not None:
        from sift_parallel_optimization_tpu_torch.utils import checkpoint as ckpt

        ckpt_meta = {
            "window": W,
            "pts_per_frame": B,
            "loop_closure": bool(loop_closure),
            "archive_size": int(archive_size or 0),
            "desc_capacity": int(features[0].descriptors.shape[0]),
            # Anchor capacity changes the state AND the BA trajectory.
            "anchors": (W - 1) * B if marginalize else 0,
        }
        if loop_closure:
            # The overwrite policy changes which blocks survive, hence the
            # trajectory.
            ckpt_meta["archive_policy"] = archive_policy
            ckpt_meta["max_loops"] = int(max_loops)

        def _state(carry: OdometryCarry, frozen_r: list, frozen_t: list) -> dict:
            # The frozen-pose count is a function of the step, so the
            # restore template is exact without fingerprinting n.
            state = {"m": carry.m, "used": carry.used}
            if frozen_r:
                state["frozen_r"] = torch.stack(frozen_r)
                state["frozen_t"] = torch.stack(frozen_t)
            for name in ("arch", "buf", "anc"):
                if getattr(carry, name) is not None:
                    state[name] = getattr(carry, name)
            return state

        step0 = ckpt.latest_step(checkpoint_dir)
        if step0 is not None:
            used = torch.zeros(features[0].keypoints.valid.shape[0], dtype=torch.bool,
                               device=K.device)
            zeros = [torch.zeros(3, dtype=torch.float32, device=K.device)] * max(0, step0 - W + 1)
            like = _state(stream._carry._replace(used=used), zeros, zeros)
            state, step0 = ckpt.load_pytree(checkpoint_dir, like, meta=ckpt_meta,
                                            meta_defaults={"archive_policy": "fifo"})
            carry = OdometryCarry(state["m"], state["used"], state.get("anc"),
                                  state.get("arch"), state.get("buf"))
            stream._resume(step0 + 1, carry, state.get("frozen_r"), state.get("frozen_t"),
                           features[step0])
            start = step0 + 1

    for i in range(start, n):
        stream.push(features[i])
        if checkpoint_dir is not None and checkpoint_every > 0 and i >= 2 \
                and i % checkpoint_every == 0:
            ckpt.save_pytree(checkpoint_dir,
                             _state(stream._live, stream._frozen_r, stream._frozen_t),
                             step=i, meta=ckpt_meta)
    traj, m, info = stream.finish()
    if return_info:
        return traj, m, info
    return traj, m


class OdometryStream:
    """ONLINE (frame-at-a-time) odometry for serving pipelines: the state
    machine of :func:`run_odometry` behind a ``push`` API (port of the JAX
    package's ``OdometryStream``; ``run_odometry`` drives one).

    Usage::

        stream = OdometryStream(gen, K, window=8, loop_closure=True)
        for feats in source:
            r, t = stream.push(feats)      # newest pose estimate, on the device
        traj, m, info = stream.finish()    # corrected full trajectory

    ``push`` runs frame 0 held (pose zeros), frame 1 bootstraps the map
    (``init_two_view``), frames 2..W-1 register (a window BA on ``i %
    ba_every == 0``), and every later frame runs the steady step on a
    :class:`SteadyStepRunner` fed frame by frame (``do_ba = i % ba_every ==
    0``, ``do_loop = loop_closure and i > W``), as CUDA graphs on the card
    (``graph`` None: on for CUDA without a ``sampler``). Draws come from
    ``generator`` in run_odometry's order, so a streamed sequence gives
    run_odometry's trajectory on the same features. A steady push reads
    nothing back on the host and returns a CLONE of the newest pose: the
    runner's buffers are overwritten by the next frame. Every frame keeps
    the feature capacity of the first; another capacity raises.

    ``finish`` is run_odometry's tail: one eager window BA if the last
    frame ran none (``run_odometry`` knows its length and runs that BA inside
    the last frame's step), ONE host read of the loop buffer (a warning if it
    saturated), and the pose-graph correction (:func:`correct_trajectory`).
    The stream length is unknown, so ``max_loops`` is a fixed 64 (the buffer
    holds ~52 bytes a slot).

    ``sampler(kind, frame, valid, n_hyp, n_pts)`` replaces the generator
    (kinds "init", "pnp", "loop"; how a test feeds the JAX package's draws)
    and forces ``graph=False``. The device is ``K``'s.
    """

    def __init__(
        self,
        generator: torch.Generator | None,
        K: torch.Tensor,
        window: int = 8,
        pts_per_frame: int = 128,
        ba_every: int = 2,
        ba_iters: int = 8,
        damping: float = 1e-4,
        huber_delta: float | None = 2.0,
        solver: str = "auto",
        loop_closure: bool = False,
        loop_min_gap: int | None = None,
        loop_min_inliers: int = 25,
        loop_weight: float = 4.0,
        loop_cooldown: int = 3,
        max_loops: int = 64,
        archive_size: int | None = None,
        archive_policy: str = "fifo",
        pgo_iters: int = 15,
        marginalize: bool = True,
        sampler=None,
        graph: bool | None = None,
    ):
        W, B = window, pts_per_frame
        if W < 3:
            raise ValueError("window must be >= 3 (bootstrap pair + PnP frame)")
        if generator is None and sampler is None:
            raise ValueError("odometry needs a torch.Generator or a sampler")
        dev = K.device
        if graph is None:
            graph = dev.type == "cuda" and sampler is None
        if graph and sampler is not None:
            raise ValueError("a sampler is a host callback: it runs with graph=False")
        if graph and dev.type != "cuda":
            raise ValueError("graph=True needs the stream on a CUDA device")
        self._gen, self._sampler, self._K, self._W, self._B = generator, sampler, K, W, B
        self._ba_every, self._ba_iters, self._graph = ba_every, ba_iters, graph
        self._loop_closure, self._max_loops = loop_closure, max_loops
        self._correct_kw = dict(loop_weight=loop_weight, pgo_iters=pgo_iters, damping=damping)
        self._ba_kwargs = _window_ba_kwargs(W, B, solver, damping, huber_delta)
        if loop_closure:
            if loop_min_gap is None:
                loop_min_gap = W + 1
            if archive_size is None:
                archive_size = 64 * B
            _check_archive(archive_policy, archive_size, B)
        self._carry = OdometryCarry(
            m=empty_map(W, B, max_loops=0, device=dev), used=None,
            anc=empty_anchors((W - 1) * B, device=dev) if marginalize else None,
            arch=empty_archive(archive_size, device=dev) if loop_closure else None,
            buf=empty_loop_buffer(max_loops, device=dev) if loop_closure else None)
        self._step = make_steady_step(
            K, window=W, pts_per_frame=B, ba_iters=ba_iters, ba_kwargs=self._ba_kwargs,
            marginalize=marginalize, loop_closure=loop_closure, loop_min_gap=loop_min_gap or 0,
            loop_min_inliers=loop_min_inliers, loop_cooldown=loop_cooldown,
            archive_policy=archive_policy)
        self._runner: SteadyStepRunner | None = None
        self._i = 0
        self._first: Features | None = None
        self._prev: Features | None = None
        self._shape: tuple | None = None
        self._frozen_r: list[torch.Tensor] = []
        self._frozen_t: list[torch.Tensor] = []
        self._last_ba_i = -1
        # The last frame's index where the length is known (run_odometry):
        # that frame runs its window BA in its own step and finish adds none.
        self._final: int | None = None

    @property
    def frames(self) -> int:
        """Frames pushed so far."""
        return self._i

    @property
    def runner(self) -> SteadyStepRunner | None:
        """The steady step's runner (None before frame W)."""
        return self._runner

    @property
    def _live(self) -> OdometryCarry:
        """The carry as of the last push (the runner's from frame W on)."""
        return self._carry if self._runner is None else self._runner.carry

    def variant(self, i: int) -> tuple[bool, bool]:
        """(do_ba, do_loop) of frame ``i`` (for a steady frame: the graph it
        replays)."""
        do_ba = bool(self._ba_every) and (i % self._ba_every == 0 or i == self._final)
        return do_ba, self._loop_closure and i > self._W

    def _draws(self, kind: str, frame: int):
        return _draws(self._gen, self._sampler, kind, frame)

    def _ba(self, m: SfmMap, anc: Anchors | None) -> SfmMap:
        st = bundle_adjust(m.ba_state(), m.obs, self._K, n_iters=self._ba_iters, anchors=anc,
                           **self._ba_kwargs)
        return m._replace(rvecs=st.rvecs, tvecs=st.tvecs, points=st.points)

    def _resume(self, i: int, carry: OdometryCarry, frozen_r, frozen_t, prev: Features) -> None:
        """Go on at frame ``i`` from a checkpointed carry, the (i - W, 3)
        frozen poses (None before the window filled) and frame i - 1's
        features (run_odometry's resume)."""
        self._i, self._carry, self._prev = i, carry, prev
        self._shape = tuple(prev.descriptors.shape)
        self._frozen_r = [] if frozen_r is None else list(frozen_r.unbind(0))
        self._frozen_t = [] if frozen_t is None else list(frozen_t.unbind(0))

    def push(self, feats: Features) -> tuple[torch.Tensor, torch.Tensor]:
        """Feed one frame; returns its current (rvec, tvec) estimate as new
        tensors on the device (no host read)."""
        shape = tuple(feats.descriptors.shape)
        if self._shape is None:
            self._shape = shape
        elif shape != self._shape:
            raise ValueError(f"features of capacity {shape} pushed to a stream of {self._shape}: "
                             "every frame keeps the capacity of the first")
        i, W, B, K = self._i, self._W, self._B, self._K
        m = self._carry.m
        self._i = i + 1
        do_ba, do_loop = self.variant(i)
        if i == 0:
            self._first = feats
            zero = torch.zeros(3, dtype=torch.float32, device=K.device)
            return zero, zero.clone()
        if i == 1:
            m, used = init_two_view(None, self._first, feats, K, m, B,
                                    sample_idx=self._draws("init", 0))
            self._carry = self._carry._replace(m=m, used=used)
            self._first, self._prev = None, feats
            return m.rvecs[1].clone(), m.tvecs[1].clone()
        if i < W:
            m, used = register_frame(None, m, feats, self._prev, i, K, self._carry.used, B,
                                     sample_idx=self._draws("pnp", i))
            if do_ba:
                m = self._ba(m, self._carry.anc)
                self._last_ba_i = i
            self._carry = self._carry._replace(m=m, used=used)
            self._prev = feats
            return m.rvecs[i].clone(), m.tvecs[i].clone()
        if self._runner is None:
            # The runner owns copies of the carry (the static buffers a
            # graph reads and writes) and a two-slot ring of features.
            self._runner = SteadyStepRunner(self._step, _clone(self._carry), self._graph, feats)
            self._runner.feed(i - 1, self._prev)
            self._prev = None
        runner = self._runner
        runner.feed(i, feats)
        runner.run(i, do_ba, do_loop, generator=self._gen, sampler=self._sampler)
        self._frozen_r.append(runner.frozen_r.clone())
        self._frozen_t.append(runner.frozen_t.clone())
        if do_ba:
            self._last_ba_i = i
        m = runner.carry.m
        return m.rvecs[W - 1].clone(), m.tvecs[W - 1].clone()

    def finish(self):
        """run_odometry's tail: a final window BA if the last frame ran
        none, the loop buffer drained (one host read), the pose-graph
        correction. Returns (Trajectory, final window map, info): info has
        ``loop_frames``, ``loop_inliers``, ``loops_dropped`` and
        ``graph_replays``."""
        n = self._i
        carry = self._live
        m = carry.m
        if n >= 2 and self._final is None and self._ba_every and self._last_ba_i != n - 1:
            m = self._ba(m, carry.anc)
        loop_frames, loop_poses, n_dropped = (
            _drain_loop_buffer(carry.buf, self._max_loops) if self._loop_closure else ([], [], 0))
        in_window = min(n, self._W)
        rv, tv = m.rvecs[:in_window], m.tvecs[:in_window]
        if self._frozen_r:
            rv = torch.cat([torch.stack(self._frozen_r), rv])
            tv = torch.cat([torch.stack(self._frozen_t), tv])
        traj = Trajectory(rvecs=rv, tvecs=tv)
        if self._loop_closure and loop_frames:
            traj = correct_trajectory(traj, loop_frames, loop_poses, **self._correct_kw)
        info = {
            "loop_frames": loop_frames,
            "loop_inliers": [int(p.n_inliers) for p in loop_poses],
            "loops_dropped": n_dropped,
            "graph_replays": self._runner.replays if self._runner is not None else 0,
        }
        return traj, m, info


def correct_trajectory(
    traj: Trajectory,
    loop_frames: Sequence[int],
    loop_poses: Sequence[ArchiveLoop],
    loop_weight: float = 4.0,
    pgo_iters: int = 15,
    damping: float = 1e-4,
    sim3: bool = True,
) -> Trajectory:
    """Pose-graph-correct a frozen trajectory with absolute loop edges.

    Edges: the odometry chain (consecutive relative poses from the
    estimates) plus one edge per accepted loop, from the loop's median
    inlier birth frame (clamped to a genuine backward edge) to the loop
    frame, measured by the PnP pose composed with the source node's
    estimate (``models/loop_closure.build_pose_graph_edges``).

    ``sim3`` (default) optimizes over Sim(3): loop edges (j != i + 1) are
    METRIC, so the optimizer recovers the accumulated scale at the loop
    endpoint and distributes it along the chain's scale-prior rows
    (``models/pose_graph_sim3``). ``sim3=False`` keeps the SE(3) graph.
    Both take the exact chain + Woodbury solve above the dense limit (the
    off-chain count is host-known here) with length-aware damping.
    """
    from sift_parallel_optimization_tpu_torch.models.loop_closure import build_pose_graph_edges

    n = traj.rvecs.shape[0]
    sources = [min(max(int(getattr(p, "birth", 0)), 0), max(int(f) - 2, 0))
               for f, p in zip(loop_frames, loop_poses)]
    edges = build_pose_graph_edges(traj, n, list(loop_frames),
                                   [Camera(rvec=p.rvec, tvec=p.tvec) for p in loop_poses],
                                   loop_weight=loop_weight, loop_sources=sources)
    cap = max(len(loop_frames), 1)
    if sim3:
        from sift_parallel_optimization_tpu_torch.models import pose_graph_sim3 as ps

        metric = ((edges.j != edges.i + 1) & (edges.weight > 0)).to(torch.float32)
        s_edges = ps.Sim3Edges(i=edges.i, j=edges.j, rel_rvec=edges.rel_rvec,
                               rel_tvec=edges.rel_tvec, rel_log_s=torch.zeros_like(edges.weight),
                               weight=edges.weight, metric=metric)
        out = ps.optimize_sim3_graph(ps.se3_to_sim3_poses(traj.rvecs, traj.tvecs), s_edges,
                                     n_iters=pgo_iters, damping=ps.chain_damping(n, damping),
                                     offchain_cap=cap)
        rv, tv = ps.sim3_to_se3_poses(out)
        return Trajectory(rvecs=rv, tvecs=tv)
    from sift_parallel_optimization_tpu_torch.models import pose_graph as pg

    out = pg.optimize_pose_graph(pg.Poses(rvecs=traj.rvecs, tvecs=traj.tvecs), edges,
                                 n_iters=pgo_iters, damping=pg.chain_damping(n, damping),
                                 offchain_cap=cap)
    return Trajectory(rvecs=out.rvecs, tvecs=out.tvecs)
