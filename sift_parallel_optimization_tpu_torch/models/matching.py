"""Descriptor matching + robust model fitting (RANSAC) (port of
``models/matching.py``).

* Brute-force matching is a matrix product: descriptors are L2-normalized so
  dist^2 = 2 - 2 * sim with sim = D1 @ D2^T -- one (K, 128) x (128, K) fp32
  ``torch.matmul``, then the top-2 per row for Lowe's ratio test and an
  argmax per column for the mutual-nearest check.
* RANSAC is BATCHED, not iterative: all N hypotheses are sampled, solved
  (batched 8x8 linear solves / small SVDs) and scored (an (N, K) distance
  matrix) in one shot; ``argmax`` picks the winner. Degenerate samples score
  -1 instead of being resampled -- static shapes, no host sync.

Randomness is explicit. Every RANSAC takes a ``torch.Generator`` (on the
device of the points) and draws uniformly among the valid slots, or takes
``sample_idx``, the (n_hypotheses, n_points) int64 indices themselves, which
is how a test feeds the port another implementation's draws. Neither given
raises: no function here reads the global random state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.core.pyramid_ref import check_fp32_matmul
from sift_parallel_optimization_tpu_torch.models.keypoints import Keypoints


class Matches(NamedTuple):
    """Row i: keypoint i of image 1 matched to ``idx2[i]`` of image 2."""

    idx2: torch.Tensor        # (K,) int64 index into image-2 keypoints
    similarity: torch.Tensor  # (K,) f32 cosine similarity of best match
    valid: torch.Tensor       # (K,) bool -- passed ratio + mutual-NN + validity

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)


def match_descriptors(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    ratio: float = 0.8,
    mutual: bool = True,
) -> Matches:
    """Ratio-test + mutual-NN matching of (K1, 128) x (K2, 128) descriptors.

    Lowe's ratio test on L2 distances d = sqrt(2 - 2 sim):
    d1 < ratio * d2  <=>  (2 - 2 s1) < ratio^2 * (2 - 2 s2).

    The best column is ``torch.argmax``, which returns the first index among
    ties as ``jnp.argmax`` does (the indices of ``torch.max(dim=)`` are not
    promised to); the second-best value is the maximum with that column
    masked, so a duplicated maximum is its own runner-up. A row with no
    valid column is -inf throughout: best 0, not valid.
    """
    check_fp32_matmul(desc1)
    neg_inf = torch.full((), -torch.inf, dtype=torch.float32, device=desc1.device)
    sim = desc1.to(torch.float32) @ desc2.to(torch.float32).T
    sim = torch.where(valid2[None, :], sim, neg_inf)
    s1 = sim.amax(dim=1)
    best = torch.argmax(sim, dim=1)
    cols = torch.arange(desc2.shape[0], device=desc1.device)
    s2 = torch.where(cols[None, :] == best[:, None], neg_inf, sim).amax(dim=1)

    d1_sq = 2.0 - 2.0 * s1
    d2_sq = 2.0 - 2.0 * s2
    ratio_ok = d1_sq < (ratio * ratio) * d2_sq

    ok = valid1 & ratio_ok & torch.isfinite(s1)
    if mutual:
        back = torch.argmax(torch.where(valid1[:, None], sim, neg_inf), dim=0)  # (K2,)
        ok = ok & (back[best] == torch.arange(desc1.shape[0], device=desc1.device))
    return Matches(idx2=best, similarity=s1, valid=ok)


def matched_points(
    kp1: Keypoints, kp2: Keypoints, m: Matches
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(K, 2) xy points in image 1 / image 2 and the pair-valid mask."""
    p1 = torch.stack([kp1.x, kp1.y], dim=-1)
    p2 = torch.stack([kp2.x[m.idx2], kp2.y[m.idx2]], dim=-1)
    return p1, p2, m.valid & kp2.valid[m.idx2]


# ---------------------------------------------------------------------------
# Batched RANSAC
# ---------------------------------------------------------------------------


def _sample_indices(
    generator: torch.Generator | None,
    valid: torch.Tensor,
    n_hyp: int,
    n_pts: int,
    sample_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """(n_hyp, n_pts) int64 indices drawn uniformly, with replacement, from
    the valid slots (repeats make a sample degenerate and it scores -1,
    which is fine), or ``sample_idx`` itself when given. ``sample_idx`` may
    also be a callable ``(valid, n_hyp, n_pts) -> indices``: a driver that
    computes the mask inside (``models/sfm.run_sfm``) takes another
    implementation's draws that way. With no valid slot every slot is drawn
    from instead (no host sync on the count): every hypothesis then scores
    zero inliers under the same mask."""
    if callable(sample_idx):
        sample_idx = torch.as_tensor(sample_idx(valid, n_hyp, n_pts))
    if sample_idx is not None:
        if tuple(sample_idx.shape) != (n_hyp, n_pts):
            raise ValueError(f"sample_idx must be ({n_hyp}, {n_pts}), got "
                             f"{tuple(sample_idx.shape)}")
        return sample_idx.to(device=valid.device, dtype=torch.int64)
    if generator is None:
        raise ValueError("RANSAC needs a torch.Generator or sample_idx")
    weights = valid.to(torch.float32)
    weights = weights + (~valid.any()).to(torch.float32)
    draws = torch.multinomial(weights, n_hyp * n_pts, replacement=True, generator=generator)
    return draws.view(n_hyp, n_pts)


def _normalize_points(p: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization of (..., N, 2) points under (..., N) weights:
    zero-mean, mean distance sqrt(2). Returns normalized points and the
    (..., 3, 3) transform T with p_n ~ T @ p_h."""
    wsum = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)            # (..., 1)
    mean = (p * mask[..., None]).sum(-2) / wsum                         # (..., 2)
    centred = p - mean[..., None, :]
    d = torch.sqrt((centred ** 2).sum(-1))
    scale = (2.0 ** 0.5) / torch.clamp((d * mask).sum(-1) / wsum[..., 0], min=1e-8)
    pn = centred * scale[..., None, None]
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], -1),
        torch.stack([zero, scale, -scale * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return pn, T


def _dlt_rows(p1: torch.Tensor, p2: torch.Tensor):
    """Homography DLT design (..., 2N, 8) matrix and (..., 2N) rhs with
    h33 = 1, shared by the minimal solver and the inlier refinement so both
    solve the SAME parameterization."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    return torch.cat([rows_u, rows_v], dim=-2), torch.cat([u, v], dim=-1)


def _solve(a: torch.Tensor, b: torch.Tensor):
    """Batched a x = b that never raises: ``torch.linalg.solve`` raises on a
    singular matrix (on the CPU, for the whole batch), and repeated points
    in a minimal sample make singular systems routinely. Returns (x, ok)
    with ok False where the factorization reported a singular matrix."""
    x, info = torch.linalg.solve_ex(a, b[..., None], check_errors=False)
    return x[..., 0], info == 0


def _homography_from_4(p1: torch.Tensor, p2: torch.Tensor):
    """(..., 4, 2) x (..., 4, 2) -> (..., 3, 3) homographies via DLT with
    h33 = 1 and the (...) mask of systems that were solved: a singular or
    non-finite one is scored -1 by the caller."""
    a, b = _dlt_rows(p1, p2)
    h, ok = _solve(a, b)
    h = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(*h.shape[:-1], 3, 3)
    return h, ok & torch.isfinite(h).all(dim=(-1, -2))


def _apply_h(h: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (K, 2) -> (..., K, 2) projective transform."""
    ph = torch.cat([p, torch.ones_like(p[:, :1])], dim=-1)
    q = ph @ h.transpose(-1, -2)
    w = q[..., 2:]
    return q[..., :2] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))


class RansacResult(NamedTuple):
    model: torch.Tensor      # (3, 3) homography or fundamental matrix
    inliers: torch.Tensor    # (K,) bool
    n_inliers: torch.Tensor  # () int64


def ransac_homography(
    generator: torch.Generator | None,
    p1: torch.Tensor,
    p2: torch.Tensor,
    mask: torch.Tensor,
    n_hypotheses: int = 256,
    threshold: float = 3.0,
    sample_idx: torch.Tensor | None = None,
) -> RansacResult:
    """Batched-hypothesis RANSAC homography p1 -> p2.

    All hypotheses solved and scored concurrently; inliers by FORWARD
    transfer error |H p1 - p2| (one-way -- cheap and sufficient for the
    verification/refinement loop; use a symmetric check downstream if the
    application needs it).
    """
    check_fp32_matmul(p1)
    idx = _sample_indices(generator, mask, n_hypotheses, 4, sample_idx)
    h, h_ok = _homography_from_4(p1[idx], p2[idx])                     # (N, 3, 3)
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device)
    h = torch.where(h_ok[:, None, None], h, eye)

    err = ((_apply_h(h, p1) - p2) ** 2).sum(-1)                        # (N, K)
    inl = (err < threshold * threshold) & mask
    score = torch.where(h_ok, inl.sum(-1), -1)
    best = torch.argmax(score)
    h_best = _refine_homography(p1, p2, inl[best].to(torch.float32))
    # Re-score with the refined model (inlier set can only be cleaner).
    err_r = ((_apply_h(h_best, p1) - p2) ** 2).sum(-1)
    inl_r = (err_r < threshold * threshold) & mask
    return RansacResult(model=h_best, inliers=inl_r, n_inliers=inl_r.sum())


def _refine_homography(p1, p2, w: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares DLT (h33 = 1) over all points with weights w."""
    a, b = _dlt_rows(p1, p2)
    ww = torch.cat([w, w], dim=0)
    ata = a.T @ (a * ww[:, None]) + 1e-6 * torch.eye(8, dtype=a.dtype, device=a.device)
    atb = a.T @ (ww * b)
    h, _ok = _solve(ata, atb)
    return torch.cat([h, torch.ones_like(h[:1])]).reshape(3, 3)


def _fundamental_from_8(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., 8+, 2) correspondences -> (..., 3, 3) rank-2 fundamental
    matrices via the 8-point algorithm: the null vector of the design matrix
    is its last right singular vector, then the smallest singular value of
    F is zeroed."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x)
    a = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], dim=-1)
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    f = vt[..., -1, :].reshape(*vt.shape[:-2], 3, 3)
    uf, sf, vft = torch.linalg.svd(f)
    sf = torch.cat([sf[..., :2], torch.zeros_like(sf[..., 2:])], dim=-1)
    return (uf * sf[..., None, :]) @ vft


def _epipolar_dist_sq(f: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Sampson distance squared of (K, 2) correspondences under (..., 3, 3)
    F -> (..., K)."""
    ph1 = torch.cat([p1, torch.ones_like(p1[:, :1])], -1)  # (K, 3)
    ph2 = torch.cat([p2, torch.ones_like(p2[:, :1])], -1)
    fx1 = ph1 @ f.transpose(-1, -2)   # (..., K, 3) = F p1
    ftx2 = ph2 @ f                    # (..., K, 3) = F^T p2
    num = (ph2 * fx1).sum(-1) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def ransac_fundamental(
    generator: torch.Generator | None,
    p1: torch.Tensor,
    p2: torch.Tensor,
    mask: torch.Tensor,
    n_hypotheses: int = 256,
    threshold: float = 1.5,
    sample_idx: torch.Tensor | None = None,
) -> RansacResult:
    """Batched 8-point RANSAC fundamental matrix with Sampson scoring.

    Points are Hartley-normalized PER HYPOTHESIS SAMPLE (the textbook
    8-point protocol -- each minimal sample's own mean/spread conditions
    its DLT system, so clustered degenerate samples stay well scaled);
    each hypothesis is de-normalized with its own transforms before
    pixel-space scoring.
    """
    check_fp32_matmul(p1)
    idx = _sample_indices(generator, mask, n_hypotheses, 8, sample_idx)
    ones = torch.ones((n_hypotheses, 8), dtype=p1.dtype, device=p1.device)
    qn1, t1 = _normalize_points(p1[idx], ones)
    qn2, t2 = _normalize_points(p2[idx], ones)
    # De-normalize: p2n^T F p1n = p2^T (T2^T F T1) p1.
    f_px = t2.transpose(-1, -2) @ _fundamental_from_8(qn1, qn2) @ t1   # (N, 3, 3)
    f_ok = torch.isfinite(f_px).all(dim=(-1, -2))
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device)
    f_px = torch.where(f_ok[:, None, None], f_px, eye)

    # Score in PIXEL coordinates: Sampson distance mixes gradients from
    # both images, so a single normalized-frame threshold is wrong when
    # the two point sets have different spreads.
    err = _epipolar_dist_sq(f_px, p1, p2)                              # (N, K)
    inl = (err < threshold * threshold) & mask
    score = torch.where(f_ok, inl.sum(-1), -1)
    best = torch.argmax(score)
    f_best = f_px[best]
    nrm = torch.linalg.matrix_norm(f_best)
    f_best = f_best / torch.where(nrm > 1e-12, nrm, torch.ones_like(nrm))
    # When every hypothesis was non-finite, score[best] is the -1 sentinel
    # and the "model" is a normalized identity: clamp the count to 0 and
    # zero the inlier mask so downstream gating rejects everything.
    any_ok = score[best] >= 0
    return RansacResult(
        model=f_best,
        inliers=inl[best] & any_ok,
        n_inliers=torch.clamp(score[best], min=0),
    )
