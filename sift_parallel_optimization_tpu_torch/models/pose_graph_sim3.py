"""Sim(3) pose-graph optimization: loop closure with per-node SCALE (port of
``models/pose_graph_sim3.py``).

Monocular odometry drifts in scale, and an SE(3) pose graph
(``models/pose_graph``) cannot absorb it: every chain edge's translation
LENGTH is fixed by its measurement, so absolute loop constraints fight the
chain instead of shrinking it. The classic fix (ORB-SLAM's essential-graph
optimization; Strasdat et al., "Scale Drift-Aware Large Scale Monocular
SLAM") is a pose graph over Sim(3): each node carries (R_i, t_i, log s_i),
chain edges measure relative similarities with s_meas = 1, and the optimizer
distributes the loop's scale discrepancy along the chain.

Convention: node i maps world -> cam by x = s_i * (R_i X) + t_i. The
relative similarity of edge (i, j) is

    R_ij = R_j R_i^T,  s_ij = s_j / s_i,
    t_ij = t_j - s_ij * R_ij t_i,

so a measured SE(3) odometry edge is (rel_rvec, rel_tvec, rel_log_s=0).

Measurement model: the edge constrains S_ij == S_meas with S_meas =
(exp(rel_log_s), R(rel_rvec), exp(rel_log_s) * rel_tvec): ``rel_tvec`` is in
node i's scale units and the measured ratio maps it into node j's. A METRIC
edge (an archive-PnP loop constraint, :class:`Sim3Edges`) compares the
de-scaled relative translation with the measurement instead, so the
optimizer itself recovers the accumulated scale at the loop endpoint and the
chain's soft scale-prior rows distribute it.

Same shape as the SE(3) graph: a fixed-capacity masked edge list, autodiff
per-edge Jacobians (7-dim blocks, ``torch.func.jacfwd`` under ``vmap``),
per-node sums, damped Gauss-Newton with a static trip count, node 0 gauge
fixed (pose AND scale: the monocular gauge freedom is a similarity). The
three solvers are the SE(3) module's block-size-generic ones with d = 7:
dense (7N, 7N), matrix-free CG (fixed trips masked by ``torch.where``) and
chain + Woodbury. Everything runs with TF32 off (``utils/device``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.models import pose_graph as pg
from sift_parallel_optimization_tpu_torch.models.geometry import rodrigues, rotation_log
from sift_parallel_optimization_tpu_torch.models.pose_graph import (
    ImplicitPgo as ImplicitSim3,
    pgo_matvec as sim3_matvec,
    pgo_pcg as sim3_pcg,
    relative_pose,
)
from sift_parallel_optimization_tpu_torch.utils.convert import tuple_from_numpy, tuple_to_numpy
from sift_parallel_optimization_tpu_torch.utils.device import f32_precision


class Sim3Poses(NamedTuple):
    rvecs: torch.Tensor   # (N, 3)
    tvecs: torch.Tensor   # (N, 3)
    log_s: torch.Tensor   # (N,)


class Sim3Edges(NamedTuple):
    """Fixed-capacity relative-similarity constraint list.

    ``metric`` marks edges whose rel_tvec is a METRIC measurement (an
    archive-PnP loop constraint): their translation row compares the
    DE-SCALED relative translation t_ij * exp(-(s_j - s_i)) with the
    measurement and their scale-prior row is dropped. Non-metric (odometry
    chain) edges, whose rel_tvec is in the drifted estimate's own units,
    keep the raw translation difference (mapped through exp(rel_log_s)) plus
    the soft scale prior (s_j - s_i) - rel_log_s.
    """

    i: torch.Tensor          # (E,) int32
    j: torch.Tensor          # (E,) int32
    rel_rvec: torch.Tensor   # (E, 3)
    rel_tvec: torch.Tensor   # (E, 3)
    rel_log_s: torch.Tensor  # (E,) measured log(s_j / s_i) (0 for odometry)
    weight: torch.Tensor     # (E,) f32 (0 = invalid slot)
    metric: torch.Tensor     # (E,) f32 1.0 = metric loop edge, 0.0 = chain


def sim3_edges_from_numpy(arrays, device=None) -> Sim3Edges:
    """Sim3Edges from numpy arrays (``utils/convert.tuple_from_numpy``: e.g.
    the JAX package's edges). ``device`` None means the card, and raises
    without one."""
    return tuple_from_numpy(Sim3Edges, arrays, {"i": torch.int32, "j": torch.int32}, device)


def sim3_poses_from_numpy(arrays, device=None) -> Sim3Poses:
    """Sim3Poses from numpy arrays (same rules as :func:`sim3_edges_from_numpy`)."""
    return tuple_from_numpy(Sim3Poses, arrays, {}, device)


sim3_edges_to_numpy = tuple_to_numpy


def se3_to_sim3_poses(rvecs: torch.Tensor, tvecs: torch.Tensor) -> Sim3Poses:
    return Sim3Poses(rvecs=rvecs, tvecs=tvecs,
                     log_s=torch.zeros(rvecs.shape[0], dtype=torch.float32, device=rvecs.device))


def sim3_to_se3_poses(p: Sim3Poses) -> tuple[torch.Tensor, torch.Tensor]:
    """Back to world->cam SE(3): x = s(RX) + t = s(RX + t/s), so the rigid
    pose is (R, t/s); the per-node scale is absorbed into the (now
    metrically consistent) trajectory."""
    return p.rvecs, p.tvecs / torch.exp(p.log_s)[:, None]


def _edge_residual(ri, ti, si, rj, tj, sj, rel_r, rel_t, rel_ls, metric):
    """(..., 7) residual; the rows depend on the edge's measurement frame.

    Chain (metric=0):  [log(R_m^T R_ij); t_ij - e^ls t_m; (sj-si) - ls]
    Metric (metric=1): [log(R_m^T R_ij); e^-(sj-si) t_ij - t_m; 0]
    """
    Ri, Rj = rodrigues(ri), rodrigues(rj)
    R_rel = Rj @ Ri.transpose(-1, -2)
    s_rel = torch.exp(sj - si)
    t_rel = tj - s_rel[..., None] * (R_rel @ ti[..., None])[..., 0]
    e_rot = rotation_log(rodrigues(rel_r).transpose(-1, -2) @ R_rel)
    e_t_chain = t_rel - torch.exp(rel_ls)[..., None] * rel_t
    e_t_metric = t_rel / s_rel[..., None] - rel_t
    keep = 1.0 - metric
    e_t = keep[..., None] * e_t_chain + metric[..., None] * e_t_metric
    e_s = keep * ((sj - si) - rel_ls)
    return torch.cat([e_rot, e_t, e_s[..., None]], dim=-1)


def measured_rel_log_s(
    rvecs: torch.Tensor,
    tvecs: torch.Tensor,
    i: torch.Tensor,
    j: torch.Tensor,
    rel_tvec: torch.Tensor,
    max_abs: float = 2.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Per-edge measured scale ratio log(s_j / s_i) from translation norms.

    The current (drifted) estimates' implied relative translation of edge
    (i, j) is scaled by the accumulated drift; a metric measurement (archive
    PnP) has the true length. Their log-ratio is the edge's measured
    rel_log_s; chain edges measured FROM the estimates give exactly 0.
    Near-zero norms give 0, and the result is clamped to +-``max_abs``.
    """
    i, j = i.long(), j.long()
    _rr, rt = relative_pose(rvecs[i], tvecs[i], rvecs[j], tvecs[j])
    n_est = torch.linalg.vector_norm(rt, dim=-1)
    n_meas = torch.linalg.vector_norm(rel_tvec, dim=-1)
    ok = (n_est > eps) & (n_meas > eps)
    ls = torch.log(torch.clamp(n_est, min=eps) / torch.clamp(n_meas, min=eps))
    return torch.where(ok, torch.clamp(ls, -max_abs, max_abs), 0.0)


def _gather(poses: Sim3Poses, edges: Sim3Edges):
    i, j = edges.i.long(), edges.j.long()
    return (poses.rvecs[i], poses.tvecs[i], poses.log_s[i],
            poses.rvecs[j], poses.tvecs[j], poses.log_s[j])


@f32_precision
def sim3_residuals(poses: Sim3Poses, edges: Sim3Edges) -> torch.Tensor:
    """(E, 7) weighted residuals (zero for invalid edges)."""
    r = _edge_residual(*_gather(poses, edges), edges.rel_rvec, edges.rel_tvec,
                       edges.rel_log_s, edges.metric)
    return r * torch.sqrt(torch.clamp(edges.weight, min=0.0))[:, None]


def sim3_rms(poses: Sim3Poses, edges: Sim3Edges) -> torch.Tensor:
    r = sim3_residuals(poses, edges)
    n = torch.clamp((edges.weight > 0).sum(), min=1)
    return torch.sqrt((r * r).sum() / n)


def _weighted_residual(theta, rel_r, rel_t, rel_ls, metric, w):
    """One edge's weighted residual of its stacked (14,) node parameters,
    twice (the second as ``jacfwd``'s auxiliary output)."""
    r = _edge_residual(theta[:3], theta[3:6], theta[6], theta[7:10], theta[10:13], theta[13],
                       rel_r, rel_t, rel_ls, metric) * torch.sqrt(torch.clamp(w, min=0.0))
    return r, r


def _edge_jacobians(poses: Sim3Poses, edges: Sim3Edges):
    """ji/jj (E, 7, 7) weighted, node-0 gauge-masked; r (E, 7)."""
    from torch.func import jacfwd, vmap

    ri, ti, si, rj, tj, sj = _gather(poses, edges)
    theta = torch.cat([ri, ti, si[:, None], rj, tj, sj[:, None]], dim=-1)
    jac, r = vmap(jacfwd(_weighted_residual, has_aux=True))(
        theta, edges.rel_rvec, edges.rel_tvec, edges.rel_log_s, edges.metric, edges.weight)
    keep_i = (edges.i != 0)[:, None, None].to(jac.dtype)
    keep_j = (edges.j != 0)[:, None, None].to(jac.dtype)
    return jac[..., :7] * keep_i, jac[..., 7:] * keep_j, r


@f32_precision
def _sim3_dense_delta(poses: Sim3Poses, edges: Sim3Edges, damping: float) -> torch.Tensor:
    """Dense (7N, 7N) solve -> (N, 7) update (node-0 gauge)."""
    ji, jj, r = _edge_jacobians(poses, edges)
    blocks = pg._normal_blocks(ji, jj, r, edges.i, edges.j, poses.rvecs.shape[0])
    return pg.solve_pgo(*blocks, damping)


@f32_precision
def assemble_sim3_implicit(poses: Sim3Poses, edges: Sim3Edges,
                           damping: float = 1e-3) -> ImplicitSim3:
    """Linearize for the matrix-free CG solve (no N x N block anywhere)."""
    ji, jj, r = _edge_jacobians(poses, edges)
    return pg._implicit_blocks(ji, jj, r, edges.i, edges.j, poses.rvecs.shape[0], damping)


def solve_sim3_cg(blk: ImplicitSim3, cg_iters: int = 100, cg_tol: float = 1e-8) -> torch.Tensor:
    """Block-Jacobi preconditioned CG -> (N, 7) update (matrix-free; the
    SE(3) module's :func:`~models.pose_graph.pgo_pcg` with 7-DOF blocks)."""
    return sim3_pcg(blk, cg_iters, cg_tol)[0]


# Chain solver. The graphs the loop-closure corrector sees are an odometry
# CHAIN (edge (i, i+1) for every i) plus a handful of loop edges. On such
# graphs preconditioned CG stalls: the loop discrepancy must diffuse along a
# 1-D chain whose Laplacian condition grows as N^2, so the global scale-ramp
# mode converges at ~N iterations whatever the block-Jacobi preconditioner.
# The chain part of H is block-tridiagonal, solvable in O(N) by block-Thomas
# elimination, and the L loop edges are a rank-7L correction by the Woodbury
# identity:
#
#   H = T + U^T U,   H^-1 b = T^-1 b - T^-1 U^T (I + U T^-1 U^T)^-1 U T^-1 b
#
# with U the (7L, 7N) stacked loop-edge Jacobian rows. One factorization per
# GN step solves 1 + 7L right-hand sides in the same two sweeps; the
# (7L, 7L) capacitance solve is dense but tiny. Exact (the dense solver's
# fixed point), O(N + L^2) memory, O(N L) time.


@f32_precision
def assemble_sim3_chain(poses: Sim3Poses, edges: Sim3Edges, damping: float = 1e-3,
                        offchain_cap: int = 32):
    """Split the edge list into the tridiagonal chain part + the low-rank
    rest (``models/pose_graph.chain_edge_split``). The caller must guarantee
    that the true off-chain edge count fits ``offchain_cap``:
    ``correct_trajectory`` passes the host-known accepted-loop count."""
    ji, jj, r = _edge_jacobians(poses, edges)
    return pg.chain_edge_split(ji, jj, r, edges, poses.rvecs.shape[0], damping, offchain_cap)


@f32_precision
def solve_sim3_chain(blk) -> torch.Tensor:
    """Exact (N, 7) update via block-Thomas + Woodbury loop correction."""
    return pg.chain_woodbury_delta(*blk)


# N above which "auto" prefers a scalable solver: the dense cross block is
# N*N*49 f32 (12.8 MB at the threshold, growing quadratically) and the
# (7N, 7N) LU solve grows cubically, while the chain solve stays O(N) and the
# CG matvec O(E).
SIM3_DENSE_LIMIT = 256


def chain_damping(n_nodes: int, damping: float) -> float:
    """Length-aware Marquardt damping (``models/pose_graph.chain_damping``
    with this module's limit)."""
    return pg.chain_damping(n_nodes, damping, SIM3_DENSE_LIMIT)


def resolve_sim3_solver(n_nodes: int, solver: str = "auto",
                        offchain_cap: int | None = None) -> str:
    """"auto" keeps the dense solve at small N; above the limit it takes the
    exact chain+Woodbury solve when the caller vouches for an off-chain edge
    cap (``offchain_cap``), else matrix-free CG."""
    if solver not in ("auto", "dense", "cg", "chain"):
        raise ValueError(f"solver must be 'auto', 'dense', 'cg' or 'chain', got {solver!r}")
    if solver != "auto":
        return solver
    if n_nodes <= SIM3_DENSE_LIMIT:
        return "dense"
    return "chain" if offchain_cap is not None else "cg"


@f32_precision
def sim3_step(
    poses: Sim3Poses,
    edges: Sim3Edges,
    damping: float = 1e-3,
    solver: str = "dense",
    cg_iters: int = 100,
    cg_tol: float = 1e-8,
    offchain_cap: int = 32,
) -> Sim3Poses:
    """One damped Gauss-Newton step (node-0 gauge; the solvers of
    :func:`optimize_sim3_graph`)."""
    solver = resolve_sim3_solver(poses.rvecs.shape[0], solver, offchain_cap)
    if solver == "cg":
        dx = solve_sim3_cg(assemble_sim3_implicit(poses, edges, damping), cg_iters, cg_tol)
    elif solver == "chain":
        dx = solve_sim3_chain(assemble_sim3_chain(poses, edges, damping, offchain_cap))
    else:
        dx = _sim3_dense_delta(poses, edges, damping)
    return Sim3Poses(rvecs=poses.rvecs + dx[:, :3], tvecs=poses.tvecs + dx[:, 3:6],
                     log_s=poses.log_s + dx[:, 6])


@f32_precision
def optimize_sim3_graph(
    poses: Sim3Poses,
    edges: Sim3Edges,
    n_iters: int = 15,
    damping: float = 1e-4,
    solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-8,
    offchain_cap: int | None = None,
) -> Sim3Poses:
    """Damped Gauss-Newton iterations (static trip count).

    ``solver``: "dense" materializes the (N, N, 7, 7) cross block and LU-
    solves the (7N, 7N) system (best at small N); "chain" is the exact O(N)
    block-tridiagonal + Woodbury solve for odometry-shaped graphs (chain + up
    to ``offchain_cap`` loop edges: what keeps the default
    ``correct_trajectory(sim3=True)`` O(n) on long sequences); "cg" is the
    matrix-free block-Jacobi-preconditioned CG (O(E) memory,
    structure-agnostic); "auto" picks by node count and cap availability
    (:func:`resolve_sim3_solver`).
    """
    solver = resolve_sim3_solver(poses.rvecs.shape[0], solver, offchain_cap)
    for _ in range(n_iters):
        poses = sim3_step(poses, edges, damping, solver=solver, cg_iters=cg_iters, cg_tol=cg_tol,
                          offchain_cap=32 if offchain_cap is None else offchain_cap)
    return poses
