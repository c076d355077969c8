"""Pose-graph optimization (PGO) on SE(3) (port of ``models/pose_graph.py``,
the dense solver).

Same shape as ``models/ba``: a fixed-capacity edge list with weights (0 =
invalid), autodiff per-edge Jacobians, per-node sums and a dense-block normal
system, damped Gauss-Newton with a static trip count.

Convention: poses are world->cam (R_i, t_i) as axis-angle + translation;
edge (i, j) measures the relative transform cam_i -> cam_j:
R_rel = R_j R_i^T, t_rel = t_j - R_rel t_i.

Ported: the dense solver, which "auto" takes up to ``PGO_DENSE_LIMIT`` nodes
(every graph the SfM driver builds). The matrix-free CG and the chain +
Woodbury solvers come with the odometry (ROADMAP.md); asking for them raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.utils.convert import tuple_from_numpy, tuple_to_numpy
from sift_parallel_optimization_tpu_torch.models.geometry import rodrigues, rotation_log
from sift_parallel_optimization_tpu_torch.utils.device import f32_precision


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity relative-pose constraint list."""

    i: torch.Tensor         # (E,) int32 source node
    j: torch.Tensor         # (E,) int32 target node
    rel_rvec: torch.Tensor  # (E, 3) measured relative rotation (axis-angle)
    rel_tvec: torch.Tensor  # (E, 3) measured relative translation
    weight: torch.Tensor    # (E,) f32 information weight (0 = invalid)


class Poses(NamedTuple):
    rvecs: torch.Tensor  # (N, 3)
    tvecs: torch.Tensor  # (N, 3)


def pose_graph_edges_from_numpy(arrays, device=None) -> PoseGraphEdges:
    """PoseGraphEdges from numpy arrays (``utils/convert.tuple_from_numpy``:
    e.g. the JAX package's edges). ``device`` None means the card, and raises
    without one."""
    return tuple_from_numpy(PoseGraphEdges, arrays, {"i": torch.int32, "j": torch.int32},
                            device)


def poses_from_numpy(arrays, device=None) -> Poses:
    """Poses from numpy arrays (same rules as :func:`pose_graph_edges_from_numpy`)."""
    return tuple_from_numpy(Poses, arrays, {}, device)


pose_graph_edges_to_numpy = poses_to_numpy = tuple_to_numpy


def relative_pose(ri, ti, rj, tj):
    """(rvec_rel, tvec_rel) of cam_i -> cam_j; leading axes broadcast."""
    Ri, Rj = rodrigues(ri), rodrigues(rj)
    R_rel = Rj @ Ri.transpose(-1, -2)
    t_rel = tj - (R_rel @ ti[..., None])[..., 0]
    return rotation_log(R_rel), t_rel


def _edge_residual(ri, ti, rj, tj, rel_r, rel_t):
    """(..., 6) residual: [log(R_meas^T R_rel); t_rel - t_meas]."""
    Ri, Rj = rodrigues(ri), rodrigues(rj)
    R_rel = Rj @ Ri.transpose(-1, -2)
    t_rel = tj - (R_rel @ ti[..., None])[..., 0]
    e_rot = rotation_log(rodrigues(rel_r).transpose(-1, -2) @ R_rel)
    return torch.cat([e_rot, t_rel - rel_t], dim=-1)


@f32_precision
def pgo_residuals(poses: Poses, edges: PoseGraphEdges) -> torch.Tensor:
    """(E, 6) weighted residuals (zero for invalid edges)."""
    i, j = edges.i.long(), edges.j.long()
    r = _edge_residual(poses.rvecs[i], poses.tvecs[i], poses.rvecs[j], poses.tvecs[j],
                       edges.rel_rvec, edges.rel_tvec)
    return r * torch.sqrt(torch.clamp(edges.weight, min=0.0))[:, None]


def pgo_rms(poses: Poses, edges: PoseGraphEdges) -> torch.Tensor:
    r = pgo_residuals(poses, edges)
    n = torch.clamp((edges.weight > 0).sum(), min=1)
    return torch.sqrt((r * r).sum() / n)


def _weighted_residual(theta, rel_r, rel_t, w):
    """One edge's weighted residual of its stacked (12,) node parameters,
    twice (the second as ``jacfwd``'s auxiliary output)."""
    r = _edge_residual(theta[:3], theta[3:6], theta[6:9], theta[9:], rel_r, rel_t) * \
        torch.sqrt(torch.clamp(w, min=0.0))
    return r, r


def _edge_jacobians(poses: Poses, edges: PoseGraphEdges):
    """Weighted, gauge-masked per-edge Jacobians and residuals.

    Returns ji (E, 6, 6) = d r_e / d pose_i, jj (E, 6, 6), r (E, 6), all
    scaled by sqrt(weight) and with node-0 blocks zeroed (gauge fixing). The
    Jacobians are forward-mode autodiff of the residual, as ``jax.jacfwd``
    in the JAX package: through ``rotation_log`` the tangent of its unchosen
    branch never reaches the output (``torch.where`` selects tangents), so
    a padded edge (i = j = 0, rel = 0, at exactly the identity) has finite
    -- zero -- Jacobians.
    """
    from torch.func import jacfwd, vmap

    i, j = edges.i.long(), edges.j.long()
    theta = torch.cat([poses.rvecs[i], poses.tvecs[i], poses.rvecs[j], poses.tvecs[j]], dim=-1)
    jac, r = vmap(jacfwd(_weighted_residual, has_aux=True))(
        theta, edges.rel_rvec, edges.rel_tvec, edges.weight)
    keep_i = (edges.i != 0)[:, None, None].to(jac.dtype)
    keep_j = (edges.j != 0)[:, None, None].to(jac.dtype)
    return jac[..., :6] * keep_i, jac[..., 6:] * keep_j, r


def _node_sum(values: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``segment_sum``: (E, ...) rows summed into (n, ...) by ``idx``."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add_(0, idx.long(), values)


@f32_precision
def assemble_pgo_blocks(poses: Poses, edges: PoseGraphEdges):
    """Normal-equation blocks (hdiag (N, 6, 6), cross (N, N, 6, 6), b (N, 6));
    summing over edge shards commutes, so a sum over shards of the returned
    tuple is the global system."""
    N = poses.rvecs.shape[0]
    ji, jj, r = _edge_jacobians(poses, edges)
    hii = _node_sum(ji.transpose(-1, -2) @ ji, edges.i, N)
    hjj = _node_sum(jj.transpose(-1, -2) @ jj, edges.j, N)
    jtr = lambda jac: (jac * r[..., None]).sum(-2)
    b = -(_node_sum(jtr(ji), edges.i, N) + _node_sum(jtr(jj), edges.j, N))
    w_ij = ji.transpose(-1, -2) @ jj                                   # (E, 6, 6)
    cross = _node_sum(w_ij.reshape(-1, 36), edges.i.long() * N + edges.j.long(), N * N)
    return hii + hjj, cross.reshape(N, N, 6, 6), b


@f32_precision
def solve_pgo(hdiag, cross, b, damping: float = 1e-3) -> torch.Tensor:
    """Dense solve of the (6N, 6N) system -> (N, 6) update."""
    N = hdiag.shape[0]
    h = cross + cross.permute(1, 0, 3, 2)
    nodes = torch.arange(N, device=h.device)
    h[nodes, nodes] += hdiag
    # Marquardt-scaled damping (see models/ba for the f32 rationale).
    d = torch.diagonal(h[nodes, nodes], dim1=-2, dim2=-1)
    h[nodes, nodes] += (damping * d + 1e-6)[..., None] * torch.eye(6, device=h.device)
    hd = h.permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    m0 = torch.ones(6 * N, dtype=hd.dtype, device=hd.device)
    m0[:6] = 0.0
    hd = hd * m0[:, None] * m0[None, :] + torch.diag(1.0 - m0)
    b = torch.cat([torch.zeros_like(b[:1]), b[1:]])
    x = torch.linalg.solve_ex(hd, b.reshape(-1, 1), check_errors=False).result
    return x.reshape(N, 6)


# N above which "auto" prefers a scalable solver: the dense cross block is
# N*N*36 f32 (9.4 MB at the threshold, growing quadratically) and the
# (6N, 6N) LU solve grows cubically.
PGO_DENSE_LIMIT = 256

_NOT_PORTED = ("the {!r} pose-graph solver is not ported yet: it comes with the odometry "
               "(ROADMAP.md, modules to port); use solver='dense' (at most {} nodes for "
               "'auto')")


def resolve_pgo_solver(n_nodes: int, solver: str = "auto", offchain_cap: int | None = None) -> str:
    """"auto" keeps the dense solve at small N; above the limit the JAX
    package takes the chain+Woodbury solve (with an off-chain cap) or
    matrix-free CG, which the port does not have yet: those raise."""
    if solver == "auto":
        if n_nodes <= PGO_DENSE_LIMIT:
            return "dense"
        solver = "chain" if offchain_cap is not None else "cg"
    if solver != "dense":
        raise NotImplementedError(_NOT_PORTED.format(solver, PGO_DENSE_LIMIT))
    return solver


@f32_precision
def pgo_step(poses: Poses, edges: PoseGraphEdges, damping: float = 1e-3,
             solver: str = "dense") -> Poses:
    resolve_pgo_solver(poses.rvecs.shape[0], solver)
    hdiag, cross, b = assemble_pgo_blocks(poses, edges)
    delta = solve_pgo(hdiag, cross, b, damping)
    return Poses(rvecs=poses.rvecs + delta[:, :3], tvecs=poses.tvecs + delta[:, 3:])


@f32_precision
def optimize_pose_graph(
    poses: Poses,
    edges: PoseGraphEdges,
    n_iters: int = 20,
    damping: float = 1e-3,
    solver: str = "auto",
    offchain_cap: int | None = None,
) -> Poses:
    """Damped Gauss-Newton PGO with a static trip count.

    ``solver``: "dense" materializes the (N, N, 6, 6) cross block and LU-
    solves the (6N, 6N) system; "auto" takes it up to ``PGO_DENSE_LIMIT``
    nodes. "chain" and "cg" (and "auto" above the limit) raise
    ``NotImplementedError`` until the odometry slice ports them.
    """
    solver = resolve_pgo_solver(poses.rvecs.shape[0], solver, offchain_cap)
    for _ in range(n_iters):
        poses = pgo_step(poses, edges, damping, solver=solver)
    return poses
