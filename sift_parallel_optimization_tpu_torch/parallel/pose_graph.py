"""Distributed pose-graph optimization: edges sharded over a mesh axis (port
of ``parallel/pose_graph.py``).

The pattern of ``parallel/ba.py``'s dense step: every rank assembles the
normal-equation blocks of its block of edges, ONE all-reduce of all of them
gives the global system on every rank, and the (6N, 6N) solve runs
replicated (N, the keyframe count, is small next to the edge count).
"""

from __future__ import annotations

import torch

from sift_parallel_optimization_tpu_torch.models.pose_graph import (
    PoseGraphEdges,
    Poses,
    assemble_pgo_blocks,
    solve_pgo,
)
from sift_parallel_optimization_tpu_torch.parallel.mesh import (
    all_reduce_all,
    axis_index,
    axis_size,
    check_device,
)
from sift_parallel_optimization_tpu_torch.utils.device import f32_precision


def pad_edges(edges: PoseGraphEdges, multiple: int) -> PoseGraphEdges:
    """Pad the edge list to a multiple (padded edges join node 0 to itself
    with weight 0: inert)."""
    e = edges.i.shape[0]
    pad = -(-e // multiple) * multiple - e
    if pad == 0:
        return edges
    return PoseGraphEdges(*[torch.cat([f, f.new_zeros((pad, *f.shape[1:]))]) for f in edges])


@f32_precision
def distributed_pgo(
    poses: Poses,
    edges: PoseGraphEdges,
    mesh,
    n_iters: int = 20,
    damping: float = 1e-3,
    axis: str = "data",
) -> Poses:
    """Edge-sharded damped Gauss-Newton PGO with the dense solve: every rank
    passes the same poses and edges and gets the same poses back."""
    check_device(poses.rvecs, mesh)
    n = axis_size(mesh, axis)
    edges = pad_edges(edges, n)
    e = edges.i.shape[0] // n
    i = axis_index(mesh, axis)
    local = PoseGraphEdges(*[f[i * e:(i + 1) * e] for f in edges])
    for _ in range(n_iters):
        hdiag, cross, b = all_reduce_all(assemble_pgo_blocks(poses, local), mesh, axis)
        delta = solve_pgo(hdiag, cross, b, damping=damping)
        poses = Poses(rvecs=poses.rvecs + delta[:, :3], tvecs=poses.tvecs + delta[:, 3:])
    return poses
