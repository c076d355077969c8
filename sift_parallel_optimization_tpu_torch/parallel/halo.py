"""Halo exchange for row-sharded stencils (port of ``parallel/halo.py``).

The reference streamed finished rows to a collector with MPI_Send/Recv
(mpitest.cpp:58-77); its elementwise window needs no neighbour rows. The
true-convolution path (SIFT mode) does. The JAX package moves the strips
with ``lax.ppermute`` inside ``shard_map``; here each rank posts
point-to-point sends and receives to its two neighbours along the axis
(``dist.batch_isend_irecv``) and the caller waits on them after its
halo-independent work, so the transfer runs underneath it.

Only real neighbours exchange: the edge shards synthesize their outer strip
by replicating their border row (the JAX package's permutation is a ring and
then overwrites the wrapped strips), and at axis size 1 nothing moves.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sift_parallel_optimization_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_peer,
    axis_size,
    check_device,
)

# Tags tell the two directions apart on gloo (NCCL matches by order, and a
# pair of ranks exchanges one strip each way).
_DOWN, _UP = 1, 2


class HaloExchange:
    """Strips in flight: :meth:`wait` returns (from_up, from_down)."""

    def __init__(self, works, from_up: torch.Tensor, from_down: torch.Tensor):
        self._works = works
        self._strips = (from_up, from_down)

    def wait(self) -> tuple[torch.Tensor, torch.Tensor]:
        for w in self._works:
            w.wait()
        self._works = []
        return self._strips


def start_neighbor_rows(x: torch.Tensor, halo: int, mesh, axis: str = "spatial") -> HaloExchange:
    """Post the exchange of the ``halo``-row neighbour strips of a row-sharded
    block (..., h, W): the rows arriving from the shard above (its bottom
    rows) and below (its top rows), replicate-edge at the global border."""
    n = axis_size(mesh, axis)
    i = axis_index(mesh, axis)
    check_device(x, mesh)
    top = x[..., :halo, :].contiguous()
    bot = x[..., -halo:, :].contiguous()
    edge_top = x[..., :1, :].expand_as(top).contiguous()
    edge_bot = x[..., -1:, :].expand_as(bot).contiguous()
    from_up = edge_top if i == 0 else torch.empty_like(top)
    from_down = edge_bot if i == n - 1 else torch.empty_like(bot)
    group = axis_group(mesh, axis)
    ops = []
    if i > 0:       # my top rows up; the strip from above in
        up = axis_peer(mesh, axis, i - 1)
        ops += [dist.P2POp(dist.isend, top, up, group, tag=_UP),
                dist.P2POp(dist.irecv, from_up, up, group, tag=_DOWN)]
    if i < n - 1:   # my bottom rows down; the strip from below in
        down = axis_peer(mesh, axis, i + 1)
        ops += [dist.P2POp(dist.isend, bot, down, group, tag=_DOWN),
                dist.P2POp(dist.irecv, from_down, down, group, tag=_UP)]
    works = dist.batch_isend_irecv(ops) if ops else []
    return HaloExchange(works, from_up, from_down)


def neighbor_rows(x: torch.Tensor, halo: int, mesh,
                  axis: str = "spatial") -> tuple[torch.Tensor, torch.Tensor]:
    """(from_up, from_down) strips of ``x``, each (..., halo, W), waited for.
    Use :func:`start_neighbor_rows` where the wait should come after other
    work."""
    return start_neighbor_rows(x, halo, mesh, axis).wait()


def exchange_rows(x: torch.Tensor, halo: int, mesh, axis: str = "spatial") -> torch.Tensor:
    """(..., h + 2 * halo, W): ``x`` padded with ``halo`` rows from each
    neighbour along ``axis``; edge shards replicate their border rows (the
    'edge' padding of the unsharded blur)."""
    from_up, from_down = neighbor_rows(x, halo, mesh, axis)
    return torch.cat([from_up, x, from_down], dim=-2)
