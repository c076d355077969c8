"""Process groups and the (data, spatial) device mesh (port of
``parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` over every device and runs
``shard_map`` bodies on it from a single controller. The port is SPMD: one
process a rank, each running the body ``shard_map`` runs on one device, on
its own shard, with ``torch.distributed`` collectives over the mesh's axis
groups. Axis meanings are the JAX package's:

  * ``data``    -- a batch of frames, keyframes, observations or edges.
  * ``spatial`` -- image rows within a frame (the reference's OpenMP row
    split), or scale planes and octaves for the scale- and octave-sharded
    REFERENCE decompositions.

The backend follows the device: NCCL for the card, gloo for the CPU, and no
fallback from one to the other. The helpers below call their collective at
every axis size, 1 included, so a world-size-1 mesh on the card runs its
collectives through a real NCCL communicator.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sift_parallel_optimization_tpu_torch.utils.device import resolve_device

AXES = ("data", "spatial")
_RANK_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
    store: dist.Store | None = None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join (or form) the default process group; returns this rank's device.

    * ``coordinator_address`` ("host:port"), ``num_processes`` and
      ``process_id`` together: a TCP rendezvous; ``store`` with the last two:
      a rendezvous through that store (a ``FileStore`` in the tests).
    * None of them and a rank environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets them): ``env://``.
      A partial rank environment raises.
    * None of them and no rank environment: one process at world size 1.

    A failed initialization raises: the JAX package prints a warning and
    goes on single-process, which on a multi-host run computes on a partial
    mesh. ``device`` (None: the card) picks the backend (``backend_for``);
    on the card each rank takes card ``LOCAL_RANK`` (else rank modulo the
    card count). A no-op returning the rank's device if the default group
    exists already.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        return _rank_device(dev, dist.get_rank())
    timeout = datetime.timedelta(seconds=timeout_s)
    backend = backend_for(dev)
    explicit = (coordinator_address, num_processes, process_id)
    if store is not None:
        if num_processes is None or process_id is None or coordinator_address is not None:
            raise ValueError("a store rendezvous takes num_processes and process_id, "
                             "and no coordinator_address")
        kw = dict(store=store, world_size=num_processes, rank=process_id)
    elif any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("coordinator_address, num_processes and process_id go together")
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                  rank=process_id)
    else:
        present = [k for k in _RANK_ENV if os.environ.get(k)]
        if not present:
            kw = dict(store=dist.HashStore(), world_size=1, rank=0)
        elif len(present) < len(_RANK_ENV):
            missing = sorted(set(_RANK_ENV) - set(present))
            raise RuntimeError(f"incomplete rank environment: {', '.join(present)} set but "
                               f"{', '.join(missing)} unset")
        else:
            kw = dict(init_method="env://", world_size=int(os.environ["WORLD_SIZE"]),
                      rank=int(os.environ["RANK"]))
    dev = _rank_device(dev, kw["rank"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=timeout, **kw)
    return dev


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    if dev.type != "cuda":
        return dev
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local else rank % torch.cuda.device_count())


def make_mesh(n_data: int | None = None, n_spatial: int | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A (data, spatial) mesh over every rank of the default group. Defaults:
    every rank on ``spatial`` if ``n_data`` is None. ``device_type`` follows
    the default group's backend (``cuda`` under NCCL, ``cpu`` under gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    n = dist.get_world_size()
    if n_data is None and n_spatial is None:
        n_data, n_spatial = 1, n
    elif n_data is None:
        n_data = n // n_spatial
    elif n_spatial is None:
        n_spatial = n // n_data
    if n_data * n_spatial != n:
        raise ValueError(f"mesh {n_data}x{n_spatial} does not cover {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_spatial), mesh_dim_names=AXES)


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a (data, spatial) DeviceMesh, else a TypeError."""
    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != AXES:
        raise TypeError(f"expected a DeviceMesh with dims {AXES} (parallel.mesh.make_mesh), "
                        f"got {mesh!r}")
    return mesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return check_mesh(mesh).size(AXES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return check_mesh(mesh).get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return check_mesh(mesh).get_group(axis)


def axis_peer(mesh: DeviceMesh, axis: str, index: int) -> int:
    """Global rank of the rank at ``index`` along ``axis`` in this rank's line."""
    return dist.get_global_rank(axis_group(mesh, axis), index)


def spatial_size(mesh: DeviceMesh) -> int:
    return axis_size(mesh, "spatial")


def data_size(mesh: DeviceMesh) -> int:
    return axis_size(mesh, "data")


def row_sharding(mesh: DeviceMesh, batched: bool = False) -> list:
    """DTensor placements over (data, spatial) of an image (H, W) split by
    rows, or of (B, H, W) frames split by frame and by row."""
    from torch.distributed.tensor import Replicate, Shard

    check_mesh(mesh)
    return [Shard(0), Shard(1)] if batched else [Replicate(), Shard(0)]


def replicated(mesh: DeviceMesh) -> list:
    from torch.distributed.tensor import Replicate

    check_mesh(mesh)
    return [Replicate(), Replicate()]


def check_device(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``t`` if it lies on the mesh's device type: a CUDA tensor goes through
    NCCL only, never staged through the host by gloo, and a CPU tensor
    never reaches NCCL."""
    if t.device.type != check_mesh(mesh).device_type:
        raise ValueError(f"a {t.device.type} tensor on a {mesh.device_type} mesh: the backend "
                         f"follows the device (NCCL for cuda, gloo for cpu)")
    return t


def global_view(local: torch.Tensor, mesh: DeviceMesh, placements, shape=None):
    """The rank's shard as a DTensor (``full_tensor()`` gathers the global
    array); ``shape`` for an uneven split (torch.chunk sizes)."""
    from torch.distributed.tensor import DTensor

    if shape is None:
        return DTensor.from_local(local, mesh, placements, run_check=False)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=stride)


# ---------------------------------------------------------------------------
# Collectives on one axis (psum, psum_scatter, all_gather). Each runs at any
# axis size, 1 included.
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.psum``: the sum over ``axis`` (a new tensor)."""
    out = check_device(t, mesh).contiguous().clone()
    dist.all_reduce(out, group=axis_group(mesh, axis))
    return out


def all_reduce_all(tensors, mesh: DeviceMesh, axis: str) -> list[torch.Tensor]:
    """``lax.psum`` of several tensors as ONE all-reduce (flattened into one
    buffer, views of it returned)."""
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh, axis)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def reduce_scatter(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``: the sum
    over ``axis``, this rank's 1/n of dim 0."""
    n = axis_size(mesh, axis)
    check_device(t, mesh)
    if t.shape[0] % n:
        raise ValueError(f"dim 0 ({t.shape[0]}) does not split {n} ways")
    out = t.new_empty((t.shape[0] // n, *t.shape[1:]))
    dist.reduce_scatter_tensor(out, t.contiguous(), group=axis_group(mesh, axis))
    return out


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.all_gather(..., axis=0, tiled=True)``: the shards of ``axis``
    concatenated on dim 0, in axis order. Bool tensors travel as uint8."""
    n = axis_size(mesh, axis)
    src = check_device(t, mesh).contiguous()
    if src.dtype == torch.bool:
        return all_gather(src.to(torch.uint8), mesh, axis).to(torch.bool)
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=axis_group(mesh, axis))
    return out


def broadcast(t: torch.Tensor, mesh: DeviceMesh, axis: str, src_index: int) -> torch.Tensor:
    """``t`` of the rank at ``src_index`` along ``axis``, on every rank of
    the line (in place on the receivers' ``t``)."""
    check_device(t, mesh)
    dist.broadcast(t, src=axis_peer(mesh, axis, src_index), group=axis_group(mesh, axis))
    return t
