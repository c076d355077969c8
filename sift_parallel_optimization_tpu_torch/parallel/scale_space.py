"""Sharded scale-space computation (port of ``parallel/scale_space.py``).

The reference split one scale-space stencil three ways: by rows (OpenMP),
by scale (MPI rank-per-scale with a collector rank, pthread scale split) and
by octave (pthread round-robin) (GaussDePyramid-MPI.h:265-335,
GaussDePyramid-pThread.h:176-342, mpitest.cpp:35-113). The JAX package turns
each split into a ``shard_map`` over the (data, spatial) mesh; here each rank
runs that body on its own shard (``parallel/mesh.py``):

  * REFERENCE mode, row-sharded: the window is elementwise, so a rank needs
    only its rows of the filter bank; no halo, no collector.
  * REFERENCE mode, scale-sharded: a rank owns a block of scale planes; the
    DoG's dependency on the next scale moves one plane between neighbours.
  * REFERENCE mode, octave-sharded: octaves are independent subsamples of
    the original image, so a rank computes its own octaves at their true
    sizes and the owner broadcasts each. The JAX package pads every octave
    into an (N, N) buffer and halves it in a masked loop because one SPMD
    program serves every device; a rank here runs its own Python and needs
    neither.
  * SIFT mode: the row-sharded true convolution, as band-matrix products
    over halo-extended rows (the halo posted first, waited for after the
    halo-independent bulk), down to the octave where the rows no longer
    split; the tail runs unsharded.

The REFERENCE paths are plain tensor code on each shard, as in JAX (kernel 1
computes the unsharded pyramid); each is bitwise equal to the unsharded
plain version. Functions named ``sharded_*`` that return a function take and
give the rank's local shard (the ``shard_map`` body); the pyramid functions
take the global image, which every rank holds, and return DTensors
(``full_tensor()`` is the global octave).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from sift_parallel_optimization_tpu_torch.config import PyramidConfig
from sift_parallel_optimization_tpu_torch.core.pyramid_ref import (
    _blur_stack,
    _octave_scale_sigmas,
    _taps_np,
    blur_bank,
    check_fp32_matmul,
    clamp_octaves,
    reference_dog_octave,
    reference_filter_bank,
    reference_subsample,
)
from sift_parallel_optimization_tpu_torch.parallel.halo import start_neighbor_rows
from sift_parallel_optimization_tpu_torch.parallel.mesh import (
    all_gather,
    axis_group,
    axis_index,
    axis_peer,
    axis_size,
    broadcast,
    global_view,
    replicated,
)

# ---------------------------------------------------------------------------
# REFERENCE mode, row-sharded (embarrassingly parallel).
# ---------------------------------------------------------------------------


def _local_window_dog(local: torch.Tensor, n_scales: int, global_size: int,
                      row0: int) -> torch.Tensor:
    """(h, N) rows from ``row0`` of an octave base -> (n_scales, h, N): the
    unsharded window DoG's rows, element for element."""
    f = reference_filter_bank(global_size, n_scales, dtype=local.dtype, device=local.device)
    frow = f[:, row0:row0 + local.shape[0]]
    windows = frow[:, :, None] * f[:, None, :]
    w_all = torch.cat([windows[:-1] - windows[1:], windows[-1:]], dim=0)
    return local[None] * w_all


def sharded_reference_dog_octave(mesh, S: int, size: int):
    """fn: this rank's (size / n, size) rows of an octave base -> its
    (S+3, size / n, size) rows of the octave (row-sharded on ``spatial``)."""
    n = axis_size(mesh, "spatial")
    if size % n:
        raise ValueError(f"{size} rows do not split {n} ways")
    row0 = axis_index(mesh, "spatial") * (size // n)
    return lambda local: _local_window_dog(local, S + 3, size, row0)


def _shardable(size: int, n_shards: int, min_rows: int = 8) -> bool:
    return size % n_shards == 0 and size // n_shards >= min_rows


def sharded_reference_dog_pyramid(img: torch.Tensor, S: int, mesh,
                                  n_octaves: int | None = None) -> list:
    """REFERENCE pyramid with the octaves that split evenly into at least 8
    rows a rank row-sharded on ``spatial``; the small tail runs unsharded on
    every rank. Returns one DTensor per octave, (S+3, size_o, size_o)."""
    img = img.to(torch.float32)
    n = axis_size(mesh, "spatial")
    out = []
    for o in range(clamp_octaves(img.shape[0], n_octaves)):
        base = reference_subsample(img, o)
        size = base.shape[0]
        if _shardable(size, n):
            h = size // n
            rows = base[axis_index(mesh, "spatial") * h:][:h]
            local = sharded_reference_dog_octave(mesh, S, size)(rows)
            out.append(global_view(local, mesh, [Replicate(), Shard(1)]))
        else:
            out.append(global_view(reference_dog_octave(base, S), mesh, replicated(mesh)))
    return out


# ---------------------------------------------------------------------------
# REFERENCE mode, scale-sharded: the reference's rank-per-scale layout. A
# rank owns k = ceil((S+3) / n) consecutive scale planes (the last ranks'
# blocks padded, as torch.chunk splits); DoG plane s needs window s+1, so
# each rank receives the first window plane of the next rank's block: one
# (N, N) plane a boundary, in place of the reference's collector. Moving the
# window plane (and not the Gaussian plane g = base * W, as the JAX package
# does) keeps the DoG as base * (W_s - W_{s+1}), the unsharded expression,
# bit for bit.
# ---------------------------------------------------------------------------


def scale_sharded_reference_dog_octave(mesh, S: int, size: int, axis: str = "spatial"):
    """fn(base (size, size), every rank) -> DTensor (S+3, size, size) with
    the scale planes sharded on ``axis``."""
    n_scales = S + 3
    n = axis_size(mesh, axis)
    i = axis_index(mesh, axis)
    k = -(-n_scales // n)

    def run(base: torch.Tensor):
        f = reference_filter_bank(size, n_scales, dtype=base.dtype, device=base.device)
        f = torch.cat([f, f.new_zeros((n * k - n_scales, size))])[i * k:(i + 1) * k]
        windows = f[:, :, None] * f[:, None, :]                 # (k, N, N)
        nxt = torch.zeros_like(windows[:1])
        group, ops = axis_group(mesh, axis), []
        if i > 0:
            ops.append(dist.P2POp(dist.isend, windows[:1].contiguous(),
                                  axis_peer(mesh, axis, i - 1), group))
        if i < n - 1:
            ops.append(dist.P2POp(dist.irecv, nxt, axis_peer(mesh, axis, i + 1), group))
        for w in (dist.batch_isend_irecv(ops) if ops else []):
            w.wait()
        w_ext = torch.cat([windows, nxt])
        keep = (i * k + torch.arange(k, device=base.device)) == n_scales - 1
        w_all = torch.where(keep[:, None, None], windows, w_ext[:-1] - w_ext[1:])
        real = max(0, min(k, n_scales - i * k))
        return global_view((base[None] * w_all)[:real], mesh, [Replicate(), Shard(0)],
                           shape=(n_scales, size, size))

    return run


# ---------------------------------------------------------------------------
# REFERENCE mode, octave-sharded: rank d owns octaves d*k .. d*k + k - 1,
# k = ceil(n_octaves / n) (the JAX package's block split), computes each at
# its true size, and broadcasts it from there. No other communication.
# ---------------------------------------------------------------------------


def octave_sharded_reference_dog_pyramid(img: torch.Tensor, S: int, mesh,
                                         axis: str = "spatial",
                                         n_octaves: int | None = None) -> list:
    """Octave-sharded REFERENCE pyramid: the usual list of (S+3, size_o,
    size_o) octaves, each a replicated DTensor after its owner's broadcast."""
    img = img.to(torch.float32)
    total = clamp_octaves(img.shape[0], n_octaves)
    n = axis_size(mesh, axis)
    d = axis_index(mesh, axis)
    k = -(-total // n)
    out = []
    for o in range(total):
        owner = o // k
        if owner == d:
            octave = reference_dog_octave(reference_subsample(img, o), S)
        else:
            side = img.shape[0] // 2**o
            octave = img.new_empty((S + 3, side, side))
        broadcast(octave, mesh, axis, owner)
        out.append(global_view(octave, mesh, replicated(mesh)))
    return out


# ---------------------------------------------------------------------------
# SIFT mode: true separable convolution, rows sharded with a halo exchange.
# ---------------------------------------------------------------------------


def sharded_separable_blur(mesh, axis: str = "spatial"):
    """fn(local (h, W) rows, taps (2r+1,)) -> the rank's rows of the edge-
    clamped separable blur. The halo (r rows each way) is exchanged with the
    neighbours; columns are edge-padded locally. The taps are applied as a
    sum of shifted rows in fp32 (no convolution library call: cuDNN would
    run it in TF32 on the card)."""

    def run(local: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
        k = taps.shape[0]
        r = k // 2
        exchange = start_neighbor_rows(local, r, mesh, axis)
        taps = taps.to(local.dtype)

        def cols(x):
            xw = torch.cat([x[:, :1].expand(-1, r), x, x[:, -1:].expand(-1, r)], dim=1)
            return sum(taps[t] * xw[:, t:t + x.shape[1]] for t in range(k))

        from_up, from_down = exchange.wait()
        x = cols(torch.cat([from_up, local, from_down], dim=0))
        h = local.shape[0]
        return sum(taps[t] * x[t:t + h] for t in range(k))

    return run


def _band_matrices(h: int, sigmas) -> tuple[np.ndarray, int]:
    """(n_sigma, h, h + 2 * max_r) Toeplitz band slices for the row pass of
    a halo-extended shard: out[a] = sum_b L[a, b] * x_ext[b], the same
    unclamped band on every shard (the border's edge replication lives in
    the halo, not in the matrix)."""
    taps_of = [_taps_np(s) for s in sigmas]
    r = max(rs for rs, _taps in taps_of)
    L = np.zeros((len(sigmas), h, h + 2 * r), np.float32)
    for si, (rs, taps) in enumerate(taps_of):
        for a in range(h):
            L[si, a, a + r - rs:a + r + rs + 1] = taps
    return L, r


class _ShardedBank:
    """One row-sharded blur-bank call: the band slices and the column bank."""

    def __init__(self, h: int, width: int, sigmas, dtype, device):
        L, self.r = _band_matrices(h, sigmas)
        self.band = torch.from_numpy(L).to(device=device, dtype=dtype)
        self.bank_w = _blur_stack(width, sigmas, dtype, device)
        self.h = h

    def __call__(self, x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
        r, h, band = self.r, self.h, self.band
        exchange = start_neighbor_rows(x, r, mesh, axis)
        # The halo-independent bulk runs while the strips travel; the band
        # is zero outside [a, a + 2r], so the two boundary terms add exact
        # zeros to the interior rows.
        out = band[:, :, r:r + h] @ (x @ self.bank_w)
        from_up, from_down = exchange.wait()
        out = out + band[:, :, :r] @ (from_up @ self.bank_w)
        return out + band[:, :, r + h:] @ (from_down @ self.bank_w)


def sharded_blur_bank(mesh, height: int, width: int, sigmas, axis: str = "spatial",
                      dtype=torch.float32, device=None):
    """fn: this rank's (height / n, width) rows -> its (n_sigma, height / n,
    width) rows of the multi-scale blur: a column-bank product and a
    band-matrix row pass over halo-extended rows, one halo exchange (the
    largest radius) for every scale. Needs height % n == 0 and local rows
    at least the largest radius."""
    n = axis_size(mesh, axis)
    h = height // n
    bank = _ShardedBank(h, width, sigmas, dtype, device)
    if height % n or h < bank.r:
        raise ValueError(f"{height} rows over {n} ranks cannot hold a {bank.r}-row halo")
    return lambda x: bank(x, mesh, axis)


class ShardedSiftPyramid:
    """The SIFT Gaussian pyramid of (height, width) frames, rows sharded on
    ``axis`` of ``mesh`` while they split (an even split, room for the
    halo), its matrices built once on ``device``. Called on the global
    image (every rank passes the same frame); returns one DTensor a
    octave, (S+3, H_o, W_o): rows sharded, or replicated from the octave
    where they stop splitting (the rows are gathered there once)."""

    def __init__(self, cfg: PyramidConfig, height: int, width: int | None, mesh,
                 axis: str = "spatial", device=None):
        width = height if width is None else width
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        n = axis_size(mesh, axis)
        dt = cfg.dtype
        base_sigma = math.sqrt(max(cfg.sigma0**2 - cfg.assumed_blur**2, 1e-12))
        rel = _octave_scale_sigmas(cfg)
        max_r = max(_taps_np(s)[0] for s in [base_sigma, *rel])

        def can_shard(size: int) -> bool:
            # The halo must fit in the local rows and the stride-2 subsample
            # must stay local.
            return size % (2 * n) == 0 and size // n >= max(2 * max_r, 8)

        def bank(h, w, sigmas, sharded):
            if sharded:
                return _ShardedBank(h // n, w, sigmas, dt, device)
            return _blur_stack(h, sigmas, dt, device), _blur_stack(w, sigmas, dt, device)

        self.n = n
        self.height = height
        self.sharded0 = can_shard(height)
        self.base = bank(height, width, [base_sigma], self.sharded0)
        self.octaves = []                  # (sharded, bank) per octave
        h, w, sharded = height, width, self.sharded0
        for _ in range(cfg.n_octaves):
            self.octaves.append((sharded, bank(h, w, rel, sharded)))
            h, w = -(-h // 2), -(-w // 2)
            sharded = sharded and can_shard(h)

    def _blur(self, x, bank, sharded):
        if sharded:
            return bank(x, self.mesh, self.axis)
        return blur_bank(x, *bank)

    def __call__(self, img: torch.Tensor) -> list:
        if img.dim() != 2 or img.shape[0] != self.height:
            raise ValueError(f"expected one ({self.height}, W) image, got {tuple(img.shape)}")
        check_fp32_matmul(img)
        mesh, axis = self.mesh, self.axis
        x = img.to(self.cfg.dtype)
        if self.sharded0:
            h = self.height // self.n
            x = x[axis_index(mesh, axis) * h:][:h]
        x = self._blur(x, self.base, self.sharded0)[0]
        rep = replicated(mesh)
        out = []
        for o, (sharded, bank) in enumerate(self.octaves):
            octave = torch.cat([x[None], self._blur(x, bank, sharded)], dim=0)
            out.append(global_view(octave, mesh, [Replicate(), Shard(1)] if sharded else rep))
            x = octave[self.cfg.S, ::2, ::2]
            nxt = self.octaves[o + 1][0] if o + 1 < len(self.octaves) else sharded
            if sharded and not nxt:
                # The resharding point: the tail octaves run unsharded.
                x = all_gather(x, mesh, axis)
        return out


def sharded_sift_gaussian_pyramid(img: torch.Tensor, cfg: PyramidConfig, mesh,
                                  axis: str = "spatial") -> list:
    """Functional form of :class:`ShardedSiftPyramid` (builds the matrices
    per call)."""
    return ShardedSiftPyramid(cfg, img.shape[0], img.shape[1], mesh, axis,
                              device=img.device)(img)
