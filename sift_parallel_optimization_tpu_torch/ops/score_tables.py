"""DoG ranking score fused into candidate tables: kernel wrappers and plain versions.

Kernel: ``csrc/score_tables.cu`` (replaces the JAX package's
``ops/detect_fused.fused_score_tables``, and the fusion of
``models/detect._dense_score(want_hops=True)`` into ``_block_top2`` that
the JAX package's accelerator branch leaves to XLA). One score function per
voxel, two entry points:

* :func:`score_tables_rows` -- the TPU kernel's contract: per score plane,
  interior row and 64-column span, (max, first argmax) of the ranking score.
* :func:`score_block_top2` -- what the block-reduce detection branch runs:
  every octave of the pyramids of a (B,) batch of frames (one frame is
  B = 1) in one launch; per flat 64-voxel block the top-2 of the hop-packed int32 scores,
  or every voxel of an octave too small for blocks (see :func:`table_layout`).

A CPU tensor takes the ``*_plain`` version; a CUDA tensor takes the kernel
or raises. The plain versions run ``models/detect``'s own score code. The
kernel tests extrema first and scores only those (a CTA per tile of the
octave, its DoG rows staged in shared memory); it equals the plain versions
bit for bit on any input, NaN included (a voxel with a NaN in its 3x3x3 cube
scores 0 in both). Both kernels index an octave's score voxels in 32 bits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sift_parallel_optimization_tpu_torch.models import detect
from sift_parallel_optimization_tpu_torch.ops._build import check_launch, load_kernels

# Kernel launches made by score_tables_rows_cuda and score_block_top2_cuda
# (read by chip_smoke.py).
LAUNCHES = 0

SPAN = 64             # voxels per table entry
DENSE_BELOW = 4096    # an octave with fewer score voxels keeps every voxel


class OctaveTables(NamedTuple):
    """Where one octave's entries lie in the outputs of score_block_top2."""

    dog_off: int      # first float of the octave in the flat DoG
    h: int
    w: int
    dense: bool       # every voxel (True) or 64-voxel top-2 tables
    out_off: int      # first entry in vals / idx
    n: int            # entries: vg (dense) or 2 * ceil(vg / 64)
    g_base: int       # flat score index of the octave's voxel 0
    vg: int           # score voxels, (planes - 2) * (h - 2) * (w - 2)
    score_off: int    # dense octaves: first entry in the f32 scores


def table_layout(shapes: tuple[tuple[int, int, int], ...]) -> list[OctaveTables]:
    """Per-octave layout of :func:`score_block_top2`'s outputs for a list of
    (planes, H, W) DoG octave shapes, in octave order."""
    out, g_base, dog_off, score_off, lay = 0, 0, 0, 0, []
    for planes, h, w in shapes:
        vg = (planes - 2) * (h - 2) * (w - 2)
        dense = vg < DENSE_BELOW
        n = vg if dense else 2 * (-(-vg // SPAN))
        lay.append(OctaveTables(dog_off, h, w, dense, out, n, g_base, vg,
                                score_off if dense else 0))
        out += n
        g_base += vg
        dog_off += planes * h * w
        score_off += vg if dense else 0
    return lay


def _edge_constants(edge_ratio: float) -> tuple[float, float]:
    return float(edge_ratio), float((edge_ratio + 1) ** 2)


def _check_dog(dog: torch.Tensor) -> None:
    if dog.dim() != 3 or dog.shape[0] < 3 or dog.shape[1] < 3 or dog.shape[2] < 3:
        raise ValueError(f"expected a (S+2, H, W) DoG stack with S, H, W >= 1, 3, 3, "
                         f"got {tuple(dog.shape)}")


# --- (a) per-row span tables: the TPU kernel's contract ---------------------

def score_tables_rows_plain(
    dog: torch.Tensor, thr: float, edge_ratio: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(S+2, H, W) DoG -> tv (S, H-2, ceil((W-2)/64)) f32 span maxima of the
    refine-branch ranking score and ti (same shape) int32 first-argmax flat
    indices into the (S, H-2, W-2) score volume."""
    _check_dog(dog)
    score = detect.dense_score(dog, thr, edge_ratio, refine_iters=1)
    s, hs, ws = score.shape
    nsp = -(-ws // SPAN)
    spans = torch.nn.functional.pad(score, (0, nsp * SPAN - ws)).view(s, hs, nsp, SPAN)
    tv, am = spans.max(dim=-1)   # first maximal index
    col = am + SPAN * torch.arange(nsp, device=dog.device)
    rows = torch.arange(s * hs, device=dog.device).view(s, hs, 1) * ws
    return tv, (rows + col).to(torch.int32)


def score_tables_rows_cuda(
    dog: torch.Tensor, thr: float, edge_ratio: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: contiguous f32 (S+2, H, W) DoG on one card."""
    global LAUNCHES
    _check_dog(dog)
    if not dog.is_cuda or dog.dtype != torch.float32 or not dog.is_contiguous():
        raise ValueError("score_tables_rows_cuda needs a contiguous float32 CUDA tensor")
    planes, h, w = dog.shape
    if (planes - 2) * (h - 2) * (w - 2) >= 2 ** 31:
        raise ValueError("the octave has 2^31 score voxels or more")
    shape = (planes - 2, h - 2, -(-(w - 2) // SPAN))
    tv = torch.empty(shape, dtype=torch.float32, device=dog.device)
    ti = torch.empty(shape, dtype=torch.int32, device=dog.device)
    er, er2 = _edge_constants(edge_ratio)
    lib = load_kernels()
    with torch.cuda.device(dog.device):
        rc = lib.sift_score_tables_rows(
            dog.data_ptr(), planes, h, w, thr, er, er2, tv.data_ptr(), ti.data_ptr(),
            torch.cuda.current_stream(dog.device).cuda_stream,
        )
    check_launch(rc, "sift_score_tables_rows")
    LAUNCHES += 1
    return tv, ti


def score_tables_rows(
    dog: torch.Tensor, thr: float, edge_ratio: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on the tensor's device: CPU -> plain, CUDA -> kernel."""
    if dog.device.type == "cpu":
        return score_tables_rows_plain(dog, thr, edge_ratio)
    if dog.device.type == "cuda":
        return score_tables_rows_cuda(dog, thr, edge_ratio)
    raise ValueError(f"unsupported device {dog.device}")


# --- (b) block top-2 tables of every octave: the detection path -------------

def _check_flat(flat_dog: torch.Tensor, shapes) -> list[OctaveTables]:
    if flat_dog.dim() != 2 or flat_dog.shape[0] < 1 or not shapes:
        raise ValueError("expected a (B, L) flat DoG buffer, B >= 1, and at least one "
                         f"octave shape, got {tuple(flat_dog.shape)}")
    planes = shapes[0][0]
    for shp in shapes:
        if len(shp) != 3 or shp[0] != planes or shp[0] < 3 or shp[1] < 3 or shp[2] < 3:
            raise ValueError(f"octave shapes must be (S+2, H, W) with one S, got {shapes}")
    lay = table_layout(tuple(tuple(s) for s in shapes))
    need = lay[-1].dog_off + planes * lay[-1].h * lay[-1].w
    if flat_dog.shape[1] != need:
        raise ValueError(f"flat DoG has {flat_dog.shape[1]} floats a frame, the shapes "
                         f"need {need}")
    return lay


def block_top2(rows: torch.Tensor):
    """(N, B) non-negative keys -> per-row (max, argmax, 2nd max, 2nd argmax),
    value ties to the smaller index (``models/detect._block_top2`` of the JAX
    package: max and first argmax, then the same with the argmax masked)."""
    m1, a1 = rows.max(dim=1)
    masked = rows.scatter(1, a1[:, None], -1)
    m2, a2 = masked.max(dim=1)
    return m1, a1, m2, a2


def score_block_top2_plain(
    flat_dog: torch.Tensor,
    shapes,
    thr: float,
    edge_ratio: float,
    refine_iters: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every octave's candidate entries of every frame, laid out per
    :func:`table_layout`.

    Row b of the (B, L) ``flat_dog`` holds frame b's (S+2, H_o, W_o) octaves
    of ``shapes`` back to back. Returns ``vals`` (B, T) int32 keys -- the
    hop-packed score of ``dense_score(want_hops=True)`` when ``refine_iters``
    >= 1, else the no-refine score's f32 bit pattern (both rank like the f32
    score) -- ``idx`` (B, T) int64 flat indices into the frame's own
    concatenated score volumes, and ``score`` (B, D) the f32 scores of the
    dense octaves' voxels.
    """
    lay = _check_flat(flat_dog, shapes)
    per_frame = [_frame_tables(f, lay, shapes[0][0], thr, edge_ratio, refine_iters)
                 for f in flat_dog]
    return tuple(torch.stack(t) for t in zip(*per_frame))


def _frame_tables(flat_dog, lay, planes, thr, edge_ratio, refine_iters):
    """One frame of :func:`score_block_top2_plain`: (L,) -> (T,), (T,), (D,)."""
    dev = flat_dog.device
    vals, idx, scores = [], [], []
    for o in lay:
        dog = flat_dog[o.dog_off:o.dog_off + planes * o.h * o.w].view(-1, o.h, o.w)
        if refine_iters:
            score, key = detect.dense_score(dog, thr, edge_ratio, refine_iters, want_hops=True)
        else:
            score = detect.dense_score(dog, thr, edge_ratio, refine_iters)
            key = score.view(torch.int32)
        key = key.reshape(-1)
        if o.dense:
            vals.append(key)
            idx.append(o.g_base + torch.arange(o.vg, device=dev))
            scores.append(score.reshape(-1))
            continue
        rows = torch.nn.functional.pad(key, (0, o.n // 2 * SPAN - o.vg)).view(-1, SPAN)
        v1, a1, v2, a2 = block_top2(rows)
        rbase = SPAN * torch.arange(o.n // 2, device=dev)
        vals.append(torch.cat([v1, v2]))
        idx.append(o.g_base + torch.clamp(torch.cat([rbase + a1, rbase + a2]), max=o.vg - 1))
    score = torch.cat(scores) if scores else torch.zeros(0, device=dev)
    return torch.cat(vals), torch.cat(idx), score


def score_block_top2_cuda(
    flat_dog: torch.Tensor,
    shapes,
    thr: float,
    edge_ratio: float,
    refine_iters: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel, one launch for every octave of every frame: contiguous f32
    (B, L) flat DoG on one card."""
    global LAUNCHES
    lay = _check_flat(flat_dog, shapes)
    if not flat_dog.is_cuda or flat_dog.dtype != torch.float32 or not flat_dog.is_contiguous():
        raise ValueError("score_block_top2_cuda needs a contiguous float32 CUDA tensor")
    if len(lay) > 32 or flat_dog.shape[0] > 65535:
        raise ValueError(f"at most 32 octaves and 65535 frames, got {len(lay)} and "
                         f"{flat_dog.shape[0]}")
    if max(o.vg for o in lay) >= 2 ** 31 - 4096:
        raise ValueError("an octave has 2^31 score voxels or more")
    dev = flat_dog.device
    total = lay[-1].out_off + lay[-1].n
    n_dense = sum(o.vg for o in lay if o.dense)
    b, per_frame = flat_dog.shape
    vals = torch.empty((b, total), dtype=torch.int32, device=dev)
    idx = torch.empty((b, total), dtype=torch.int64, device=dev)
    score = torch.empty((b, n_dense), dtype=torch.float32, device=dev)
    meta = (ctypes.c_longlong * (7 * len(lay)))(*[
        v for o in lay
        for v in (o.dog_off, o.h, o.w, int(o.dense), o.out_off, o.g_base, o.score_off)
    ])
    er, er2 = _edge_constants(edge_ratio)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_score_block_top2(
            flat_dog.data_ptr(), ctypes.addressof(meta), len(lay), shapes[0][0],
            b, per_frame, total, n_dense, thr, er, er2,
            int(refine_iters > 0), vals.data_ptr(), idx.data_ptr(), score.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(rc, "sift_score_block_top2")
    LAUNCHES += 1
    return vals, idx, score


def score_block_top2(
    flat_dog: torch.Tensor,
    shapes,
    thr: float,
    edge_ratio: float,
    refine_iters: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch on the tensor's device: CPU -> plain, CUDA -> kernel."""
    if flat_dog.device.type == "cpu":
        return score_block_top2_plain(flat_dog, shapes, thr, edge_ratio, refine_iters)
    if flat_dog.device.type == "cuda":
        return score_block_top2_cuda(flat_dog, shapes, thr, edge_ratio, refine_iters)
    raise ValueError(f"unsupported device {flat_dog.device}")
