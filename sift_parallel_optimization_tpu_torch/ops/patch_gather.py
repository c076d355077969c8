"""Per-keypoint patch gather: wrappers of the CUDA kernel and its plain versions.

Kernel: ``csrc/patch_gather.cu`` (replaces the JAX package's
``ops/patch_gather.extract_atlas_patches_pallas`` and
``extract_atlas_patches_batched_pallas``). Two entry points over one kernel:

* :func:`extract_atlas_patches` -- ``(R, C)`` f32 atlas + ``(K,)`` int32
  origins -> ``(K, rows, cols)`` patches;
* :func:`extract_atlas_patches_batched` -- ``(B, R, C)`` atlases (or one
  ``(R, C)`` atlas shared by every frame) + ``(B, K)`` origins ->
  ``(B, K, rows, cols)``, all ``B * K`` patches in one launch.

Both are bit-equal to advanced indexing. Origins are normalised as
``lax.dynamic_slice`` normalises them, per frame: a negative origin counts
from the end, then every origin clamps into its own frame's atlas. A CPU
tensor takes the ``*_plain`` version; a CUDA tensor takes the kernel or
raises.
"""

from __future__ import annotations

import torch

from sift_parallel_optimization_tpu_torch.ops._build import check_launch, load_kernels

# Kernel launches made by extract_atlas_patches_cuda and by
# extract_atlas_patches_batched_cuda (read by chip_smoke.py).
LAUNCHES = 0
LAUNCHES_BATCHED = 0


def _check_shapes(atlas: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  rows: int, cols: int) -> None:
    if atlas.dim() != 2 or ys.dim() != 1 or ys.shape != xs.shape:
        raise ValueError(
            f"expected a 2-D atlas and equal 1-D origins, got "
            f"{tuple(atlas.shape)}, {tuple(ys.shape)}, {tuple(xs.shape)}"
        )
    _check_patch(atlas, rows, cols)


def _check_patch(atlas: torch.Tensor, rows: int, cols: int) -> None:
    if not (1 <= rows <= atlas.shape[-2] and 1 <= cols <= atlas.shape[-1]):
        raise ValueError(f"patch {rows}x{cols} does not fit atlas {tuple(atlas.shape)}")


def _check_shapes_batched(atlas: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                          rows: int, cols: int) -> None:
    if (atlas.dim() not in (2, 3) or ys.dim() != 2 or ys.shape != xs.shape
            or (atlas.dim() == 3 and atlas.shape[0] != ys.shape[0])):
        raise ValueError(
            f"expected (B, R, C) atlases (or one shared (R, C) atlas) and equal "
            f"(B, K) origins, got {tuple(atlas.shape)}, {tuple(ys.shape)}, {tuple(xs.shape)}"
        )
    _check_patch(atlas, rows, cols)


def _normalise(ys: torch.Tensor, xs: torch.Tensor, r: int, c: int, rows: int, cols: int):
    y0, x0 = ys.long(), xs.long()
    y0 = torch.where(y0 < 0, y0 + r, y0).clamp(0, r - rows)
    x0 = torch.where(x0 < 0, x0 + c, x0).clamp(0, c - cols)
    return y0, x0


def extract_atlas_patches_plain(
    atlas: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, rows: int, cols: int
) -> torch.Tensor:
    """Advanced-indexing gather on any device."""
    _check_shapes(atlas, ys, xs, rows, cols)
    y0, x0 = _normalise(ys, xs, *atlas.shape, rows, cols)
    ri = y0[:, None] + torch.arange(rows, device=atlas.device)
    ci = x0[:, None] + torch.arange(cols, device=atlas.device)
    return atlas[ri[:, :, None], ci[:, None, :]]


def extract_atlas_patches_batched_plain(
    atlas: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, rows: int, cols: int
) -> torch.Tensor:
    """Advanced-indexing gather of (B, K) patches on any device; a 2-D atlas
    is shared by every frame."""
    _check_shapes_batched(atlas, ys, xs, rows, cols)
    y0, x0 = _normalise(ys, xs, *atlas.shape[-2:], rows, cols)
    ri = (y0[..., None] + torch.arange(rows, device=atlas.device))[..., :, None]
    ci = (x0[..., None] + torch.arange(cols, device=atlas.device))[..., None, :]
    if atlas.dim() == 2:
        return atlas[ri, ci]
    bi = torch.arange(atlas.shape[0], device=atlas.device)[:, None, None, None]
    return atlas[bi, ri, ci]


def _launch(atlas, ys, xs, out, per_frame: int, atlas_stride: int, rows: int, cols: int):
    """Check device, types and layout, then launch the kernel on ``out``."""
    if not (atlas.is_cuda and ys.device == atlas.device and xs.device == atlas.device):
        raise ValueError("atlas and origins must be CUDA tensors on one device")
    if atlas.dtype != torch.float32 or ys.dtype != torch.int32 or xs.dtype != torch.int32:
        raise ValueError(
            f"expected f32 atlas and int32 origins, got {atlas.dtype}, {ys.dtype}, {xs.dtype}"
        )
    if not (atlas.is_contiguous() and ys.is_contiguous() and xs.is_contiguous()):
        raise ValueError("atlas and origins must be contiguous")
    r, c = atlas.shape[-2:]
    vec_ok = int(
        atlas.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        and c % 4 == 0 and cols % 4 == 0 and atlas_stride % 4 == 0
    )
    lib = load_kernels()
    with torch.cuda.device(atlas.device):
        rc = lib.sift_patch_gather(
            atlas.data_ptr(), ys.data_ptr(), xs.data_ptr(), out.data_ptr(),
            r, c, ys.numel(), per_frame, atlas_stride, rows, cols, vec_ok,
            torch.cuda.current_stream(atlas.device).cuda_stream,
        )
    check_launch(rc, "sift_patch_gather")


def extract_atlas_patches_cuda(
    atlas: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, rows: int, cols: int
) -> torch.Tensor:
    """The CUDA kernel: f32 atlas, int32 origins, all contiguous on one card."""
    global LAUNCHES
    _check_shapes(atlas, ys, xs, rows, cols)
    k = ys.shape[0]
    out = torch.empty((k, rows, cols), dtype=torch.float32, device=atlas.device)
    if k == 0:
        return out
    _launch(atlas, ys, xs, out, k, 0, rows, cols)
    LAUNCHES += 1
    return out


def extract_atlas_patches_batched_cuda(
    atlas: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, rows: int, cols: int
) -> torch.Tensor:
    """The CUDA kernel on a batch, one launch: f32 (B, R, C) atlases (or one
    shared (R, C) atlas), int32 (B, K) origins, all contiguous on one card."""
    global LAUNCHES_BATCHED
    _check_shapes_batched(atlas, ys, xs, rows, cols)
    b, k = ys.shape
    out = torch.empty((b, k, rows, cols), dtype=torch.float32, device=atlas.device)
    if b * k == 0:
        return out
    stride = atlas.shape[1] * atlas.shape[2] if atlas.dim() == 3 else 0
    _launch(atlas, ys, xs, out, k, stride, rows, cols)
    LAUNCHES_BATCHED += 1
    return out


def extract_atlas_patches(
    atlas: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, rows: int, cols: int
) -> torch.Tensor:
    """Dispatch on the atlas's device: CPU -> plain, CUDA -> kernel."""
    if atlas.device.type == "cpu":
        return extract_atlas_patches_plain(atlas, ys, xs, rows, cols)
    if atlas.device.type == "cuda":
        return extract_atlas_patches_cuda(atlas, ys, xs, rows, cols)
    raise ValueError(f"unsupported device {atlas.device}")


def extract_atlas_patches_batched(
    atlas: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, rows: int, cols: int
) -> torch.Tensor:
    """Dispatch on the atlas's device: CPU -> plain, CUDA -> kernel."""
    if atlas.device.type == "cpu":
        return extract_atlas_patches_batched_plain(atlas, ys, xs, rows, cols)
    if atlas.device.type == "cuda":
        return extract_atlas_patches_batched_cuda(atlas, ys, xs, rows, cols)
    raise ValueError(f"unsupported device {atlas.device}")
