"""Fused patch gather + bilinear resample: wrapper of the CUDA kernel and its
plain version, and the separable hat-weight resample both descriptor
branches use.

Kernel: ``csrc/gather_resample.cu`` (replaces the JAX package's
``ops/descriptor_fused.gather_resample_pallas``). ``(R, C)`` f32 atlas,
``(K,)`` int32 patch origins and ``(K, >=4)`` f32 params ``[py, px, rad_o,
rad_d]`` -> the ``(K, 18, 18)`` orientation and ``(K, 26, 26)`` descriptor
sample grids of each keypoint's (128, 256) patch, sampled at ``center + (i *
(2 / (g - 1)) - 1) * rad`` (the Pallas iota form, which rounds unlike
``linspace``); samples off the patch are 0. Origins are normalised as
``lax.dynamic_slice`` normalises them. A CPU tensor takes
:func:`gather_resample_plain`; a CUDA tensor takes the kernel or raises.
"""

from __future__ import annotations

import torch

from sift_parallel_optimization_tpu_torch.ops._build import check_launch, load_kernels
from sift_parallel_optimization_tpu_torch.ops.patch_gather import extract_atlas_patches_plain

# Kernel launches made by gather_resample_cuda (read by chip_smoke.py).
LAUNCHES = 0

PATCH_ROWS = 128
PATCH_COLS = 256
ORI_GRID = 18
DESC_GRID = 26


def _hat_weights(coords: torch.Tensor, extent: int) -> torch.Tensor:
    """(K, G) absolute patch coords -> (K, G, extent) bilinear hat weights."""
    p = torch.arange(extent, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - (coords[..., None] - p).abs(), min=0.0)


def resample(patches, py, px, offsets) -> torch.Tensor:
    """Separable bilinear resample at axis-aligned offsets: (K, PR, PC)
    patches, (K,) in-patch centre, (K, G) offsets -> (K, G, G) samples."""
    ay = _hat_weights(py[:, None] + offsets, patches.shape[-2])
    ax = _hat_weights(px[:, None] + offsets, patches.shape[-1])
    return torch.bmm(torch.bmm(ay, patches), ax.transpose(1, 2))


def _iota_grid(g: int, device=None) -> torch.Tensor:
    """(g,) ``i * (2 / (g - 1)) - 1`` in f32, as the Pallas kernel forms it."""
    return torch.arange(g, dtype=torch.float32, device=device) * (2.0 / (g - 1)) - 1.0


def _check(atlas, grow, x0, params) -> None:
    k = grow.shape[0] if grow.dim() == 1 else -1
    if (atlas.dim() != 2 or grow.dim() != 1 or x0.shape != grow.shape
            or params.dim() != 2 or params.shape[0] != k or params.shape[1] < 4):
        raise ValueError(
            f"expected a 2-D atlas, equal 1-D origins and (K, >=4) params, got "
            f"{tuple(atlas.shape)}, {tuple(grow.shape)}, {tuple(x0.shape)}, {tuple(params.shape)}"
        )
    if atlas.shape[0] < PATCH_ROWS or atlas.shape[1] < PATCH_COLS:
        raise ValueError(f"atlas {tuple(atlas.shape)} is smaller than a "
                         f"{PATCH_ROWS}x{PATCH_COLS} patch")


def gather_resample_plain(
    atlas: torch.Tensor, grow: torch.Tensor, x0: torch.Tensor, params: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The patch gather, then the two batched hat-weight products."""
    _check(atlas, grow, x0, params)
    patches = extract_atlas_patches_plain(atlas, grow, x0, PATCH_ROWS, PATCH_COLS)
    py, px, rad_o, rad_d = (params[:, i].to(torch.float32) for i in range(4))
    lin_o = _iota_grid(ORI_GRID, atlas.device)
    lin_d = _iota_grid(DESC_GRID, atlas.device)
    return (resample(patches, py, px, lin_o[None] * rad_o[:, None]),
            resample(patches, py, px, lin_d[None] * rad_d[:, None]))


def gather_resample_cuda(
    atlas: torch.Tensor, grow: torch.Tensor, x0: torch.Tensor, params: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel: f32 atlas and params, int32 origins, contiguous on one card."""
    global LAUNCHES
    _check(atlas, grow, x0, params)
    dev = atlas.device
    if not (atlas.is_cuda and all(t.device == dev for t in (grow, x0, params))):
        raise ValueError("atlas, origins and params must be CUDA tensors on one device")
    if (atlas.dtype != torch.float32 or params.dtype != torch.float32
            or grow.dtype != torch.int32 or x0.dtype != torch.int32):
        raise ValueError(
            f"expected f32 atlas and params and int32 origins, got {atlas.dtype}, "
            f"{params.dtype}, {grow.dtype}, {x0.dtype}"
        )
    if not all(t.is_contiguous() for t in (atlas, grow, x0, params)):
        raise ValueError("atlas, origins and params must be contiguous")
    k = grow.shape[0]
    out_o = torch.empty((k, ORI_GRID, ORI_GRID), dtype=torch.float32, device=dev)
    out_d = torch.empty((k, DESC_GRID, DESC_GRID), dtype=torch.float32, device=dev)
    if k == 0:
        return out_o, out_d
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_gather_resample(
            atlas.data_ptr(), atlas.shape[0], atlas.shape[1], grow.data_ptr(), x0.data_ptr(),
            params.data_ptr(), params.shape[1], k, out_o.data_ptr(), out_d.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(rc, "sift_gather_resample")
    LAUNCHES += 1
    return out_o, out_d


def gather_resample(
    atlas: torch.Tensor, grow: torch.Tensor, x0: torch.Tensor, params: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on the atlas's device: CPU -> plain, CUDA -> kernel."""
    if atlas.device.type == "cpu":
        return gather_resample_plain(atlas, grow, x0, params)
    if atlas.device.type == "cuda":
        return gather_resample_cuda(atlas, grow, x0, params)
    raise ValueError(f"unsupported device {atlas.device}")
