"""REFERENCE DoG pyramid: wrapper of the fused CUDA kernel and its plain version.

Kernel: ``csrc/reference_dog.cu`` (replaces the JAX package's
``ops/scale_space_pallas.reference_dog_octave_pallas``). One launch computes
every octave of the pyramid into one flat buffer (CTAs map to rows, a thread
to four consecutive pixels with 16-byte stores); the wrapper returns
per-octave views. A CPU tensor takes :func:`reference_dog_pyramid_plain`; a
CUDA tensor takes the kernel or raises.
"""

from __future__ import annotations

import torch

from sift_parallel_optimization_tpu_torch.core.pyramid_ref import (
    clamp_octaves,
    reference_dog_octave,
    reference_filter_bank,
    reference_subsample,
)
from sift_parallel_optimization_tpu_torch.ops._build import check_launch, load_kernels

# Kernel launches made by reference_dog_pyramid_cuda (read by chip_smoke.py).
LAUNCHES = 0

# (device, n, n_octaves, n_scales) -> concatenated per-octave window banks.
_BANKS: dict[tuple, torch.Tensor] = {}


def reference_dog_pyramid_plain(
    img: torch.Tensor, S: int, n_octaves: int | None = None
) -> list[torch.Tensor]:
    """Plain PyTorch pyramid on any device: list of (S+3, n_o, n_o)."""
    img = img.to(torch.float32)
    n_oct = clamp_octaves(img.shape[0], n_octaves)
    return [reference_dog_octave(reference_subsample(img, o), S) for o in range(n_oct)]


def _banks(device, n: int, n_oct: int, n_scales: int) -> torch.Tensor:
    key = (str(device), n, n_oct, n_scales)
    if key not in _BANKS:
        _BANKS[key] = torch.cat([
            reference_filter_bank(n >> o, n_scales, device=device).reshape(-1)
            for o in range(n_oct)
        ])
    return _BANKS[key]


def reference_dog_pyramid_cuda(
    img: torch.Tensor, S: int, n_octaves: int | None = None
) -> list[torch.Tensor]:
    """The fused kernel: (n, n) f32 CUDA image -> list of (S+3, n_o, n_o)."""
    global LAUNCHES
    if not img.is_cuda:
        raise ValueError("reference_dog_pyramid_cuda needs a CUDA tensor")
    if img.dtype != torch.float32 or img.dim() != 2 or img.shape[0] != img.shape[1]:
        raise ValueError(
            f"expected a square 2-D float32 image, got {img.dtype} {tuple(img.shape)}"
        )
    if not img.is_contiguous():
        raise ValueError("image must be contiguous")
    n = img.shape[0]
    if n >= 2 ** 15:
        raise ValueError(f"side {n}: the kernel takes sides below 32768")
    n_oct = clamp_octaves(n, n_octaves)
    n_scales = S + 3
    sizes = [n >> o for o in range(n_oct)]
    banks = _banks(img.device, n, n_oct, n_scales)
    out = torch.empty(
        sum(n_scales * s * s for s in sizes), dtype=torch.float32, device=img.device
    )
    lib = load_kernels()
    with torch.cuda.device(img.device):
        rc = lib.sift_reference_dog_pyramid(
            img.data_ptr(), banks.data_ptr(), out.data_ptr(), n, n_oct, n_scales,
            torch.cuda.current_stream(img.device).cuda_stream,
        )
    check_launch(rc, "sift_reference_dog_pyramid")
    LAUNCHES += 1
    views, off = [], 0
    for s in sizes:
        views.append(out[off:off + n_scales * s * s].view(n_scales, s, s))
        off += n_scales * s * s
    return views


def reference_dog_pyramid(
    img: torch.Tensor, S: int, n_octaves: int | None = None
) -> list[torch.Tensor]:
    """Dispatch on the tensor's device: CPU -> plain, CUDA -> kernel."""
    if img.device.type == "cpu":
        return reference_dog_pyramid_plain(img, S, n_octaves)
    if img.device.type == "cuda":
        return reference_dog_pyramid_cuda(img, S, n_octaves)
    raise ValueError(f"unsupported device {img.device}")
