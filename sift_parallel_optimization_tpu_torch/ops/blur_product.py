"""The blur products at ``blur_precision="high"``: wrapper of kernel 5 and
its plain version.

Kernel: ``csrc/bf16x3_mm.cu``. It replaces no Pallas kernel: the JAX
package runs its SIFT blur products as XLA dots at ``Precision.HIGH``, which
the TPU computes as three bf16 passes. :func:`bf16x3_bmm` computes that
function: every f32 operand x split as hi = bf16(x), lo = bf16(x - hi), and
C = hi@hi + (hi@lo + lo@hi) with exact products and fp32 sums.

Operands are ``(..., m, k)`` and ``(..., k, n)`` f32 tensors with up to two
batch dimensions, broadcast against each other (a broadcast dimension is a
stride of 0, read in place), with any batch, row and column strides:
overlapping windows and strided subsamples are read in place. ``out`` may
be a strided view with a column stride of 1. A CPU tensor takes
:func:`bf16x3_bmm_plain`; a CUDA tensor takes the kernel or raises.
"""

from __future__ import annotations

import torch

from sift_parallel_optimization_tpu_torch.ops._build import check_launch, load_kernels
from sift_parallel_optimization_tpu_torch.utils.device import fp32_matmul

# Kernel launches made by bf16x3_bmm_cuda (read by chip_smoke.py).
LAUNCHES = 0

_MAX_GRID_YZ = 65535


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as f32 tensors: hi = bf16(x), lo = bf16(x - hi), rounded to
    nearest even as the kernel rounds."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def bf16x3_bmm_plain(a: torch.Tensor, b: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """The 3-pass bf16 product in plain PyTorch on any device: the parts of
    the split multiplied as fp32 matrices (their products are exact in f32)
    and summed as hi@hi + (hi@lo + lo@hi)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    with fp32_matmul():
        c = ah @ bh + (ah @ bl + al @ bh)
    if out is None:
        return c
    return out.copy_(c)


def _batched(x: torch.Tensor, batch: tuple[int, ...]) -> torch.Tensor:
    """``x`` broadcast to ``batch`` and given exactly two batch dimensions."""
    x = x.expand(*batch, *x.shape[-2:])
    return x.reshape(1, 1, *x.shape[-2:]) if not batch else (x[None] if len(batch) == 1 else x)


def bf16x3_bmm_cuda(a: torch.Tensor, b: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel: ``a @ b`` as 3-pass bf16 products with fp32 sums, f32
    CUDA tensors on one card, at most two batch dimensions, ``out``'s column
    stride 1."""
    global LAUNCHES
    if not (a.is_cuda and b.device == a.device and (out is None or out.device == a.device)):
        raise ValueError("bf16x3_bmm_cuda needs CUDA tensors on one device")
    if a.dtype != torch.float32 or b.dtype != torch.float32 or (
            out is not None and out.dtype != torch.float32):
        raise ValueError(f"expected f32 operands, got {a.dtype}, {b.dtype}")
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by {tuple(b.shape)}")
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    if len(batch) > 2:
        raise ValueError(f"at most two batch dimensions, got {batch}")
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if out is None:
        out = torch.empty((*batch, m, n), dtype=torch.float32, device=a.device)
    elif tuple(out.shape) != (*batch, m, n):
        raise ValueError(f"out is {tuple(out.shape)}, the product {(*batch, m, n)}")
    if n > 1 and out.stride(-1) != 1:
        raise ValueError(f"out: the inner stride must be 1, got {out.stride()}")
    if out.numel() == 0:
        return out
    a4, b4, c4 = (_batched(x, batch) for x in (a, b, out))
    n_batch = c4.shape[0] * c4.shape[1]
    if n_batch > _MAX_GRID_YZ or -(-m // 64) > _MAX_GRID_YZ:
        raise ValueError(f"{n_batch} batches of {m} rows: beyond the kernel's grid")
    lib = load_kernels()
    with torch.cuda.device(a.device):
        rc = lib.sift_bf16x3_bmm(
            a4.data_ptr(), b4.data_ptr(), c4.data_ptr(), c4.shape[0], c4.shape[1], m, n, k,
            *a4.stride(), *b4.stride(), *c4.stride()[:3],
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    check_launch(rc, "sift_bf16x3_bmm")
    LAUNCHES += 1
    return out


def bf16x3_bmm(a: torch.Tensor, b: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch on the tensor's device: CPU -> plain, CUDA -> kernel."""
    if a.device.type == "cpu":
        return bf16x3_bmm_plain(a, b, out)
    if a.device.type == "cuda":
        return bf16x3_bmm_cuda(a, b, out)
    raise ValueError(f"unsupported device {a.device}")
