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
overlapping windows and strided subsamples are read in place. Either
operand may instead be a :class:`SplitPair`, a matrix split once by
:func:`split_pair` (the pyramid's constant blur matrices): the result is
bitwise the one of its f32 matrix. ``out`` may be a strided view with a
column stride of 1. A CPU tensor takes :func:`bf16x3_bmm_plain`; a CUDA
tensor takes the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sift_parallel_optimization_tpu_torch.ops._build import check_launch, load_kernels
from sift_parallel_optimization_tpu_torch.utils.device import fp32_matmul

# Kernel launches made by bf16x3_bmm_cuda (read by chip_smoke.py).
LAUNCHES = 0

_MAX_GRID_YZ = 65535
# A split pair's rows are padded to a multiple of this many bf16 (16 bytes),
# so that the kernel copies them 16 bytes at a time.
_ROW_ALIGN = 8


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as f32 tensors: hi = bf16(x), lo = bf16(x - hi), rounded to
    nearest even as the kernel rounds."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


class SplitPair:
    """An f32 matrix, or a batch of them, split once by :func:`_split`'s
    rounding and held as its bf16 parts: ``parts`` is one (2, ..., rows,
    padded) bf16 tensor, ``parts[0]`` hi and ``parts[1]`` lo, each row
    zero-padded to a multiple of 8 entries (16 bytes); ``cols`` is the
    matrix's own width. It takes the f32 matrix's 4 bytes an entry.
    Indexing and :meth:`repeat` act on the batch dimensions of both parts
    at once (one view, or one copy)."""

    __slots__ = ("parts", "cols")

    def __init__(self, parts: torch.Tensor, cols: int):
        self.parts = parts
        self.cols = cols

    @property
    def hi(self) -> torch.Tensor:
        return self.parts[0, ..., :self.cols]

    @property
    def lo(self) -> torch.Tensor:
        return self.parts[1, ..., :self.cols]

    @property
    def shape(self) -> torch.Size:
        return torch.Size((*self.parts.shape[1:-1], self.cols))

    @property
    def device(self) -> torch.device:
        return self.parts.device

    def dim(self) -> int:
        return self.parts.dim() - 1

    def stride(self) -> tuple[int, ...]:
        return self.hi.stride()

    def __getitem__(self, index) -> "SplitPair":
        index = index if isinstance(index, tuple) else (index,)
        return SplitPair(self.parts[(slice(None), *index)], self.cols)

    def repeat(self, *sizes: int) -> "SplitPair":
        if tuple(sizes[-2:]) != (1, 1):
            raise ValueError(f"a split pair repeats along its batch dimensions only, got {sizes}")
        return SplitPair(self.parts.repeat(1, *sizes), self.cols)

    def dense(self) -> torch.Tensor:
        """hi + lo in f32: the matrix as the products see it."""
        return self.hi.float() + self.lo.float()


def split_pair(x: torch.Tensor) -> SplitPair:
    """``x`` (f32, (..., rows, cols)) split once, contiguous with padded
    rows: the layout the kernel reads 16 bytes at a time."""
    hi, lo = _split(x)
    cols = x.shape[-1]
    parts = torch.stack([hi, lo]).to(torch.bfloat16)
    return SplitPair(F.pad(parts, (0, -cols % _ROW_ALIGN)).contiguous(), cols)


def _parts(x) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an operand as contiguous f32 tensors, however it came: the
    plain version multiplies the same values in the same layout either way,
    so a split pair's product is bitwise its f32 matrix's."""
    hi, lo = (x.hi.float(), x.lo.float()) if isinstance(x, SplitPair) else _split(x)
    return hi.contiguous(), lo.contiguous()


def bf16x3_bmm_plain(a, b, out: torch.Tensor | None = None) -> torch.Tensor:
    """The 3-pass bf16 product in plain PyTorch on any device: the parts of
    the split multiplied as fp32 matrices (their products are exact in f32)
    and summed as hi@hi + (hi@lo + lo@hi)."""
    ah, al = _parts(a)
    bh, bl = _parts(b)
    with fp32_matmul():
        c = ah @ bh + (ah @ bl + al @ bh)
    if out is None:
        return c
    return out.copy_(c)


def _batched(x: torch.Tensor, batch: tuple[int, ...]) -> torch.Tensor:
    """``x`` broadcast to ``batch`` and given exactly two batch dimensions."""
    x = x.expand(*batch, *x.shape[-2:])
    return x.reshape(1, 1, *x.shape[-2:]) if not batch else (x[None] if len(batch) == 1 else x)


def _strides(x: torch.Tensor) -> list[int]:
    """The four strides of a ``_batched`` view in elements (batch 1, batch
    2, row, column), 0 for a batch dimension of one."""
    return [s if n > 1 else 0 for n, s in zip(x.shape[:2], x.stride()[:2])] + list(x.stride()[2:])


def _pointers(x, batch: tuple[int, ...]) -> tuple[int, int, list[int]]:
    """(hi pointer, lo pointer or 0 for an f32 operand, its strides) for the
    kernel; a split pair's parts share their strides."""
    if not isinstance(x, SplitPair):
        x4 = _batched(x, batch)
        return x4.data_ptr(), 0, _strides(x4)
    hi = _batched(x.hi, batch)
    return hi.data_ptr(), _batched(x.lo, batch).data_ptr(), _strides(hi)


def _check_operand(x, name: str) -> None:
    want = torch.bfloat16 if isinstance(x, SplitPair) else torch.float32
    dtype = x.parts.dtype if isinstance(x, SplitPair) else x.dtype
    if dtype != want:
        raise ValueError(f"{name}: expected an f32 tensor or a bf16 SplitPair, got {dtype}")


def bf16x3_bmm_cuda(a, b, out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel: ``a @ b`` as 3-pass bf16 products with fp32 sums, f32
    CUDA tensors or split pairs on one card, at most two batch dimensions,
    ``out``'s column stride 1."""
    global LAUNCHES
    dev = a.device
    if not (dev.type == "cuda" and b.device == dev and (out is None or out.device == dev)):
        raise ValueError("bf16x3_bmm_cuda needs CUDA tensors on one device")
    _check_operand(a, "a")
    _check_operand(b, "b")
    if out is not None and out.dtype != torch.float32:
        raise ValueError(f"out: expected f32, got {out.dtype}")
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by {tuple(b.shape)}")
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    if len(batch) > 2:
        raise ValueError(f"at most two batch dimensions, got {batch}")
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if out is None:
        out = torch.empty((*batch, m, n), dtype=torch.float32, device=dev)
    elif tuple(out.shape) != (*batch, m, n):
        raise ValueError(f"out is {tuple(out.shape)}, the product {(*batch, m, n)}")
    if n > 1 and out.stride(-1) != 1:
        raise ValueError(f"out: the inner stride must be 1, got {out.stride()}")
    if out.numel() == 0:
        return out
    c4 = _batched(out, batch)
    n_batch = c4.shape[0] * c4.shape[1]
    if n_batch > _MAX_GRID_YZ or -(-m // 64) > _MAX_GRID_YZ:
        raise ValueError(f"{n_batch} batches of {m} rows: beyond the kernel's grid")
    a_hi, a_lo, sa = _pointers(a, batch)
    b_hi, b_lo, sb = _pointers(b, batch)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.sift_bf16x3_bmm(
            a_hi, a_lo or None, b_hi, b_lo or None, c4.data_ptr(), c4.shape[0], c4.shape[1],
            m, n, k, *sa, *sb, *_strides(c4)[:3], torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(rc, "sift_bf16x3_bmm")
    LAUNCHES += 1
    return out


def bf16x3_bmm(a, b, out: torch.Tensor | None = None) -> torch.Tensor:
    """Dispatch on the tensor's device: CPU -> plain, CUDA -> kernel."""
    if a.device.type == "cpu":
        return bf16x3_bmm_plain(a, b, out)
    if a.device.type == "cuda":
        return bf16x3_bmm_cuda(a, b, out)
    raise ValueError(f"unsupported device {a.device}")


# The kernel's instances the pyramid launches, as (A split, B split, A's
# columns 2 apart): a row pass (the bank split, the image in f32), a column
# pass (the image in f32, the bank split) and a dense or tail column pass
# on an octave's stride-2 base.
PYRAMID_INSTANCES = ((True, False, False), (False, True, False), (False, True, True))


def kernel_attributes(a_pair: bool, b_pair: bool, a_step2: bool = False) -> dict:
    """What the build gave the kernel's instance for these operand kinds
    (split pair or f32; an f32 A with columns 2 apart): registers a thread,
    static and dynamic shared bytes, local (spill) bytes a thread, and the
    CTAs an SM holds at once (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Needs the card."""
    got = (ctypes.c_int * 5)()
    rc = load_kernels().sift_bf16x3_bmm_attributes(int(a_pair), int(b_pair), int(a_step2),
                                                   ctypes.cast(got, ctypes.c_void_p))
    check_launch(rc, "sift_bf16x3_bmm_attributes")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "local_bytes",
                     "ctas_per_sm"), got))
