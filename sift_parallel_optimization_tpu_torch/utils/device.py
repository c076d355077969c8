"""Which device an entry point of the port runs on.

One rule for the whole package: an entry point, a constructor or a
``*_from_numpy`` converter that takes ``device=None`` means the card and
raises without one; a function that is handed tensors follows them. The CPU
is only ever asked for: pass CPU tensors or ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import functools

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` if given, else the device of the tensor ``like``, else the
    card. Asking for the card, in either way, without one raises: nothing
    moves to the CPU on its own (pass CPU tensors or ``device="cpu"``)."""
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           f"(pass CPU tensors or device='cpu' to run on the CPU)")
    return device


@contextlib.contextmanager
def fp32_matmul():
    """Full-fp32 matmuls (TF32 off) inside the block, the previous setting
    restored after it: the port's ``jax.default_matmul_precision("highest")``.
    Solvers and alignments need their fp32 digits; under TF32 they fail the
    way the JAX package's did under the TPU's bf16 default."""
    prev = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def f32_precision(fn):
    """Run ``fn`` under :func:`fp32_matmul` (the JAX package's decorator of
    the same name)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with fp32_matmul():
            return fn(*args, **kwargs)

    return wrapped
