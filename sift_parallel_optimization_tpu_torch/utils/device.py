"""Which device an entry point of the port runs on.

One rule for the whole package: an entry point, a constructor or a
``*_from_numpy`` converter that takes ``device=None`` means the card and
raises without one; a function that is handed tensors follows them. The CPU
is only ever asked for: pass CPU tensors or ``device="cpu"``.
"""

from __future__ import annotations

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
