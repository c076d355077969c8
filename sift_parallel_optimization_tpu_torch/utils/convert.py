"""numpy <-> tensor converters of the port's named tuples: what the
``*_from_numpy`` / ``*_to_numpy`` functions of the model modules are built
on. They take the JAX package's tuples (after ``np.asarray``) or dicts of
numpy arrays, field for field."""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from sift_parallel_optimization_tpu_torch.utils.device import resolve_device


def field(obj, name: str):
    """``name`` of a mapping or of a (named) tuple: the two forms the
    ``*_from_numpy`` converters take."""
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def tensor_from_numpy(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A copy of array ``a`` as a ``dtype`` tensor on ``device``."""
    return torch.as_tensor(np.array(a), dtype=dtype).to(device)


def tuple_from_numpy(cls, arrays, dtypes: dict, device=None):
    """A named tuple ``cls`` of tensors from numpy arrays, field for field:
    a mapping or named tuple with ``cls``'s fields. Fields are f32 unless
    ``dtypes`` says otherwise. ``device`` None means the card, and raises
    without one."""
    device = resolve_device(device)
    return cls(**{f: tensor_from_numpy(field(arrays, f), dtypes.get(f, torch.float32), device)
                  for f in cls._fields})


def tuple_to_numpy(tup) -> dict:
    """The inverse of :func:`tuple_from_numpy`: a dict of numpy arrays."""
    return {f: v.cpu().numpy() for f, v in tup._asdict().items()}
