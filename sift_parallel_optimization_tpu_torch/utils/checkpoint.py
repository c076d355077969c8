"""Checkpoint / resume for pipeline state (port of ``utils/checkpoint.py``).

Any named tuple of tensors (nested ones too: an SfmMap holds its
Observations) is saved with ``torch.save`` of its leaves, written to a
temporary name and renamed over the checkpoint, so a crash never leaves a
half-written one; this gives the incremental SfM driver restartable steps.
The JAX package stores its checkpoints with orbax; the two formats are
separate and neither package reads the other's.

Layout under ``path``: ``step_<n>`` (the tensors) and ``step_<n>.meta.json``
(the run's fingerprint, written first).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import torch
from torch.utils import _pytree as pytree


def _replace_atomically(target: Path, write) -> None:
    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
    try:
        write(tmp)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)


def save_pytree(
    path: str | os.PathLike,
    tree: Any,
    step: int = 0,
    meta: dict | None = None,
) -> None:
    """Atomically save a tree of tensors + the step counter.

    ``meta`` (a small JSON-able config fingerprint, e.g. sequence id and
    capacities) is stored alongside; ``load_pytree`` verifies it so a
    checkpoint directory reused across differently-configured runs fails
    loudly instead of silently resuming the wrong sequence.
    """
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    if meta is not None:
        _replace_atomically(path / f"step_{step}.meta.json",
                            lambda p: p.write_text(json.dumps(meta)))
    leaves = [t.detach().cpu() for t in pytree.tree_leaves(tree)]
    _replace_atomically(path / f"step_{step}",
                        lambda p: torch.save({"leaves": leaves, "step": step}, p))


def latest_step(path: str | os.PathLike) -> int | None:
    """Highest step with a complete checkpoint under ``path``, else None."""
    path = Path(path)
    if not path.is_dir():
        return None
    steps = [int(d.name[5:]) for d in path.iterdir()
             if d.name.startswith("step_") and d.name[5:].isdigit()]
    return max(steps) if steps else None


def load_pytree(
    path: str | os.PathLike,
    like: Any,
    step: int | None = None,
    meta: dict | None = None,
    meta_defaults: dict | None = None,
):
    """Restore (tree, step); ``like`` provides the structure, shapes, dtypes
    and devices.

    If ``meta`` is given, every key it contains must match the fingerprint
    stored by ``save_pytree`` (when one exists) -- a mismatch raises
    ValueError. A key MISSING from the saved fingerprint (a checkpoint
    written before that config knob existed) is accepted only when the
    requested value equals ``meta_defaults[key]``. Keys present only in the
    saved fingerprint are ignored: the leaves' count, shapes and dtypes
    matching ``like`` is the shape guard.
    """
    path = Path(path).resolve()
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    if meta is not None:
        meta_path = path / f"step_{step}.meta.json"
        if meta_path.exists():
            saved = json.loads(meta_path.read_text())
            defaults = meta_defaults or {}
            for k, want in meta.items():
                if k not in saved and k not in defaults:
                    # No record and no declared default: refuse -- we
                    # cannot know what the old run did.
                    raise ValueError(
                        f"checkpoint fingerprint under {path} lacks "
                        f"{k!r} and no compatibility default is "
                        "declared; refusing to resume"
                    )
                have = saved[k] if k in saved else defaults[k]
                if have != want:
                    raise ValueError(
                        f"checkpoint fingerprint mismatch under {path}: "
                        f"{k}={have!r} (saved) != {want!r} (requested); "
                        "refusing to resume a differently-configured run"
                    )
    saved = torch.load(path / f"step_{step}", map_location="cpu", weights_only=True)
    leaves, spec = pytree.tree_flatten(like)
    got = saved["leaves"]
    if len(got) != len(leaves) or any(
            g.shape != l.shape or g.dtype != l.dtype for g, l in zip(got, leaves)):
        raise ValueError(f"checkpoint under {path} (step {step}) does not have the "
                         "structure, shapes and dtypes of the state to restore")
    tree = pytree.tree_unflatten([g.to(l.device) for g, l in zip(got, leaves)], spec)
    return tree, int(saved["step"])
