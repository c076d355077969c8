"""ctypes bindings to the native host runtime (``native/libsift_host.so``).

The same library the JAX package loads: built from ``native/Makefile`` on
first use. It supplies host-side data generation and image I/O, no device
code. ``synth_frame`` falls back to NumPy when the library cannot be built.

Several processes may load it at once on a fresh tree (pytest workers, for
one). So the build runs under an exclusive ``flock`` on ``native/
.libsift_host.lock`` into a private target that is then renamed over the
library: no process ever opens a half-written file that this loader wrote.
A library that another process's build left half-written fails to open; it is then
rebuilt under the lock and opened once more before a failure is cached.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_NAME = "libsift_host.so"
_lock = threading.Lock()
_lib = None
_build_error: str | None = None
_F32P = ctypes.POINTER(ctypes.c_float)


def _stale(lib_path: Path) -> bool:
    return not lib_path.exists() or (
        lib_path.stat().st_mtime < (_NATIVE_DIR / "sift_host.cpp").stat().st_mtime
    )


def _build(lib_path: Path, force: bool) -> None:
    """Build under the cross-process lock into a private target, then move
    it over the library (unless another process already did, or ``force``)."""
    with open(_NATIVE_DIR / ".libsift_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not _stale(lib_path):
            return
        tmp = f"{_LIB_NAME}.{os.getpid()}.tmp"
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR), f"TARGET={tmp}"],
                           check=True, capture_output=True, text=True)
            os.replace(_NATIVE_DIR / tmp, lib_path)
        finally:
            (_NATIVE_DIR / tmp).unlink(missing_ok=True)


def _open() -> ctypes.CDLL:
    lib_path = _NATIVE_DIR / _LIB_NAME
    if _stale(lib_path):
        _build(lib_path, force=False)
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError:
        # Half-written by a build that writes in place: rebuild, retry once.
        _build(lib_path, force=True)
        return ctypes.CDLL(str(lib_path))


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = _open()
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = str(e)
            return None
        lib.sift_read_pgm.restype = ctypes.c_int
        lib.sift_read_pgm.argtypes = [
            ctypes.c_char_p, _F32P, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_long,
        ]
        lib.sift_write_pgm.restype = ctypes.c_int
        lib.sift_write_pgm.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int, ctypes.c_int]
        lib.sift_synth_frame.restype = None
        lib.sift_synth_frame.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
        lib.sift_render_frame.restype = None
        lib.sift_render_frame.argtypes = [
            _F32P, ctypes.c_int, _F32P, _F32P, ctypes.c_float, ctypes.c_uint64,
        ]
        _lib = lib
        return _lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    return lib


def _pgm_dims(path) -> tuple[int, int]:
    """Parse (w, h) from a P5/P2 header without reading pixel data."""
    with open(path, "rb") as f:
        head = f.read(4096)
    tokens = []
    i = 0
    while i < len(head) and len(tokens) < 3:
        if head[i : i + 1] == b"#":
            while i < len(head) and head[i] not in b"\n":
                i += 1
        elif head[i : i + 1].isspace():
            i += 1
        else:
            j = i
            while j < len(head) and not head[j : j + 1].isspace():
                j += 1
            tokens.append(head[i:j])
            i = j
    if len(tokens) < 3 or tokens[0] not in (b"P5", b"P2"):
        raise IOError(f"{path}: not a PGM header")
    return int(tokens[1]), int(tokens[2])


def read_pgm(path: str | os.PathLike) -> np.ndarray:
    """Read a P5/P2 PGM into a (H, W) float32 array in [0, 1]."""
    lib = _require()
    w0, h0 = _pgm_dims(path)
    buf = np.empty(w0 * h0, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.sift_read_pgm(
        str(path).encode(), buf.ctypes.data_as(_F32P),
        ctypes.byref(w), ctypes.byref(h), ctypes.c_long(w0 * h0),
    )
    if rc != 0:
        raise IOError(f"sift_read_pgm({path}) failed with code {rc}")
    return buf[: w.value * h.value].reshape(h.value, w.value)


def write_pgm(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write [0, 1] floats as an 8-bit PGM."""
    lib = _require()
    img = np.ascontiguousarray(img, np.float32)
    rc = lib.sift_write_pgm(
        str(path).encode(), img.ctypes.data_as(_F32P), img.shape[1], img.shape[0]
    )
    if rc != 0:
        raise IOError(f"sift_write_pgm({path}) failed with code {rc}")


def synth_frame(size: int, frame_idx: int, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic frame (blob field + noise), native path."""
    lib = _load()
    if lib is None:
        return _synth_frame_numpy(size, frame_idx, seed)
    out = np.empty(size * size, np.float32)
    lib.sift_synth_frame(out.ctypes.data_as(_F32P), size, frame_idx, ctypes.c_uint64(seed))
    return out.reshape(size, size)


def render_frame(
    size: int, rvec: np.ndarray, tvec: np.ndarray, focal: float, seed: int = 0
) -> np.ndarray:
    """Pinhole view of a deterministic 3-D blob cloud (real parallax)."""
    lib = _require()
    out = np.empty(size * size, np.float32)
    rv = np.ascontiguousarray(rvec, np.float32)
    tv = np.ascontiguousarray(tvec, np.float32)
    lib.sift_render_frame(
        out.ctypes.data_as(_F32P), size, rv.ctypes.data_as(_F32P),
        tv.ctypes.data_as(_F32P), ctypes.c_float(focal), ctypes.c_uint64(seed),
    )
    return out.reshape(size, size)


def _synth_frame_numpy(size: int, frame_idx: int, seed: int) -> np.ndarray:
    """Pure-NumPy fallback (NOT bit-identical to the native generator).

    The blob field of the JAX package's fallback, with each blob evaluated
    only within 6 sigma of its centre (the dropped tail is below 1e-7 of the
    amplitude), so a 1024^2 frame takes a fraction of a second.
    """
    rng = np.random.default_rng(seed * 1000003 + 12345)
    img = np.full((size, size), 0.5, np.float32)
    n_blobs = max(8, size * size // 820)
    drift = 0.9 * frame_idx
    for _ in range(n_blobs):
        cy = rng.uniform(0, size)
        cx = (rng.uniform(0, size) - drift) % size
        sig = rng.uniform(2.0, 8.0)
        amp = rng.uniform(-0.4, 0.4)
        r = int(np.ceil(6 * sig))
        y0, y1 = max(0, int(cy) - r), min(size, int(cy) + r + 1)
        x0, x1 = max(0, int(cx) - r), min(size, int(cx) + r + 1)
        y, x = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        img[y0:y1, x0:x1] += amp * np.exp(
            -((y - cy) ** 2 + (x - cx) ** 2) / (2 * sig**2)
        )
    fr = np.random.default_rng(seed * 1000003 + frame_idx)
    img += 0.06 * (fr.random((size, size), np.float32) - 0.5)
    return np.clip(img, 0.0, 1.0)
