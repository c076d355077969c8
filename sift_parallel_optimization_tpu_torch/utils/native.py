"""ctypes bindings to the port's native host runtime (``csrc/sift_host.cpp``).

Host-side frame generation, image I/O, a prefetching ring loader and a
monotonic clock; no device code. The library is built with ``g++`` at first
use into ``build/host/libsift_host.so`` at the repository root (git-ignored),
with the flags of the JAX package's ``native/Makefile`` (``-O3
-march=native``), so its frames are bitwise equal to that library's built on
the same machine. The build links libpng where it exists (``-DSIFT_HAVE_PNG
-lpng``) and otherwise builds without it: then :func:`read_png` and
:func:`write_png` raise and everything else works. Where the library cannot
be built at all, ``synth_frame`` and ``render_frame`` fall back to NumPy and
:class:`FrameLoader` raises.

Several processes may load it at once on a fresh tree (pytest workers, for
one). So the build runs under an exclusive ``flock`` on ``build/host/
.libsift_host.lock`` into a private target that is then renamed over the
library: no process ever opens a half-written file that this loader wrote.
A library that another process's build left half-written fails to open; it
is then rebuilt under the lock and opened once more before a failure is
cached.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "sift_host.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
_LIB_NAME = "libsift_host.so"
_CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
# (defines, libraries) of each build to try, in order: with libpng, then without.
_VARIANTS = ((("-DSIFT_HAVE_PNG",), ("-lpng",)), ((), ()))
_lock = threading.Lock()
_lib = None
_build_error: str | None = None
_F32P = ctypes.POINTER(ctypes.c_float)


def _stale(lib_path: Path) -> bool:
    return not lib_path.exists() or lib_path.stat().st_mtime < _SRC.stat().st_mtime


def _compile(target: Path) -> None:
    """g++ the source into ``target``: with libpng where it links, else
    without; raise with every attempt's output if none builds."""
    errors = []
    for defines, libs in _VARIANTS:
        cmd = ["g++", *_CXXFLAGS, *defines, str(_SRC), "-shared", "-pthread", *libs,
               "-o", str(target)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            return
        errors.append(f"{' '.join(cmd)}\n{proc.stderr}")
    raise OSError("building the host library failed:\n" + "\n".join(errors))


def _build(lib_path: Path, force: bool) -> None:
    """Build under the cross-process lock into a private target, then move
    it over the library (unless another process already did, or ``force``)."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".libsift_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and not _stale(lib_path):
            return
        tmp = _BUILD_DIR / f"{_LIB_NAME}.{os.getpid()}.tmp"
        try:
            _compile(tmp)
            os.replace(tmp, lib_path)
        finally:
            tmp.unlink(missing_ok=True)


def _open() -> ctypes.CDLL:
    lib_path = _BUILD_DIR / _LIB_NAME
    if _stale(lib_path):
        _build(lib_path, force=False)
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError:
        # Half-written by a build that writes in place: rebuild, retry once.
        _build(lib_path, force=True)
        return ctypes.CDLL(str(lib_path))


def _bind(lib) -> None:
    """Declare every function's argument and result types."""
    readers = [lib.sift_read_pgm, lib.sift_read_ppm]
    if _has_png(lib):
        readers.append(lib.sift_read_png)
        lib.sift_write_png.restype = ctypes.c_int
        lib.sift_write_png.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int, ctypes.c_int]
    for reader in readers:
        reader.restype = ctypes.c_int
        reader.argtypes = [
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
    lib.sift_loader_create.restype = ctypes.c_void_p
    lib.sift_loader_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    lib.sift_loader_acquire.restype = _F32P
    lib.sift_loader_acquire.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.sift_loader_release.restype = None
    lib.sift_loader_release.argtypes = [ctypes.c_void_p, _F32P]
    lib.sift_loader_destroy.restype = None
    lib.sift_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.sift_now_ms.restype = ctypes.c_double
    lib.sift_now_ms.argtypes = []


def _has_png(lib) -> bool:
    return hasattr(lib, "sift_read_png")


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = _open()
        except OSError as e:
            _build_error = str(e)
            return None
        _bind(lib)
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the host library built and loaded."""
    return _load() is not None


def build_error() -> str | None:
    """Why the host library is unavailable (None where it loaded)."""
    _load()
    return _build_error


def has_png() -> bool:
    """Whether the host library was built with libpng (PNG read and write)."""
    lib = _load()
    return lib is not None and _has_png(lib)


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_build_error}")
    return lib


def _require_png():
    lib = _require()
    if not _has_png(lib):
        raise RuntimeError("the host library was built without libpng: PNG files cannot be "
                           "read or written here (PGM and PPM can)")
    return lib


def _pnm_dims(path, magics: tuple[bytes, ...]) -> tuple[int, int]:
    """Parse (w, h) from a PNM header without reading pixel data."""
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
    if len(tokens) < 3 or tokens[0] not in magics:
        raise IOError(f"{path}: not a {magics} header")
    return int(tokens[1]), int(tokens[2])


def _png_dims(path) -> tuple[int, int]:
    """Parse (w, h) from the PNG IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(33)
    if len(head) < 24 or head[:8] != b"\x89PNG\r\n\x1a\n":
        raise IOError(f"{path}: not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def _read_via(fn_name: str, path, w0: int, h0: int) -> np.ndarray:
    lib = _require()
    buf = np.empty(w0 * h0, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, fn_name)(
        str(path).encode(), buf.ctypes.data_as(_F32P),
        ctypes.byref(w), ctypes.byref(h), ctypes.c_long(w0 * h0),
    )
    if rc != 0:
        raise IOError(f"{fn_name}({path}) failed with code {rc}")
    return buf[: w.value * h.value].reshape(h.value, w.value)


def read_pgm(path: str | os.PathLike) -> np.ndarray:
    """Read a P5/P2 PGM into a (H, W) float32 array in [0, 1]."""
    return _read_via("sift_read_pgm", path, *_pnm_dims(path, (b"P5", b"P2")))


def read_ppm(path: str | os.PathLike) -> np.ndarray:
    """Read a P6/P3 PPM as (H, W) float32 grayscale (Rec.601 luma)."""
    return _read_via("sift_read_ppm", path, *_pnm_dims(path, (b"P6", b"P3")))


def read_png(path: str | os.PathLike) -> np.ndarray:
    """Read a PNG (gray/RGB/RGBA, 8/16-bit) as (H, W) float32 grayscale;
    raises where the library was built without libpng."""
    _require_png()
    return _read_via("sift_read_png", path, *_png_dims(path))


def write_png(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write [0, 1] floats as an 8-bit grayscale PNG."""
    lib = _require_png()
    img = np.ascontiguousarray(img, np.float32)
    rc = lib.sift_write_png(
        str(path).encode(), img.ctypes.data_as(_F32P), img.shape[1], img.shape[0]
    )
    if rc != 0:
        raise IOError(f"sift_write_png({path}) failed with code {rc}")


def imread(path: str | os.PathLike) -> np.ndarray:
    """Read a PGM/PPM/PNG image as (H, W) float32 grayscale in [0, 1]."""
    readers = {".pgm": read_pgm, ".ppm": read_ppm, ".png": read_png}
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in readers:
        raise IOError(f"{path}: unsupported image extension {ext!r} "
                      f"(supported: {sorted(readers)})")
    return readers[ext](path)


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
    """Pinhole view of a deterministic 3-D blob cloud (real parallax), native
    path; NumPy fallback (:func:`_render_frame_numpy`) where the library
    cannot be built."""
    lib = _load()
    if lib is None:
        return _render_frame_numpy(size, rvec, tvec, focal, seed)
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


_M64 = (1 << 64) - 1


def _uniforms(state: int, n: int) -> tuple[np.ndarray, int]:
    """``n`` draws of the native library's ``uniform01`` (xorshift64*) from
    ``state``, and the state after them."""
    out = np.empty(n, np.float32)
    s = state
    for k in range(n):
        s ^= s >> 12
        s ^= (s << 25) & _M64
        s ^= s >> 27
        out[k] = ((s * 0x2545F4914F6CDD1D) & _M64) >> 40
    return out * np.float32(1.0 / 16777216.0), s


def _f32_bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.uint32))


def _render_frame_numpy(size: int, rvec, tvec, focal: float, seed: int) -> np.ndarray:
    """NumPy form of the native ``sift_render_frame``: the same generator,
    scene and noise in float32, blob by blob (``exp`` may differ from the C
    library's in the last bit)."""
    f32 = np.float32
    rv = np.asarray(rvec, f32)
    tv = np.asarray(tvec, f32)
    th = np.sqrt(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2])
    R = np.eye(3, dtype=f32)
    if th > f32(1e-8):
        kx, ky, kz = rv[0] / th, rv[1] / th, rv[2] / th
        c, s, v = np.cos(th), np.sin(th), f32(1.0) - np.cos(th)
        R = np.array([[c + kx * kx * v, kx * ky * v - kz * s, kx * kz * v + ky * s],
                      [ky * kx * v + kz * s, c + ky * ky * v, ky * kz * v - kx * s],
                      [kz * kx * v - ky * s, kz * ky * v + kx * s, c + kz * kz * v]], f32)
    out = np.full((size, size), 0.5, f32)
    focal = f32(focal)
    centre = f32(size) * f32(0.5)
    draws, _ = _uniforms((seed * 0x9E3779B97F4A7C15 + 777) & _M64, 5 * 220)
    for b in range(220):
        d = draws[5 * b: 5 * b + 5]
        X, Y = (d[0] - f32(0.5)) * f32(12.0), (d[1] - f32(0.5)) * f32(9.0)
        Z, wsig = f32(6.0) + d[2] * f32(12.0), f32(0.05) + d[3] * f32(0.12)
        amp = (d[4] - f32(0.5)) * f32(0.9)
        xc = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z + tv[0]
        yc = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z + tv[1]
        zc = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z + tv[2]
        if zc < f32(0.5):
            continue
        u = focal * xc / zc + centre
        v = focal * yc / zc + centre
        sig = max(focal * wsig / zc, f32(0.8))
        r = int(f32(3.0) * sig) + 1
        if u + r < 0 or u - r >= size or v + r < 0 or v - r >= size:
            continue
        y0, y1 = max(int(v) - r, 0), min(int(v) + r, size - 1)
        x0, x1 = max(int(u) - r, 0), min(int(u) + r, size - 1)
        inv = f32(1.0) / (f32(2.0) * sig * sig)
        dy2 = (np.arange(y0, y1 + 1, dtype=f32) - v) ** 2
        dx2 = (np.arange(x0, x1 + 1, dtype=f32) - u) ** 2
        out[y0:y1 + 1, x0:x1 + 1] += amp * np.exp(-(dx2[None, :] + dy2[:, None]) * inv)
    pose_hash = 0
    for i in range(3):
        pose_hash = ((pose_hash * 0x100000001B3) & _M64) ^ _f32_bits(rv[i])
        pose_hash = ((pose_hash * 0x100000001B3) & _M64) ^ _f32_bits(tv[i])
    noise, _ = _uniforms((seed * 0x2545F4914F6CDD1D + 99991 + pose_hash) & _M64, size * size)
    out += f32(0.02) * (noise.reshape(size, size) - f32(0.5))
    return np.clip(out, f32(0.0), f32(1.0))


class FrameLoader:
    """Prefetching frame source on the host library's ring of buffers:
    ``n_threads`` native workers fill ``n_buffers`` slots with
    :func:`synth_frame` frames ahead of the consumer, so frame generation
    overlaps device work.

    :meth:`next_frame` returns ``(frame_idx, (size, size) float32 array)`` in
    STRICT frame order: the workers finish frames in any order, and a frame
    that comes early waits here for its turn. Works as a context manager;
    :meth:`close` is idempotent. There is no NumPy form: where the host
    library cannot be built, the constructor raises.
    """

    def __init__(self, size: int, n_buffers: int = 4, n_threads: int = 2, seed: int = 0):
        self._handle = None
        self._lib = _require()
        self._size = size
        self._next = 0
        self._pending: dict[int, np.ndarray] = {}
        self._handle = self._lib.sift_loader_create(size, n_buffers, n_threads,
                                                    ctypes.c_uint64(seed))
        if not self._handle:
            raise RuntimeError(f"sift_loader_create({size}, {n_buffers}, {n_threads}) failed")

    def _acquire(self) -> tuple[int, np.ndarray]:
        idx = ctypes.c_int()
        ptr = self._lib.sift_loader_acquire(self._handle, ctypes.byref(idx))
        out = np.ctypeslib.as_array(ptr, shape=(self._size, self._size)).copy()
        self._lib.sift_loader_release(self._handle, ptr)   # the slot refills now
        return idx.value, out

    def next_frame(self) -> tuple[int, np.ndarray]:
        if not self._handle:
            raise RuntimeError("FrameLoader is closed")
        while self._next not in self._pending:
            idx, arr = self._acquire()
            self._pending[idx] = arr
        i = self._next
        self._next += 1
        return i, self._pending.pop(i)

    def close(self) -> None:
        if self._handle:
            self._lib.sift_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def now_ms() -> float:
    """Monotonic milliseconds from the host library's steady clock."""
    return float(_require().sift_now_ms())
