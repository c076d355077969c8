"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, ``build/kernels/libsift_kernels.so`` at the
repository root, loaded with ctypes. The library is rebuilt when the hash of
the sources and flags changes. Pointers and the CUDA stream travel as
``c_void_p``. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libsift_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """sha256 over the flags and every source's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc_jobs(cmds: list[list[str]]) -> None:
    """Run the nvcc commands at once; raise with every failure's output."""
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in jobs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(force: bool = False) -> float:
    """Compile the kernels if the sources changed; returns build seconds
    (0.0 when the library on disk is current)."""
    digest = source_hash()
    stamp = LIB_PATH.with_suffix(".sha256")
    if (not force and LIB_PATH.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return 0.0
    nvcc = _nvcc()
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}")
    t0 = time.perf_counter()
    _nvcc_jobs([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)])
    _nvcc_jobs([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    return time.perf_counter() - t0


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sift_reference_dog_pyramid.restype = i
        lib.sift_reference_dog_pyramid.argtypes = [p, p, p, i, i, i, p]
        lib.sift_patch_gather.restype = i
        lib.sift_patch_gather.argtypes = [p, p, p, p, i, i, ll, i, ll, i, i, i, p]
        f = ctypes.c_float
        lib.sift_score_tables_rows.restype = i
        lib.sift_score_tables_rows.argtypes = [p, i, i, i, f, f, f, p, p, p]
        lib.sift_score_block_top2.restype = i
        lib.sift_score_block_top2.argtypes = [p, p, i, i, i, ll, ll, ll, f, f, f, i, p, p, p, p]
        lib.sift_gather_resample.restype = i
        lib.sift_gather_resample.argtypes = [p, i, i, p, p, p, i, i, p, p, p]
        lib.sift_descriptor_hist.restype = i
        lib.sift_descriptor_hist.argtypes = [p, p, p, p, p, p, p, ll, i, i, p, p]
        bind_bf16x3(lib)
        _lib = lib
        return _lib


def bind_bf16x3(lib: ctypes.CDLL) -> None:
    """The C signatures of kernel 5's entry points (``csrc/bf16x3_mm.cu``)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sift_bf16x3_bmm.restype = i
    lib.sift_bf16x3_bmm.argtypes = [p, p, p, p, p, i, i, i, i, i, *[ll] * 11, p]
    lib.sift_bf16x3_bmm_attributes.restype = i
    lib.sift_bf16x3_bmm_attributes.argtypes = [i, i, i, p]


def check_launch(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
