"""The port's host library (``csrc/sift_host.cpp`` through ``utils/native``):
the ring ``FrameLoader`` against ``synth_frame`` and against the JAX
package's loader, a build without libpng, the clock, and PNG round trips
where libpng exists."""

import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from sift_parallel_optimization_tpu.utils import native as jnative
from sift_parallel_optimization_tpu_torch.utils import native as tnative

HOST_SRC = Path(tnative.__file__).resolve().parents[1] / "csrc" / "sift_host.cpp"


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's library, loaded after the port's (a failure it may
    have cached in this process, from a library another worker's build left
    half-written, cleared)."""
    assert tnative.available(), tnative.build_error()
    if jnative._load() is None:
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_build_error", None)
    assert jnative.available(), jnative.build_error()
    return jnative


@pytest.mark.parametrize("size,n_threads", [(96, 1), (128, 3)])
def test_loader_frames_in_order_and_equal_to_synth_and_jax(jax_native, size, n_threads):
    """Twelve frames through the port's ring (several workers finish out of
    order) come back in frame order, bitwise equal to synth_frame and to the
    JAX package's FrameLoader's frames."""
    with tnative.FrameLoader(size, n_buffers=3, n_threads=n_threads, seed=5) as t, \
            jax_native.FrameLoader(size, n_buffers=3, n_threads=n_threads, seed=5) as j:
        for k in range(12):
            i, frame = t.next_frame()
            ij, fj = j.next_frame()
            assert i == ij == k and frame.shape == (size, size) and frame.dtype == np.float32
            np.testing.assert_array_equal(frame, tnative.synth_frame(size, k, seed=5))
            np.testing.assert_array_equal(frame, fj)


@pytest.mark.parametrize("size", [49, 64, 97, 256])
def test_frames_equal_the_jax_library(jax_native, size):
    """synth_frame at sizes above 48 (where both libraries wrap a blob the
    same way), two frames and two seeds, and render_frame at one pose:
    bitwise equal to the JAX package's library, so an edit to either copy
    of sift_host.cpp that makes the frames drift fails here."""
    for idx, seed in ((0, 0), (7, 3)):
        np.testing.assert_array_equal(tnative.synth_frame(size, idx, seed=seed),
                                      jax_native.synth_frame(size, idx, seed=seed))
    rvec = np.array([0.02, -0.05, 0.01], np.float32)
    tvec = np.array([-0.4, 0.1, 0.3], np.float32)
    got = tnative.render_frame(size, rvec, tvec, float(size), seed=2)
    assert got.shape == (size, size) and got.std() > 0
    np.testing.assert_array_equal(got, jax_native.render_frame(size, rvec, tvec, float(size),
                                                               seed=2))


def test_loader_close_is_idempotent_and_final():
    ld = tnative.FrameLoader(64, n_buffers=2, n_threads=2)
    assert ld.next_frame()[0] == 0
    ld.close()
    ld.close()
    with pytest.raises(RuntimeError, match="closed"):
        ld.next_frame()


def test_now_ms_is_monotone():
    stamps = [tnative.now_ms()]
    for _ in range(5):
        time.sleep(0.002)
        stamps.append(tnative.now_ms())
    steps = np.diff(stamps)
    assert (steps >= 1.5).all() and (steps < 1000).all(), stamps


def test_library_without_libpng_serves_frames(tmp_path, monkeypatch):
    """The library built without SIFT_HAVE_PNG (as on a machine without
    libpng): frames and the loader work and equal the full build's; PNG
    reads and writes raise; PGM still round-trips."""
    shutil.copy(HOST_SRC, tmp_path / "sift_host.cpp")
    want = tnative.synth_frame(80, 3, seed=2)
    assert tnative.available()
    monkeypatch.setattr(tnative, "_SRC", tmp_path / "sift_host.cpp")
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_VARIANTS", (((), ()),))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    assert tnative.available() and tnative.build_error() is None and not tnative.has_png()
    np.testing.assert_array_equal(tnative.synth_frame(80, 3, seed=2), want)
    with tnative.FrameLoader(80, n_buffers=2, n_threads=2, seed=2) as ld:
        for k in range(4):
            i, frame = ld.next_frame()
            assert i == k
        np.testing.assert_array_equal(frame, want)
    img = np.linspace(0, 1, 48 * 32, dtype=np.float32).reshape(32, 48)
    with pytest.raises(RuntimeError, match="without libpng"):
        tnative.write_png(tmp_path / "a.png", img)
    (tmp_path / "b.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(32))
    with pytest.raises(RuntimeError, match="without libpng"):
        tnative.read_png(tmp_path / "b.png")
    tnative.write_pgm(tmp_path / "a.pgm", img)
    np.testing.assert_allclose(tnative.read_pgm(tmp_path / "a.pgm"), img, atol=1 / 255)


def test_failed_build_is_reported_and_the_loader_raises(tmp_path, monkeypatch):
    """A source that does not compile: available() is False, build_error()
    says why, the frame functions fall back to NumPy and the loader raises
    (it has no NumPy form)."""
    (tmp_path / "sift_host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", tmp_path / "sift_host.cpp")
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    assert not tnative.available()
    assert "building the host library failed" in tnative.build_error()
    np.testing.assert_array_equal(tnative.synth_frame(64, 1, seed=0),
                                  tnative._synth_frame_numpy(64, 1, 0))
    with pytest.raises(RuntimeError, match="native lib unavailable"):
        tnative.FrameLoader(64)


def test_png_round_trip(tmp_path, jax_native):
    """Where libpng exists (as here): the port writes a PNG that it and the
    JAX package read back to the same 8-bit values."""
    if not tnative.has_png():
        pytest.skip("the host library was built without libpng on this machine")
    img = np.random.default_rng(0).random((24, 40)).astype(np.float32)
    tnative.write_png(tmp_path / "a.png", img)
    back = tnative.read_png(tmp_path / "a.png")
    assert back.shape == img.shape
    np.testing.assert_allclose(back, np.round(img * 255) / 255, atol=1e-6)
    np.testing.assert_array_equal(back, jax_native.read_png(tmp_path / "a.png"))
    np.testing.assert_array_equal(tnative.imread(tmp_path / "a.png"), back)
