"""The port's trajectory tools (``utils/trajectory``) against the JAX
package on the CPU: Umeyama alignment and ATE, the TUM and KITTI files each
package writes read back by the other, quaternions, and timestamp
association."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models.geometry import rodrigues as jrodrigues
from sift_parallel_optimization_tpu.utils import trajectory as jtraj
from sift_parallel_optimization_tpu_torch.utils import trajectory as ttraj

# fp32 alignments of O(1)-sized point sets: the two SVDs may differ in sign
# and in the last bits; (s, R, t) and the aligned points agree to 1e-5.
ALIGN_ATOL = 1e-5
# Written files round to 6 (TUM) or 9 (KITTI) decimals.
TUM_ATOL, KITTI_ATOL = 2e-6, 1e-6


def _similarity_pair(rng, n=30, noise=0.0):
    src = rng.normal(size=(n, 3)).astype(np.float32)
    R = np.asarray(jrodrigues(jnp.asarray([0.3, -0.2, 0.5])))
    dst = 1.7 * src @ R.T + np.array([1.0, -2.0, 0.5], np.float32)
    dst = (dst + noise * rng.normal(size=dst.shape)).astype(np.float32)
    return src, dst, R


@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_umeyama_and_ate_match_jax(rng, with_scale, noise):
    src, dst, R = _similarity_pair(rng, noise=noise)
    js, jR, jt = jax.jit(jtraj.umeyama_alignment, static_argnums=2)(
        jnp.asarray(src), jnp.asarray(dst), with_scale)
    s, R2, t = ttraj.umeyama_alignment(torch.from_numpy(src), torch.from_numpy(dst), with_scale)
    # Compare (s, R, t), never U or V.
    np.testing.assert_allclose(float(s), float(js), atol=ALIGN_ATOL)
    np.testing.assert_allclose(R2.numpy(), np.asarray(jR), atol=ALIGN_ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=10 * ALIGN_ATOL)
    want = float(jax.jit(jtraj.ate_rmse, static_argnums=2)(
        jnp.asarray(src), jnp.asarray(dst), with_scale))
    got = float(ttraj.ate_rmse(torch.from_numpy(src), torch.from_numpy(dst), with_scale))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=ALIGN_ATOL)
    if with_scale and noise == 0.0:
        assert abs(float(s) - 1.7) < 1e-3 and got < 1e-3
        np.testing.assert_allclose(R2.numpy(), R, atol=1e-4)


def test_reflection_case_keeps_a_rotation(rng):
    """A mirrored point set: the sign fix keeps det(R) = +1, as in JAX."""
    src = rng.normal(size=(20, 3)).astype(np.float32)
    dst = src * np.array([1, 1, -1], np.float32)
    _s, R, _t = ttraj.umeyama_alignment(torch.from_numpy(src), torch.from_numpy(dst))
    _js, jR, _jt = jtraj.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst))
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=ALIGN_ATOL)


def _poses(rng, n=7):
    rv = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    rv[0] = 0.0
    rv[1] = [0.0, np.pi - 1e-3, 0.0]           # near pi: the quaternion's other branch
    tv = rng.normal(size=(n, 3)).astype(np.float32)
    return rv, tv


def test_camera_centers_match_jax(rng):
    rv, tv = _poses(rng)
    want = np.asarray(jtraj.camera_centers(jnp.asarray(rv), jnp.asarray(tv)))
    got = ttraj.camera_centers(torch.from_numpy(rv), torch.from_numpy(tv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_trajectory_files_cross_read(tmp_path, rng, fmt):
    """A file the port writes reads back through the JAX package, and the
    other way round, to the files' printed precision."""
    rv, tv = _poses(rng)
    ts = np.arange(len(rv)) * 0.1 + 1000.0
    mine, theirs = tmp_path / "port.txt", tmp_path / "jax.txt"
    if fmt == "tum":
        ttraj.save_tum(mine, ts, torch.from_numpy(rv), torch.from_numpy(tv))
        jtraj.save_tum(theirs, ts, jnp.asarray(rv), jnp.asarray(tv))
        a, b = jtraj.load_tum(mine), ttraj.load_tum(theirs)
        c = ttraj.load_tum(mine)
        np.testing.assert_array_equal(a[0], c[0])
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=TUM_ATOL)
        # The quaternions are the rotations: back to matrices in both packages.
        want = np.asarray(jtraj.quat_to_rotmat(b[2]))
        got = ttraj.quat_to_rotmat(a[2], device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        R_wc = np.swapaxes(np.asarray(jrodrigues(jnp.asarray(rv))), 1, 2)
        np.testing.assert_allclose(got, R_wc, atol=1e-5)
    else:
        ttraj.save_kitti(mine, torch.from_numpy(rv), torch.from_numpy(tv))
        jtraj.save_kitti(theirs, jnp.asarray(rv), jnp.asarray(tv))
        a, b = jtraj.load_kitti(mine), ttraj.load_kitti(theirs)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=KITTI_ATOL)
    centers = ttraj.camera_centers(torch.from_numpy(rv), torch.from_numpy(tv)).numpy()
    np.testing.assert_allclose(a[1] if fmt == "tum" else a[0], centers, atol=TUM_ATOL)


def test_associate_and_bad_files(tmp_path):
    ts_a = [0.0, 0.1, 0.2, 0.31, 0.5, 0.9]
    ts_b = [0.305, 0.0, 0.21, 0.1, 0.11, 2.0]
    for max_dt in (0.005, 0.02, 0.5):
        ia, ib = ttraj.associate(ts_a, ts_b, max_dt)
        ja, jb = jtraj.associate(ts_a, ts_b, max_dt)
        np.testing.assert_array_equal(ia, ja)
        np.testing.assert_array_equal(ib, jb)
    assert len(set(ttraj.associate(ts_a, ts_b, 0.5)[1].tolist())) == len(
        ttraj.associate(ts_a, ts_b, 0.5)[1])
    bad = tmp_path / "bad.txt"
    bad.write_text("# only a comment\n")
    with pytest.raises(IOError, match="no poses"):
        ttraj.load_tum(bad)
    bad.write_text("1 2 3\n")
    with pytest.raises(IOError, match="bad KITTI line"):
        ttraj.load_kitti(bad)
    if not torch.cuda.is_available():
        # An array goes to the card unless the CPU is asked for.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttraj.quat_to_rotmat(np.array([[0.0, 0.0, 0.0, 1.0]]))
