"""The port's matcher and both RANSACs against the JAX package on the CPU.

Matching: ``idx2`` and ``valid`` equal exactly, similarity within 1e-6 (one
fp32 product of unit vectors, summed in another order). RANSAC: the JAX
package's own ``_sample_indices`` draws are injected into the port, so both
score the same hypotheses; the best inlier mask must be the same and the
model equal up to scale and sign within 1e-3 of its unit-norm entries: the
homography is refined through 8x8 normal equations with pixel^2 entries and
the fundamental matrix through two SVDs, both in fp32 (measured ~1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.models import matching as jm
from sift_parallel_optimization_tpu_torch.models import matching as tm
from sift_parallel_optimization_tpu_torch.models.keypoints import empty_keypoints

SIM_ATOL = 1e-6
MODEL_ATOL = 1e-3
# The JAX side under jax.jit, as the package's callers run it: one
# compilation per function, shared by every case, instead of one per primitive.
J_MATCH = {m: jax.jit(lambda d1, d2, v1, v2, m=m: jm.match_descriptors(d1, d2, v1, v2, mutual=m))
           for m in (True, False)}
J_DRAWS = jax.jit(jm._sample_indices, static_argnums=(2, 3))
J_HOMOGRAPHY = jax.jit(lambda k, p1, p2, m: jm.ransac_homography(k, p1, p2, m, n_hypotheses=64))
J_FUNDAMENTAL = jax.jit(lambda k, p1, p2, m: jm.ransac_fundamental(
    k, p1, p2, m, n_hypotheses=64, threshold=1.0))


def t(a):
    return torch.from_numpy(np.array(a))


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _match_case(rng, name):
    n1, n2 = 40, 48
    d2 = _unit(rng, n2)
    perm = rng.permutation(n2)[:n1]
    d1 = d2[perm] + 0.05 * rng.normal(size=(n1, 128)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    v1, v2 = np.ones(n1, bool), np.ones(n2, bool)
    if name == "ties":
        # Exact duplicates in image 2, one-hot so that every product is exact
        # in any summation order: similarities tie at exactly 1.0, the first
        # index must win on both sides and the ratio test must reject the row.
        d2[[3, 10, 11]] = np.eye(128, dtype=np.float32)[5]
        d1[0] = d2[3]
        d1[1] = d1[0]          # two rows with one best column: mutual check
    elif name == "invalid_columns":
        v2[rng.permutation(n2)[:15]] = False
        v1[::7] = False
    elif name == "all_invalid_side":
        v2[:] = False
    elif name == "zero_descriptors":
        d1[5:9] = 0.0          # invalid slots of a frontend hold zeros
        d2[20:30] = 0.0
        v1[5:9] = False
        v2[20:30] = False
    return d1, d2, v1, v2


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("name", ["plain", "ties", "invalid_columns", "all_invalid_side",
                                  "zero_descriptors"])
def test_match_descriptors_matches_jax(rng, name, mutual):
    d1, d2, v1, v2 = _match_case(rng, name)
    want = J_MATCH[mutual](jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2))
    got = tm.match_descriptors(t(d1), t(d2), t(v1), t(v2), mutual=mutual)
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(want.idx2))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.similarity.numpy(), np.asarray(want.similarity),
                               rtol=0, atol=SIM_ATOL)
    assert int(got.count()) == int(want.count())
    if name == "plain":
        assert int(got.count()) >= 36
    if name == "all_invalid_side":
        assert int(got.count()) == 0 and bool((got.idx2 == 0).all())
    if name == "ties":
        assert int(got.idx2[0]) == 3 and not bool(got.valid[0])


def test_matched_points_matches_jax(rng):
    d1, d2, v1, v2 = _match_case(rng, "invalid_columns")
    kp1 = empty_keypoints(40, "cpu")._replace(x=t(rng.uniform(0, 99, 40).astype(np.float32)),
                                       y=t(rng.uniform(0, 99, 40).astype(np.float32)),
                                       valid=t(v1))
    kp2 = empty_keypoints(48, "cpu")._replace(x=t(rng.uniform(0, 99, 48).astype(np.float32)),
                                       y=t(rng.uniform(0, 99, 48).astype(np.float32)),
                                       valid=t(v2))
    m = tm.match_descriptors(t(d1), t(d2), t(v1), t(v2))
    from sift_parallel_optimization_tpu.models.keypoints import Keypoints as JKeypoints

    jk = lambda kp: JKeypoints(*[jnp.asarray(f.numpy()) for f in kp])
    jmatch = jm.Matches(*[jnp.asarray(f.numpy()) for f in m])
    want = jax.jit(jm.matched_points)(jk(kp1), jk(kp2), jmatch)
    for g, w in zip(tm.matched_points(kp1, kp2, m), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _draws(seed, mask, n_hyp, n_pts):
    return np.array(J_DRAWS(jax.random.key(seed), jnp.asarray(mask), n_hyp, n_pts))


def _same_up_to_scale(got, want, atol=MODEL_ATOL):
    g = got / np.linalg.norm(got)
    w = want / np.linalg.norm(want)
    assert min(np.abs(g - w).max(), np.abs(g + w).max()) < atol, (g, w)


def _homography_scene(rng, n=96):
    p1 = rng.uniform(0, 256, size=(n, 2)).astype(np.float32)
    h_true = np.array([[0.9, 0.1, 5.0], [-0.08, 1.05, -3.0], [1e-4, -5e-5, 1.0]], np.float32)
    p2 = np.array(jm._apply_h(jnp.asarray(h_true), jnp.asarray(p1)))
    n_out = n * 3 // 10
    p2[:n_out] = rng.uniform(0, 256, size=(n_out, 2))
    mask = np.ones(n, bool)
    mask[-6:] = False
    return p1, p2, mask, n_out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_homography_matches_jax_with_injected_draws(rng, seed):
    p1, p2, mask, n_out = _homography_scene(rng)
    idx = _draws(seed, mask, 64, 4)
    assert mask[idx].all()
    want = J_HOMOGRAPHY(jax.random.key(seed), jnp.asarray(p1), jnp.asarray(p2),
                        jnp.asarray(mask))
    got = tm.ransac_homography(None, t(p1), t(p2), t(mask), n_hypotheses=64,
                               sample_idx=t(idx))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) >= 96 - n_out - 6 - 5
    _same_up_to_scale(got.model.numpy(), np.asarray(want.model))


def _fundamental_scene(rng, n=96, n_out=20):
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    K = np.array([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]], np.float32)
    th = 0.15
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                 np.float32)
    tr = np.array([0.5, 0.05, 0.0], np.float32)
    x1 = pts @ K.T
    p1 = np.array(x1[:, :2] / x1[:, 2:], dtype=np.float32)
    x2 = (pts @ R.T + tr) @ K.T
    p2 = np.array(x2[:, :2] / x2[:, 2:], dtype=np.float32)
    p2[:n_out] = rng.uniform(0, 256, size=(n_out, 2))
    mask = np.ones(n, bool)
    mask[-4:] = False
    return p1, p2, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_fundamental_matches_jax_with_injected_draws(rng, seed):
    p1, p2, mask = _fundamental_scene(rng)
    idx = _draws(seed, mask, 64, 8)
    want = J_FUNDAMENTAL(jax.random.key(seed), jnp.asarray(p1), jnp.asarray(p2),
                         jnp.asarray(mask))
    got = tm.ransac_fundamental(None, t(p1), t(p2), t(mask), n_hypotheses=64, threshold=1.0,
                                sample_idx=t(idx))
    # The winner is a clean sample (no repeats, no outliers): its null vector
    # is well defined in both frameworks. A point whose Sampson distance lies
    # within rounding of the threshold may flip: at most 2 of 96.
    assert len(set(idx[0])) <= 8
    diff = got.inliers.numpy() != np.asarray(want.inliers)
    assert diff.sum() <= 2, diff.sum()
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2
    assert int(got.n_inliers) >= (96 - 20 - 4) * 3 // 4
    _same_up_to_scale(got.model.numpy(), np.asarray(want.model))
    d = tm._epipolar_dist_sq(got.model, t(p1), t(p2)).numpy()
    jd = np.asarray(jax.jit(jm._epipolar_dist_sq)(want.model, jnp.asarray(p1), jnp.asarray(p2)))
    assert np.median(np.sqrt(d[20:])) < 1.0 and np.median(np.sqrt(jd[20:])) < 1.0


def test_epipolar_distance_and_apply_h_match_jax(rng):
    p1, p2, _mask = _fundamental_scene(rng)
    f = rng.normal(size=(5, 3, 3)).astype(np.float32)
    want = jax.jit(jax.vmap(
        lambda ff: jm._epipolar_dist_sq(ff, jnp.asarray(p1), jnp.asarray(p2))))(jnp.asarray(f))
    np.testing.assert_allclose(tm._epipolar_dist_sq(t(f), t(p1), t(p2)).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)
    want = jax.jit(jax.vmap(lambda hh: jm._apply_h(hh, jnp.asarray(p1))))(jnp.asarray(f))
    np.testing.assert_allclose(tm._apply_h(t(f), t(p1)).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


def test_normalize_points_matches_jax(rng):
    p = rng.uniform(100, 900, size=(6, 8, 2)).astype(np.float32)
    w = np.ones((6, 8), np.float32)
    want = jax.jit(jax.vmap(jm._normalize_points))(jnp.asarray(p), jnp.asarray(w))
    got = tm._normalize_points(t(p), t(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["homography", "fundamental"])
def test_ransac_with_singular_samples_does_not_raise(rng, which):
    """Samples made of one repeated point give exactly singular systems
    (``torch.linalg.solve`` would raise for the whole batch); they must
    score -1 and leave the clean hypotheses to win."""
    if which == "homography":
        p1, p2, mask, _n_out = _homography_scene(rng)
        n_pts, fn, kw = 4, tm.ransac_homography, {}
    else:
        p1, p2, mask = _fundamental_scene(rng)
        n_pts, fn, kw = 8, tm.ransac_fundamental, {"threshold": 1.0}
    idx = _draws(3, mask, 32, n_pts)
    idx[::2] = idx[::2, :1]                     # every other sample: one point
    idx[1, 1] = idx[1, 0]                       # and one with a single repeat
    got = fn(None, t(p1), t(p2), t(mask), n_hypotheses=32, sample_idx=t(idx), **kw)
    assert bool(torch.isfinite(got.model).all())
    assert int(got.n_inliers) >= 40
    # All singular: the model is junk but finite, and nothing is an inlier of
    # a fundamental matrix that no hypothesis backed.
    idx[:] = idx[:, :1]
    got = fn(None, t(p1), t(p2), t(mask), n_hypotheses=32, sample_idx=t(idx), **kw)
    assert bool(torch.isfinite(got.model).all())
    if which == "fundamental":
        assert int(got.n_inliers) >= 0


def test_ransac_draws_come_from_the_generator_and_the_valid_slots(rng):
    p1, p2, mask, _n_out = _homography_scene(rng)
    gen = lambda s: torch.Generator().manual_seed(s)
    idx = tm._sample_indices(gen(0), t(mask), 64, 4)
    assert idx.shape == (64, 4) and idx.dtype == torch.int64
    assert mask[idx.numpy()].all()
    assert torch.equal(idx, tm._sample_indices(gen(0), t(mask), 64, 4))
    assert not torch.equal(idx, tm._sample_indices(gen(1), t(mask), 64, 4))
    a = tm.ransac_homography(gen(5), t(p1), t(p2), t(mask), n_hypotheses=64)
    b = tm.ransac_homography(gen(5), t(p1), t(p2), t(mask), n_hypotheses=64)
    assert torch.equal(a.model, b.model) and int(a.n_inliers) >= 50
    # No valid slot: draws still come back, every hypothesis scores nothing.
    none = torch.zeros(96, dtype=torch.bool)
    res = tm.ransac_homography(gen(0), t(p1), t(p2), none, n_hypotheses=16)
    assert int(res.n_inliers) == 0
    with pytest.raises(ValueError, match="Generator or sample_idx"):
        tm.ransac_homography(None, t(p1), t(p2), t(mask))
    with pytest.raises(ValueError, match="sample_idx must be"):
        tm.ransac_fundamental(None, t(p1), t(p2), t(mask), n_hypotheses=8,
                              sample_idx=torch.zeros(8, 4, dtype=torch.int64))
