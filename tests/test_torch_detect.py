"""The port's exact detection path against the JAX package on CPU.

Both detectors get the SAME DoG pyramid (the JAX one), which isolates
detection from the pyramid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.core import pyramid_ref as jpr
from sift_parallel_optimization_tpu.models import detect as jdet
from sift_parallel_optimization_tpu.models import frontend as jfe
from sift_parallel_optimization_tpu.models import keypoints as jkp
from sift_parallel_optimization_tpu_torch.models import detect as tdet
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.models import keypoints as tkp
from sift_parallel_optimization_tpu_torch.utils import native as tnative

# Keypoint coordinates and scales: the same f32 expressions on the same
# inputs; 1e-4 px absorbs an ulp of exp2 or of a fused multiply-add in XLA.
COORD_ATOL = 1e-4


def _jax_dogs(size, S, img):
    cfg = jfe.sift_config(size, S=S)
    g = jax.jit(lambda x: jpr.sift_gaussian_pyramid(x, cfg))(jnp.asarray(img))
    return [np.asarray(o[1:] - o[:-1]) for o in g]


@pytest.fixture(scope="module")
def dogs256():
    return _jax_dogs(256, 3, tnative.synth_frame(256, 0, seed=0))


def assert_same_keypoints(got, want):
    """Equal keypoint sets slot for slot: same validity, octave and scale;
    x, y, sigma and score within COORD_ATOL."""
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert int(got.count().sum()) == int(valid.sum())
    for f in ("octave", "scale"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy()[valid], np.asarray(getattr(want, f))[valid], err_msg=f
        )
    for f in ("x", "y", "sigma", "score"):
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0,
            atol=COORD_ATOL, err_msg=f,
        )


@pytest.mark.parametrize("refine_iters", [0, 1])
def test_detect_pyramid_matches_jax(dogs256, refine_iters):
    jcfg = jfe.sift_config(256)
    tcfg = tfe.sift_config(256)
    want = jax.jit(
        lambda d: jdet.detect_pyramid(d, jcfg, 256, refine_iters=refine_iters)
    )([jnp.asarray(d) for d in dogs256])
    got = tdet.detect_pyramid(
        [torch.from_numpy(d.copy()) for d in dogs256], tcfg, 256,
        refine_iters=refine_iters,
    )
    assert int(got.count()) > 20
    assert_same_keypoints(got, want)


def test_detect_capacity_larger_than_candidates():
    # A 16^2 frame has fewer voxels than the capacity: the padded slots
    # must be invalid in both packages.
    dogs = _jax_dogs(16, 2, np.random.default_rng(2).random((16, 16), np.float32))
    jcfg = jfe.sift_config(16, S=2)
    want = jax.jit(lambda d: jdet.detect_pyramid(d, jcfg, 512))(
        [jnp.asarray(d) for d in dogs]
    )
    got = tdet.detect_pyramid([torch.from_numpy(d.copy()) for d in dogs],
                              tfe.sift_config(16, S=2), 512)
    assert got.capacity == 512
    assert_same_keypoints(got, want)


def test_dense_score_matches_jax(rng):
    dog = rng.normal(scale=0.05, size=(5, 24, 32)).astype(np.float32)
    jcfg = jfe.sift_config(32)
    for refine in (0, 1):
        want = np.asarray(jax.jit(lambda d: jdet._dense_score(
            d, jcfg, jdet.CONTRAST_THRESHOLD, jdet.EDGE_RATIO, refine
        ))(jnp.asarray(dog)))
        got = tdet.dense_score(
            torch.from_numpy(dog), tdet.CONTRAST_THRESHOLD / tfe.sift_config(32).S,
            tdet.EDGE_RATIO, refine,
        ).numpy()
        # Same candidates; values equal up to f32 contraction differences.
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_cube_fit_equals_dense_fields(rng):
    # The sparse re-fit must reproduce the dense stencil values it replaces.
    dog = torch.from_numpy(rng.normal(size=(4, 9, 11)).astype(np.float32))
    g, h = tdet._grad_hess(dog)
    off_s, off_y, off_x, _ = tdet._solve3(h, g)
    s, y, x = 1, 3, 5
    cube = dog[s:s + 3, y:y + 3, x:x + 3]
    vals = torch.stack([cube[o] for o in tdet._FIT_OFFSETS])
    fs, fy, fx, _dh, _eok = tdet._cube_fit(vals, tdet.EDGE_RATIO)
    assert float(fs) == float(off_s[s, y, x])
    assert float(fy) == float(off_y[s, y, x])
    assert float(fx) == float(off_x[s, y, x])


def test_top_k_keypoints_breaks_ties_like_lax_top_k():
    score = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.0, 0.9], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    fields = {f: np.zeros(8, np.float32) for f in jkp.Keypoints._fields}
    fields.update(score=score, valid=valid, x=np.arange(8, dtype=np.float32),
                  octave=np.zeros(8, np.int32), scale=np.ones(8, np.int32))
    want = jkp.top_k_keypoints(jkp.Keypoints(**{k: jnp.asarray(v) for k, v in fields.items()}), 5)
    got = tkp.top_k_keypoints(tkp.keypoints_from_numpy(fields, "cpu"), 5)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_empty_and_concat_keypoints_match_jax():
    want = jkp.concat_keypoints([jkp.empty_keypoints(3), jkp.empty_keypoints(2)])
    got = tkp.concat_keypoints([tkp.empty_keypoints(3, "cpu"), tkp.empty_keypoints(2, "cpu")])
    assert got.capacity == want.capacity == 5 and int(got.count()) == 0
    for f in jkp.Keypoints._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("octave,refine_iters", [(0, 1), (1, 0), (2, 1)])
def test_detect_octave_matches_jax(dogs256, octave, refine_iters):
    """One octave alone (JAX routes it through detect_octaves_batched): the
    same keypoints slot for slot, in original image units, within
    COORD_ATOL."""
    cfg = jfe.sift_config(256)
    want = jax.jit(lambda d: jdet.detect_octave(d, octave, cfg, 64, refine_iters=refine_iters))(
        jnp.asarray(dogs256[octave]))
    got = tdet.detect_octave(torch.from_numpy(np.array(dogs256[octave])), octave,
                             tfe.sift_config(256), 64, refine_iters=refine_iters)
    assert int(got.count()) > 0 and got.capacity == 64
    assert_same_keypoints(got, want)
    assert (got.octave.numpy()[got.valid.numpy()] == octave).all()


@pytest.mark.parametrize("tail_batch_side", [32, 64])
def test_tail_batch_side_matches_jax(dogs256, tail_batch_side):
    """The padded-canvas tail group (octaves of side <= tail_batch_side in
    one zero-padded canvas, the exact branch): slot for slot the JAX
    package's detect_pyramid with the same knob, and the same keypoint set
    as the native grouping (the canvas only reorders ties)."""
    jcfg, tcfg = jfe.sift_config(256), tfe.sift_config(256)
    want = jax.jit(lambda d: jdet.detect_pyramid(d, jcfg, 256, tail_batch_side=tail_batch_side))(
        [jnp.asarray(d) for d in dogs256])
    dogs = [torch.from_numpy(d.copy()) for d in dogs256]
    got = tdet.detect_pyramid(dogs, tcfg, 256, tail_batch_side=tail_batch_side)
    assert_same_keypoints(got, want)
    native = tdet.detect_pyramid(dogs, tcfg, 256)
    key = lambda kp: set(zip(kp.octave[kp.valid].tolist(), kp.scale[kp.valid].tolist(),
                             kp.x[kp.valid].round(decimals=3).tolist(),
                             kp.y[kp.valid].round(decimals=3).tolist()))
    assert key(got) == key(native)
    batched = tdet.detect_pyramid_batched([d[None].expand(2, -1, -1, -1) for d in dogs], tcfg,
                                          256, tail_batch_side=tail_batch_side)
    for f in tkp.Keypoints._fields:
        assert torch.equal(getattr(batched, f)[1], getattr(got, f)), f
    # The block-reduce branch takes the canvas group too: its whole flat
    # score row cut into 64-voxel blocks, as the JAX package cuts it.
    want = jax.jit(lambda d: jdet.detect_pyramid(d, jcfg, 256, tail_batch_side=tail_batch_side,
                                                 use_approx_topk=True))(
        [jnp.asarray(d) for d in dogs256])
    got = tdet.detect_pyramid(dogs, tcfg, 256, tail_batch_side=tail_batch_side,
                              use_approx_topk=True)
    assert int(got.count()) > 20
    assert_same_keypoints(got, want)


# Groupings of the 256^2 pyramid's six octaves (sides 256 .. 8) for the
# grouped entry points: one native group an octave; the octaves of side <= 32
# or <= 64 in one canvas group; and groups out of octave order, with native
# and canvas groups mixed, a canvas group first and a canvas under 4096 score
# voxels (the 16^2 and 8^2 octaves), which keeps every voxel.
GROUPINGS = ("native", "tail32", "tail64", "mixed", "shuffled")
GROUP_CAPACITY = 48          # under the candidates of a frame: the top-k cut matters


def _grouping(name, n_octaves, sides):
    if name == "native":
        return [[o] for o in range(n_octaves)]
    if name.startswith("tail"):
        side = int(name[4:])
        return ([[o] for o in range(n_octaves) if sides[o] > side]
                + [[o for o in range(n_octaves) if sides[o] <= side]])
    return {"mixed": [[2], [0], [1, 3]], "shuffled": [[5, 4], [1], [3, 2], [0]]}[name]


@pytest.fixture(scope="module")
def dogs256_pair(dogs256):
    """(B=2) DoG stacks per octave: frames 0 and 1 of the synthetic stream."""
    other = _jax_dogs(256, 3, tnative.synth_frame(256, 1, seed=0))
    return [np.stack([a, b]) for a, b in zip(dogs256, other)]


@pytest.mark.parametrize("use_approx_topk", [False, True], ids=["exact", "block_reduce"])
@pytest.mark.parametrize("grouping", GROUPINGS)
def test_detect_octave_groups_batched_matches_jax(dogs256_pair, grouping, use_approx_topk):
    """B = 2 frames, slot for slot against the JAX package on both branches;
    each frame alone (B = 1) against its frame of the JAX batch (a batch
    mixes no values across frames; exp2 on the CPU may round an element an
    ulp apart where the vector loop splits it differently, hence not bitwise)."""
    groups = _grouping(grouping, len(dogs256_pair), [d.shape[-1] for d in dogs256_pair])
    jcfg, tcfg = jfe.sift_config(256), tfe.sift_config(256)
    kw = dict(use_approx_topk=use_approx_topk)
    want = jax.jit(lambda s: jdet.detect_octave_groups_batched(
        [[(o, s[o]) for o in g] for g in groups], jcfg, GROUP_CAPACITY, **kw))(
        [jnp.asarray(d) for d in dogs256_pair])
    t = [torch.from_numpy(d) for d in dogs256_pair]
    got = tdet.detect_octave_groups_batched([[(o, t[o]) for o in g] for g in groups], tcfg,
                                            GROUP_CAPACITY, **kw)
    assert got.x.shape == (2, GROUP_CAPACITY) and int(got.count().sum()) > 40
    assert_same_keypoints(got, want)
    for i in range(2):
        one = tdet.detect_octave_groups([[(o, t[o][i]) for o in g] for g in groups], tcfg,
                                        GROUP_CAPACITY, **kw)
        assert_same_keypoints(one, jax.tree.map(lambda x, i=i: x[i], want))


@pytest.mark.parametrize("use_approx_topk", [False, True], ids=["exact", "block_reduce"])
@pytest.mark.parametrize("grouping", ["mixed", "shuffled"])
def test_detect_octave_groups_matches_jax(dogs256, grouping, use_approx_topk):
    """One frame (B = 1) through both packages' detect_octave_groups."""
    groups = _grouping(grouping, len(dogs256), [d.shape[-1] for d in dogs256])
    jcfg, tcfg = jfe.sift_config(256), tfe.sift_config(256)
    want = jax.jit(lambda s: jdet.detect_octave_groups(
        [[(o, s[o]) for o in g] for g in groups], jcfg, GROUP_CAPACITY,
        use_approx_topk=use_approx_topk))([jnp.asarray(d) for d in dogs256])
    got = tdet.detect_octave_groups(
        [[(o, torch.from_numpy(dogs256[o].copy())) for o in g] for g in groups], tcfg,
        GROUP_CAPACITY, use_approx_topk=use_approx_topk)
    assert int(got.count()) > 20
    assert_same_keypoints(got, want)


@pytest.mark.parametrize("use_approx_topk", [False, True], ids=["exact", "block_reduce"])
def test_detect_octaves_batched_matches_jax(dogs256, use_approx_topk):
    """Octaves 3, 1, 2 in one padded group (the 128^2 canvas), in that id
    order, through both packages' detect_octaves_batched."""
    ids = [3, 1, 2]
    jcfg, tcfg = jfe.sift_config(256), tfe.sift_config(256)
    want = jax.jit(lambda ds: jdet.detect_octaves_batched(
        ds, ids, jcfg, GROUP_CAPACITY, use_approx_topk=use_approx_topk))(
        [jnp.asarray(dogs256[o]) for o in ids])
    got = tdet.detect_octaves_batched([torch.from_numpy(dogs256[o].copy()) for o in ids], ids,
                                      tcfg, GROUP_CAPACITY, use_approx_topk=use_approx_topk)
    assert int(got.count()) > 10
    assert set(got.octave[got.valid].tolist()) <= set(ids)
    assert_same_keypoints(got, want)
