"""Kernel 3 (the fused score tables) and the block-reduce detection branch of
the port against the JAX package on CPU.

The port's plain versions run here; the CUDA kernel is held to them on the
card (tests/test_torch_cuda.py, chip_smoke.py). The JAX Pallas kernel runs in
interpret mode, as tests/test_detect_fused.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.core import pyramid_ref as jpr
from sift_parallel_optimization_tpu.models import detect as jdet
from sift_parallel_optimization_tpu.models import frontend as jfe
from sift_parallel_optimization_tpu.ops import detect_fused as jdf
from sift_parallel_optimization_tpu_torch.models import detect as tdet
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.ops import score_tables as tst

from test_torch_detect import assert_same_keypoints, dogs256  # noqa: F401  (fixture)

THR = jdet.CONTRAST_THRESHOLD / 3


def _span_entries(tv, ti, ws, row_stride):
    """{(plane, row, span): (value, column)} of the positive table entries;
    ``row_stride`` is the score-row count the flat indices were formed with."""
    out = {}
    for v, i in zip(np.asarray(tv).reshape(-1), np.asarray(ti).reshape(-1)):
        if v > 0:
            scp, rem = divmod(int(i), row_stride * ws)
            ry, col = divmod(rem, ws)
            key = (scp, ry, col // tst.SPAN)
            assert key not in out, key
            out[key] = (float(v), col)
    return out


@pytest.mark.parametrize("shape", [(128, 128), (192, 256)])
def test_score_tables_rows_matches_pallas(rng, shape):
    h, w = shape
    dog = (0.2 * rng.normal(size=(5, h, w))).astype(np.float32)
    tv_p, ti_p = jdf.fused_score_tables(jdf.pad_dog(jnp.asarray(dog)), 3, THR,
                                        jdet.EDGE_RATIO, interpret=True)
    tv, ti = tst.score_tables_rows(torch.from_numpy(dog), THR, jdet.EDGE_RATIO)
    hs, ws = h - 2, w - 2
    assert tv.shape == ti.shape == (3, hs, -(-ws // 64)) and ti.dtype == torch.int32
    got = _span_entries(tv.numpy(), ti.numpy(), ws, hs)
    pallas = _span_entries(tv_p, ti_p, ws, hs + 8)   # Pallas rows stride H+6
    # tests/test_detect_fused.py's tolerance: separately compiled programs
    # contract FMAs differently, so borderline candidates may flip, values
    # agree to rtol 1e-5 and an argmax may move to a within-noise tie.
    score = tdet.dense_score(torch.from_numpy(dog), THR, jdet.EDGE_RATIO, 1).numpy()
    flips = len(set(got) ^ set(pallas))
    assert flips <= max(2, 0.01 * len(pallas)), (flips, len(pallas))
    assert len(pallas) > 10, "test volume too sparse to be meaningful"
    for key in set(got) & set(pallas):
        (v, col), (m, pcol) = got[key], pallas[key]
        np.testing.assert_allclose(v, m, rtol=1e-5)
        if col != pcol:
            scp, ry, _ = key
            assert abs(score[scp, ry, pcol] - v) <= 1e-5 * v, (key, col, pcol)
    # Against the JAX dense score (bitwise equal to the port's on the CPU):
    # every span's max and FIRST argmax exactly.
    want = np.asarray(jdet._dense_score(jnp.asarray(dog), jfe.sift_config(256),
                                        jdet.CONTRAST_THRESHOLD, jdet.EDGE_RATIO, 1))
    padded = np.pad(want, ((0, 0), (0, 0), (0, tv.shape[2] * 64 - ws)))
    spans = padded.reshape(3, hs, -1, 64)
    np.testing.assert_array_equal(tv.numpy(), spans.max(-1))
    cols = spans.argmax(-1) + 64 * np.arange(tv.shape[2])
    np.testing.assert_array_equal(
        ti.numpy(), (np.arange(3 * hs).reshape(3, hs, 1) * ws + cols).astype(np.int32))


def test_score_tables_rows_takes_any_shape(rng):
    # The TPU's W % 128, H % 64 and 8-row pad are not ported.
    dog = (0.2 * rng.normal(size=(4, 37, 70))).astype(np.float32)
    tv, ti = tst.score_tables_rows(torch.from_numpy(dog), THR, jdet.EDGE_RATIO)
    assert tv.shape == (2, 35, 2)
    score = tdet.dense_score(torch.from_numpy(dog), THR, jdet.EDGE_RATIO, 1)
    assert float(tv.max()) == float(score.max()) > 0
    assert int(ti.max()) < score.numel()


def _jax_keys(dog, refine_iters, jit):
    """The JAX package's per-voxel (f32 score, int32 key) of one DoG octave.
    Under ``jit`` XLA may contract products and sums into FMAs, which moves a
    score by an ulp on some inputs; eager JAX rounds every op like the port."""
    cfg = jfe.sift_config(256)
    wrap = jax.jit if jit else (lambda f: f)
    if refine_iters:
        score, key = wrap(lambda x: jdet._dense_score(
            x, cfg, jdet.CONTRAST_THRESHOLD, jdet.EDGE_RATIO, 1, want_hops=True))(
                jnp.asarray(dog))
    else:
        score = wrap(lambda x: jdet._dense_score(
            x, cfg, jdet.CONTRAST_THRESHOLD, jdet.EDGE_RATIO, 0))(jnp.asarray(dog))
        key = jax.lax.bitcast_convert_type(score, jnp.int32)
    return np.asarray(score).reshape(-1), np.asarray(key).reshape(-1)


def _assert_tables_match_jax(dogs, refine_iters, tables, dense, jit=True):
    """One frame's ``tables`` (vals, idx, score) of score_block_top2 equal
    JAX's _dense_score(want_hops=True) + _block_top2 exactly (refine 0: the
    f32 score's bits), the small octaves' keys JAX's per-voxel keys. Returns
    the number of positive table entries."""
    vals, idx, score = tables
    lay = tst.table_layout(tuple(d.shape for d in dogs))
    assert [o.dense for o in lay] == dense
    assert vals.dtype == torch.int32 and idx.dtype == torch.int64
    assert vals.shape == idx.shape == (lay[-1].out_off + lay[-1].n,)
    n_pos = 0
    for o, d in zip(lay, dogs):
        jscore, key = _jax_keys(d, refine_iters, jit)
        got_v = vals[o.out_off:o.out_off + o.n].numpy()
        got_i = idx[o.out_off:o.out_off + o.n].numpy() - o.g_base
        if o.dense:
            np.testing.assert_array_equal(got_v, key)
            np.testing.assert_array_equal(got_i, np.arange(o.vg))
            np.testing.assert_array_equal(
                score[o.score_off:o.score_off + o.vg].numpy(), jscore)
            n_pos += int((key > 0).sum())
            continue
        nb = o.n // 2
        rows = jnp.asarray(np.pad(key, (0, nb * 64 - o.vg)).reshape(nb, 64))
        tv1, ta1, tv2, ta2 = (np.asarray(t) for t in jax.jit(jdet._block_top2)(rows))
        want_v = np.concatenate([tv1, tv2])
        want_i = np.minimum(np.concatenate([ta1, ta2]) + 64 * np.tile(np.arange(nb), 2),
                            o.vg - 1)
        np.testing.assert_array_equal(got_v, want_v)
        # An all-zero block's runner-up index depends on XLA's reduce
        # identity; only entries that can become keypoints must agree.
        pos = want_v > 0
        np.testing.assert_array_equal(got_i[pos], want_i[pos])
        n_pos += int(pos.sum())
    return n_pos


@pytest.mark.parametrize("refine_iters", [0, 1])
def test_score_block_top2_matches_jax_tables(dogs256, refine_iters):
    """Every octave of a real 256^2 pyramid: the block tables equal JAX's
    _dense_score(want_hops=True) + _block_top2 exactly (refine 0: the f32
    score's bits), the small octaves' keys equal JAX's per-voxel keys."""
    shapes = tuple(d.shape for d in dogs256)
    flat = torch.from_numpy(np.concatenate([d.reshape(-1) for d in dogs256]))
    # One frame: the B = 1 case of the (B, L) contract.
    tables = tuple(t[0] for t in tst.score_block_top2(
        flat[None], shapes, THR, jdet.EDGE_RATIO, refine_iters))
    n_pos = _assert_tables_match_jax(dogs256, refine_iters, tables,
                                     [False, False, False, True, True, True])
    assert n_pos > 20


# The contract the tiled CUDA kernel must meet (held to the plain version on
# the card, bit for bit), pinned here on inputs its design can get wrong:
# octaves with odd sides, whose 64-voxel blocks straddle score planes and whose
# rows start at odd offsets of the flat DoG; large constant regions (the
# extremum test is not strict: it holds on every voxel there); a two-level
# DoG, where EVERY voxel is an extremum of a cube that is not constant; and a
# frame count that is no power of two.
ODD_OCTAVES = ((5, 131, 77), (5, 66, 39), (5, 33, 20))


def _contract_frame(kind, seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in ODD_OCTAVES:
        a = 0.05 * rng.normal(size=s)
        if kind == "constant regions":
            a[:, : s[1] // 2, :] = 0.0
            a[:, :, : s[2] // 3] = 0.25
        elif kind == "two levels":
            a = np.where(rng.random(size=s) < 0.5, -0.03, 0.04)
        out.append(a.astype(np.float32))
    return out


@pytest.mark.parametrize("refine_iters", [0, 1])
@pytest.mark.parametrize("kind,frames", [("noise", 1), ("constant regions", 1),
                                         ("two levels", 1), ("noise", 3)])
def test_score_block_top2_contract_cases_match_jax(kind, frames, refine_iters):
    dogs = [_contract_frame(kind, seed) for seed in range(frames)]
    flat = torch.from_numpy(np.stack([np.concatenate([d.reshape(-1) for d in f]) for f in dogs]))
    assert (5 * 131 * 77) % 4 == 3          # the second octave starts at an odd offset
    vals, idx, score = tst.score_block_top2(flat, ODD_OCTAVES, THR, jdet.EDGE_RATIO,
                                            refine_iters)
    assert vals.shape[0] == idx.shape[0] == score.shape[0] == frames
    for b, frame in enumerate(dogs):
        n_pos = _assert_tables_match_jax(frame, refine_iters, (vals[b], idx[b], score[b]),
                                         [False, False, True], jit=False)
        assert n_pos > 100, (kind, b, n_pos)
    if kind == "constant regions":
        # A constant cube passes the extremum test and scores 0 all the same
        # (its Hessian is 0, so the edge test fails): what lets the kernel
        # leave such voxels out of its list.
        lay = tst.table_layout(ODD_OCTAVES)
        region = vals[0, lay[2].out_off:lay[2].out_off + lay[2].vg].view(3, 31, 18)
        assert not region[:, : 33 // 2 - 2, :].any() and region.any()


def test_score_tables_score_zero_where_the_cube_holds_a_nan():
    """dense_score takes its window max / min with torch.maximum / minimum,
    which propagate a NaN: a voxel with a NaN anywhere in its 3x3x3 cube is no
    extremum and scores 0. The CUDA kernel is held to the same tables."""
    rng = np.random.default_rng(5)
    shape = (5, 30, 40)
    clean = (0.05 * rng.normal(size=shape)).astype(np.float32)
    dog = clean.copy()
    hit = rng.random(size=shape) < 0.01
    dog[hit] = np.nan
    near = torch.nn.functional.max_pool3d(
        torch.from_numpy(hit[None, None].astype(np.float32)), 3, stride=1)[0, 0].bool()
    for refine_iters in (0, 1):
        vals, _idx, score = (t[0] for t in tst.score_block_top2(
            torch.from_numpy(dog.reshape(1, -1)), (shape,), THR, jdet.EDGE_RATIO, refine_iters))
        want = tst.score_block_top2(torch.from_numpy(clean.reshape(1, -1)), (shape,), THR,
                                    jdet.EDGE_RATIO, refine_iters)[0][0]
        assert vals.shape == (3 * 28 * 38,)            # under 4096 voxels: every voxel
        assert not vals.view(3, 28, 38)[near].any() and not torch.isnan(score).any()
        assert torch.equal(vals.view(3, 28, 38)[~near], want.view(3, 28, 38)[~near])
        assert int((vals > 0).sum()) > 50


@pytest.mark.parametrize("kind", ["noise", "constant regions", "two levels"])
def test_score_tables_rows_contract_cases_match_jax(kind):
    """The rows tables on the odd octaves: every span's max and FIRST argmax
    of the JAX dense score, exactly."""
    for dog in _contract_frame(kind, 7):
        tv, ti = tst.score_tables_rows(torch.from_numpy(dog), THR, jdet.EDGE_RATIO)
        want = np.asarray(jdet._dense_score(jnp.asarray(dog), jfe.sift_config(256),
                                            jdet.CONTRAST_THRESHOLD, jdet.EDGE_RATIO, 1))
        s, hs, ws = want.shape
        nsp = -(-ws // 64)
        assert tv.shape == ti.shape == (s, hs, nsp)
        spans = np.pad(want, ((0, 0), (0, 0), (0, nsp * 64 - ws))).reshape(s, hs, nsp, 64)
        np.testing.assert_array_equal(tv.numpy(), spans.max(-1))
        cols = spans.argmax(-1) + 64 * np.arange(nsp)
        np.testing.assert_array_equal(
            ti.numpy(), (np.arange(s * hs).reshape(s, hs, 1) * ws + cols).astype(np.int32))
        assert (tv > 0).sum() > 10


@pytest.mark.parametrize("kw", [
    {"refine_iters": 0}, {"refine_iters": 1}, {"refine_iters": 1, "adaptive_hop": True},
])
def test_block_reduce_detect_matches_jax(dogs256, kw):
    jcfg = jfe.sift_config(256)
    want = jax.jit(lambda d: jdet.detect_pyramid(d, jcfg, 256, use_approx_topk=True, **kw))(
        [jnp.asarray(d) for d in dogs256])
    got = tdet.detect_pyramid([torch.from_numpy(d.copy()) for d in dogs256],
                              tfe.sift_config(256), 256, use_approx_topk=True, **kw)
    assert int(got.count()) > 20
    assert_same_keypoints(got, want)


def _textured(size, seed):
    """tests/test_sift_frontend.py's blob-rich frame."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0.5, 0.5, (size, size))
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for _ in range(3):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 0, img)
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
    return np.clip(img, 0, 1).astype(np.float32)


def test_block_reduce_recall_vs_exact():
    cfg = jfe.sift_config(256)
    g = jpr.sift_gaussian_pyramid(jnp.asarray(_textured(256, 0)), cfg)
    dogs = [torch.from_numpy(np.array(o[1:] - o[:-1])) for o in g]

    def keyset(kp):
        v = kp.valid.numpy()
        return set(zip(*(np.round(f.numpy()[v], 3) for f in (kp.x, kp.y, kp.sigma))))

    exact = keyset(tdet.detect_pyramid(dogs, tfe.sift_config(256), 64, use_approx_topk=False))
    approx = keyset(tdet.detect_pyramid(dogs, tfe.sift_config(256), 64, use_approx_topk=True))
    assert len(exact) >= 30, f"test image too sparse: {len(exact)} keypoints"
    recall = len(exact & approx) / len(exact)
    assert recall >= 0.95, f"block-reduce recall {recall:.3f}"


def test_branch_defaults_follow_the_device(dogs256, monkeypatch):
    """use_approx_topk=None is the exact branch on a CPU tensor, and the
    frontend passes the branch switches through to detection."""
    tdogs = [torch.from_numpy(d.copy()) for d in dogs256]
    cfg = tfe.sift_config(256)
    default = tdet.detect_pyramid(tdogs, cfg, 128)
    exact = tdet.detect_pyramid(tdogs, cfg, 128, use_approx_topk=False)
    for a, b in zip(default, exact):
        assert torch.equal(a, b)
    calls = []
    monkeypatch.setattr(tst, "score_block_top2",
                        lambda *a: calls.append(a) or tst.score_block_top2_plain(*a))
    fe = tfe.SiftFrontend(cfg, max_keypoints=64, device="cpu", use_approx_topk=True,
                          adaptive_hop=True)
    assert fe.thresholds == {"use_approx_topk": True, "adaptive_hop": True}
    fe.detect([torch.zeros(6, 40, 40), torch.zeros(6, 20, 20)])
    assert len(calls) == 1
