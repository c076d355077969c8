"""``blur_precision="high"`` in the port: the 3-pass bf16 product's plain
version (``ops/blur_product.py``, kernel 5's oracle), the SIFT pyramid, the
frontend and the sharded pyramid at "high", on the CPU against float64, the
JAX package and the port's own "highest" / unsharded results.

The oracle trap: on the CPU, XLA computes ``Precision.HIGH`` in full f32
(the JAX package's own tests assert that "high" equals "highest" there), so
the port's bf16x3 emulation cannot equal JAX bit for bit. The tests hold it
against float64 with an error bound, and against JAX with a tolerance sized
by that error.

Tolerances:

* One product against float64, elementwise: splitting x = hi + lo drops
  lo.lo and the bits of x below lo, at most ~3 * 2^-16 |a| |b| a product
  term (hi and lo each round to 8 significant bits); the fp32 sums of the
  3k exact products add (3k + 2) * 2^-24 of |A| |B|.
* The pyramid at "high" against JAX's "high" (f32 on the CPU) and against
  the port's "highest": 3e-5 absolute on [0, 1] frames. One blur B^T X B of a
  U[0, 1) image measured 7.3e-6 (64^2) and 8.3e-6 (256^2) from float64 (a
  CPU run), and an octave's planes carry up to three blurs' error (the base
  blur, the previous octave's scale-S blur, its own); 1.05e-5 is the largest
  difference measured on these frames.
* The sharded pyramid at "high" against the unsharded one: both run the
  same bf16x3 arithmetic on halo band products and on dense / tail products,
  which sum in another order; 3e-5 as above.
* The frontend at "high" against JAX's: >= 95% of JAX's keypoints matched
  (same octave and scale, within 0.05 px: the blur error moves a sub-pixel
  fit by ~5e-3 px here), their descriptors within L2 0.01.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from sift_parallel_optimization_tpu.config import PyramidConfig as JaxConfig
from sift_parallel_optimization_tpu.config import ScaleSpaceMode as JaxMode
from sift_parallel_optimization_tpu.core import pyramid_ref as jpr
from sift_parallel_optimization_tpu.models import frontend as jfe
from sift_parallel_optimization_tpu_torch import config as tconfig
from sift_parallel_optimization_tpu_torch.bench import roofline as R
from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
from sift_parallel_optimization_tpu_torch.core import pyramid_ref as tpr
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.ops import blur_product as bp
from sift_parallel_optimization_tpu_torch.parallel import scale_space as tss
from sift_parallel_optimization_tpu_torch.utils import native as tnative

HIGH_ATOL = 3e-5
MATCH_PX, MATCH_FRAC, DESC_L2 = 0.05, 0.95, 0.01


def _operands(kind, rng):
    """(a, b, out or None) of one layout kind the blur gives the product."""
    f = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    if kind == "contiguous":
        return f(3, 40, 70), f(3, 70, 50), None
    if kind == "overlapping windows":
        # The banded row pass: windows of 46 rows, 16 rows apart.
        buf = f(10 * 16 + 30, 96)
        return f(10, 32, 46), buf.as_strided((10, 46, 96), (16 * 96, 96, 1)), None
    if kind == "column windows into out":
        # The banded column pass: windows 32 floats apart inside rows 320
        # floats long (batch stride below the row stride), written through a
        # view of the same layout.
        t = f(48, 320)
        out = torch.zeros(48, 320)
        return (t.as_strided((9, 48, 46), (32, 320, 1)), f(9, 46, 32),
                out.as_strided((9, 48, 32), (32, 320, 1)))
    if kind == "broadcast":
        return f(40, 56), f(5, 56, 56), None           # batch stride 0 for a
    if kind == "broadcast frames":
        return f(2, 1, 40, 56), f(5, 56, 56), None     # (2, 5) batches, two of them stride 0
    if kind == "subsample and transposed bank":
        # A dense octave's base (a stride-2 subsample: column stride 2) and
        # the row bank read transposed (row stride 1).
        return f(5, 56, 56).transpose(-1, -2), f(112, 112)[::2, ::2], None
    raise ValueError(kind)


KINDS = ["contiguous", "overlapping windows", "column windows into out", "broadcast",
         "broadcast frames", "subsample and transposed bank"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_product_within_bound_of_float64(kind):
    a, b, out = _operands(kind, np.random.default_rng(len(kind)))
    got = bp.bf16x3_bmm_plain(a, b, out=out)
    if out is not None:
        assert got is out
    want = a.double() @ b.double()
    k = a.shape[-1]
    bound = (3.1 * 2.0**-16 + (3 * k + 2) * 2.0**-24) * (a.double().abs() @ b.double().abs())
    err = (got.double() - want).abs()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool((err <= bound).all()), float((err - bound).max())
    # Not the fp32 product: the error is the split's, well above fp32's.
    assert float(err.max()) > 16 * float((a @ b - want).abs().max())
    # The dispatcher takes the plain version on CPU tensors.
    assert torch.equal(bp.bf16x3_bmm(a, b), got)
    if kind == "column windows into out":
        base = out.as_strided((48, 320), (320, 1))
        assert bool((base[:, 9 * 32:] == 0).all())    # columns no window writes


@pytest.mark.parametrize("side", ["a", "b", "ab"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_product_of_split_pairs_is_bitwise_the_f32_ones(kind, side):
    """A constant split once (a SplitPair) gives the plain version the same
    parts in the same layout as the f32 operand it was split from."""
    a, b, out = _operands(kind, np.random.default_rng(len(kind)))
    want = bp.bf16x3_bmm_plain(a, b)
    split = {s: bp.split_pair(x) if s in side else x for s, x in (("a", a), ("b", b))}
    got = bp.bf16x3_bmm(split["a"], split["b"], out=out)
    assert torch.equal(got, want)
    for name, x in split.items():
        if isinstance(x, bp.SplitPair):
            assert x.parts.dtype == torch.bfloat16 and x.parts.is_contiguous()
            assert x.parts.shape[-1] % 8 == 0 and x.shape == (a if name == "a" else b).shape
            assert bool((x.parts[..., x.cols:] == 0).all())         # the rows' zero pad


def test_split_pair_indexes_and_repeats_like_its_matrix():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 5, 13)).astype(np.float32))
    pair = bp.split_pair(x)
    for got, want in ((pair[1:], x[1:]), (pair.repeat(2, 1, 1)[:4], x.repeat(2, 1, 1)[:4])):
        assert got.shape == want.shape and torch.equal(got.dense(), bp.split_pair(want).dense())
    with pytest.raises(ValueError, match="batch dimensions"):
        pair.repeat(1, 2, 1)


SIGMAS = [1.2, 2.0, 3.1]


def _module_and_paths(form):
    """(a module at "high" holding its constant matrices split once, its
    input shape, its forward, the f32-operand product path it replaced)."""
    if form in ("banded", "dense"):
        h, w = (24, 512) if form == "banded" else (40, 36)
        bank = tpr.BlurBank(h, w, SIGMAS, True, precision="high")
        assert bank.form == form
        if form == "banded":
            rows, cols, r, bw = tpr._band_operands(h, w, SIGMAS, with_input=True)
            return bank, (h, w), bank, lambda x: tpr._blur_banded(
                x, torch.from_numpy(rows), torch.from_numpy(cols), r, bw, "high")
        f32 = [tpr._blur_stack(n, SIGMAS, torch.float32, "cpu") for n in (h, w)]
        return bank, (h, w), bank, lambda x: torch.cat(
            [x[..., None, :, :], tpr.blur_bank(x, *f32, "high")], dim=-3)
    if form == "tail":
        rel, n_tail = (1.1, 1.6, 2.3), 3
        bank = tpr.TailBank(24, 20, rel, rel[1], n_tail, precision="high")
        ah, aw = (torch.from_numpy(tpr._sift_tail_mats_np(n, rel, rel[1], n_tail))
                  for n in (24, 20))
        n = bank.n_scales

        def tail(x):
            out = tpr.blur_bank(x, ah, aw, "high")
            return [out[..., o * n:(o + 1) * n, :hh, :ww]
                    for o, (hh, ww) in enumerate(bank.shapes)]

        return bank, (24, 20), bank, tail
    # The row-sharded bank's three products (the local rows, the halo from
    # above, from below) on one frame's rows; "highest" holds the f32 slices.
    bank, f32 = (tss._ShardedBank(16, 24, SIGMAS, torch.float32, "cpu", precision=p)
                 for p in ("high", "highest"))

    def high(x):
        return [bank._rows(m, x[0, :m.shape[-1]])
                for m in (bank.band_mid, bank.band_up, bank.band_down)]

    def f32_path(x):
        return [tpr.blur_product(m, tpr.blur_product(x[0, :m.shape[-1]], f32.bank_w, "high"),
                                 "high") for m in (f32.band_mid, f32.band_up, f32.band_down)]

    return bank, (16, 24), high, f32_path


FORMS = ["banded", "dense", "tail", "sharded"]


@pytest.mark.parametrize("form", FORMS)
def test_high_modules_hold_split_pairs_only(form):
    bank = _module_and_paths(form)[0]
    if form == "sharded":
        held = [bank.band_mid, bank.band_up, bank.band_down, bank.bank_w]
        assert all(isinstance(m, bp.SplitPair) and m.parts.dtype == torch.bfloat16
                   for m in held)
        return
    buffers = dict(bank.named_buffers())
    assert all(b.dtype == torch.bfloat16 and b.shape[0] == 2 for b in buffers.values())
    names = {"banded": {"rows", "cols"}, "dense": {"bank_h_t", "bank_w"},
             "tail": {"ah_t", "aw"}}[form]
    assert set(buffers) == names
    # "highest" holds the same matrices in f32, the row bank untransposed.
    f32 = {"banded": lambda: tpr.BlurBank(24, 512, SIGMAS, True),
           "dense": lambda: tpr.BlurBank(40, 36, SIGMAS, True),
           "tail": lambda: tpr.TailBank(24, 20, (1.1, 1.6), 1.6, 2)}[form]()
    assert all(b.dtype == torch.float32 for b in f32.buffers())
    assert set(dict(f32.named_buffers())) == {n.removesuffix("_t") for n in names}


@pytest.mark.parametrize("form", FORMS)
def test_high_modules_are_bitwise_their_f32_operand_paths(form):
    """Two frames a call (the banded row pass repeats its split blocks)."""
    _bank, (h, w), high, f32_path = _module_and_paths(form)
    x = torch.from_numpy(np.random.default_rng(4).random((2, h, w), dtype=np.float32))
    got, want = high(x), f32_path(x)
    got, want = (g if isinstance(g, list) else [g] for g in (got, want))
    assert len(got) == len(want)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


def test_split_and_kernel_wrapper_contract():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=1000).astype(np.float32)) * 100
    hi, lo = bp._split(x)
    assert torch.equal(hi.to(torch.bfloat16).float(), hi)
    assert torch.equal(lo.to(torch.bfloat16).float(), lo)
    assert bool(((x.double() - hi.double() - lo.double()).abs()
                 <= 2.0**-16 * x.double().abs()).all())
    a = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        bp.bf16x3_bmm_cuda(a, torch.zeros(2, 8, 4))


@pytest.mark.parametrize("size", [64, 256, 512])
def test_sift_pyramid_high_matches_jax_high(size):
    """64^2: the composite tail from octave 0; 256^2: dense blurs; 512^2:
    banded blurs (the forms both packages take at these sizes)."""
    img = tnative.synth_frame(size, 0, seed=1)
    jcfg = JaxConfig(length=size, S=3, mode=JaxMode.SIFT, blur_precision="high")
    want = jax.jit(lambda x: jpr.sift_gaussian_pyramid(x, jcfg))(jnp.asarray(img))
    cfg = PyramidConfig(length=size, S=3, mode=ScaleSpaceMode.SIFT, blur_precision="high")
    pyr = tpr.SiftPyramid(cfg, size)
    got = pyr(torch.from_numpy(img.copy()))
    highest = tpr.SiftPyramid(dataclasses.replace(cfg, blur_precision="highest"), size)(
        torch.from_numpy(img.copy()))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert pyr.forms == tpr.SiftPyramid(
        dataclasses.replace(cfg, blur_precision="highest"), size).forms
    for o, (g, w, h) in enumerate(zip(got, want, highest)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=HIGH_ATOL,
                                   err_msg=f"octave {o}")
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=0, atol=HIGH_ATOL,
                                   err_msg=f"octave {o}")
    # Not the fp32 pyramid: the 3-pass products' own error shows.
    assert max(float((g - h).abs().max()) for g, h in zip(got, highest)) > 1e-6


def _matched(got, want):
    """(share of JAX's valid keypoints matched by one of the port's, same
    octave and scale within MATCH_PX; largest descriptor L2 among them)."""
    gk, wk = got.keypoints, want.keypoints
    gv, wv = gk.valid.numpy(), np.asarray(wk.valid)
    g = {f: getattr(gk, f).numpy()[gv] for f in ("x", "y", "octave", "scale")}
    w = {f: np.asarray(getattr(wk, f))[wv] for f in ("x", "y", "octave", "scale")}
    dist = np.maximum(np.abs(w["x"][:, None] - g["x"][None]),
                      np.abs(w["y"][:, None] - g["y"][None]))
    dist[(w["octave"][:, None] != g["octave"][None])
         | (w["scale"][:, None] != g["scale"][None])] = np.inf
    j, best = dist.argmin(1), dist.min(1)
    ok = best <= MATCH_PX
    l2 = np.linalg.norm(np.asarray(want.descriptors)[wv][ok] - got.descriptors.numpy()[gv][j[ok]],
                        axis=1)
    return float(ok.mean()), float(l2.max())


def test_frontend_high_matches_jax_high_single_and_batched():
    size, k = 256, 256
    assert tnative._load() is not None, tnative._build_error
    frames = np.stack([tnative.synth_frame(size, i, seed=0) for i in range(2)])
    jcfg = jfe.sift_config(size, blur_precision="high")
    fe = tfe.SiftFrontend(tfe.sift_config(size, blur_precision="high"), max_keypoints=k,
                          device="cpu")
    batched = fe(torch.from_numpy(frames))
    jax_fe = jax.jit(lambda x: jfe.extract_features(x, jcfg, k))
    for i in range(2):
        want = jax_fe(jnp.asarray(frames[i]))
        assert int(np.asarray(want.keypoints.valid).sum()) > 40
        one = fe(torch.from_numpy(frames[i].copy()))
        frame = type(one)(type(one.keypoints)(*[f[i] for f in batched.keypoints]),
                          batched.descriptors[i])
        for got in (one, frame):
            frac, l2 = _matched(got, want)
            assert frac >= MATCH_FRAC and l2 <= DESC_L2, (i, frac, l2)


def test_sharded_pyramid_high_matches_unsharded(tmp_path):
    """World sizes 2 and 4 on gloo ranks (meshes 1x2, 2x1, 1x4, 2x2, 4x1) and
    1 in this process: rows sharded while they split, then gathered."""
    handle = W.start("blur_precision", (2, 4), tmp_path)
    try:
        with W.one_thread(), W.world1():
            port = {1: W.run_suite("blur_precision", 1)}
    finally:
        port.update(W.finish(handle))
    cfg = PyramidConfig(length=256, S=2, mode=ScaleSpaceMode.SIFT, max_octaves=3,
                        blur_precision="high")
    want = tpr.sift_gaussian_pyramid(torch.from_numpy(W.unit_image(256, 3)), cfg)
    fp32 = tpr.sift_gaussian_pyramid(torch.from_numpy(W.unit_image(256, 3)),
                                     dataclasses.replace(cfg, blur_precision="highest"))
    for n in (1, 2, 4):
        for a, b in W.MESH_SHAPES[n]:
            res = port[n]
            assert "S(1)" in list(res[f"{a}x{b}/placements"])      # some rows were sharded
            for o, w in enumerate(want):
                got = res[f"{a}x{b}/sift_pyr/{o}"]
                np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=HIGH_ATOL,
                                           err_msg=f"world {n} mesh {a}x{b} octave {o}")
            assert max(float(np.abs(res[f"{a}x{b}/sift_pyr/{o}"] - f.numpy()).max())
                       for o, f in enumerate(fp32)) > 1e-6


def test_config_blur_precision_knob():
    """As the JAX package's test_blur_precision_knob: "high" accepted, the
    1-pass "default" and unknown values refused; a round trip from JAX
    fields keeps "high"."""
    assert tconfig.PyramidConfig(blur_precision="high").blur_precision == "high"
    for bad in ("default", "bogus"):
        with pytest.raises(ValueError, match="spurious DoG extrema"):
            tconfig.PyramidConfig(blur_precision=bad)
    jcfg = JaxConfig(length=128, S=3, mode=JaxMode.SIFT, blur_precision="high")
    d = dataclasses.asdict(jcfg)
    d["dtype"] = np.dtype(jcfg.dtype).name
    cfg = tconfig.config_from_jax_fields(d)
    assert cfg.blur_precision == "high" and cfg.n_octaves == jcfg.n_octaves


def test_roofline_charges_high_at_the_bf16_rate():
    h100 = R.H100_SXM
    cfg = tfe.sift_config(512)
    fp32 = R.sift_pyramid_model(cfg)
    high = R.sift_pyramid_model(dataclasses.replace(cfg, blur_precision="high"))
    assert high.matmul_bf16_flops == 3 * fp32.matmul_f32_flops and high.matmul_f32_flops == 0
    assert high.hbm_bytes == fp32.hbm_bytes
    assert h100.matmul_bf16_tflops == 989.0
    m = R.bf16x3_product_model(8, 384, 576, 94)
    assert m.matmul_bf16_flops == 3 * 2 * 8 * 384 * 576 * 94
    assert m.hbm_bytes == 4.0 * 8 * (384 * 94 + 94 * 576 + 384 * 576)
    assert m.kernel_bound(h100) == (1e3 * m.hbm_bytes / (h100.hbm_gbps * 1e9), "bytes")
    deep = R.bf16x3_product_model(1, 4096, 4096, 4096)
    assert deep.kernel_bound(h100)[1] == "operations"
    assert math.isclose(deep.floor_ms(h100), 1e3 * 6 * 4096**3 / 989e12)
    # Distinct elements of the views the blur gives the product.
    a, b, _ = _operands("overlapping windows", np.random.default_rng(0))
    assert R.strided_elems(b) == (9 * 16 + 46) * 96
    assert R.strided_elems(torch.zeros(40, 56).expand(5, 40, 56)) == 40 * 56
