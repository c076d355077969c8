"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python3 -m pytest tests/test_torch_cuda.py -q --noconftest

Each kernel is held to its plain PyTorch version on the same CUDA tensors.
"""

import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu_torch.core import pyramid_ref
from sift_parallel_optimization_tpu_torch.models import descriptor
from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
from sift_parallel_optimization_tpu_torch.ops import blur_product as bp
from sift_parallel_optimization_tpu_torch.ops import descriptor_hist as dh
from sift_parallel_optimization_tpu_torch.ops import gather_resample as gr
from sift_parallel_optimization_tpu_torch.ops import patch_gather as pg
from sift_parallel_optimization_tpu_torch.ops import scale_space as ss
from sift_parallel_optimization_tpu_torch.ops import score_tables as st
from sift_parallel_optimization_tpu_torch.utils import native
from sift_parallel_optimization_tpu_torch.utils.device import fp32_matmul

pytestmark = pytest.mark.cuda

# Kernel 4 against its plain version (batched matmuls that may sum with FMAs).
RTOL, ATOL = 1e-5, 1e-6
# Kernel 6 against its plain version: the same f32 operations one by one,
# but the sums over a bin's votes (up to 576 non-negative terms, summed by
# the plain version's fp32 product in another order) and over a row's 128
# squares run in another order, and two norms divide the result: a few 1e-7
# to a few 1e-6 an element on descriptors whose elements reach 0.2.
DESC_ATOL = 1e-5
# The SIFT pyramid at blur_precision="high", card against CPU: both run the
# same bf16x3 products (kernel 5 and its plain version) and differ by their
# summation order, far below the 3e-5 the CPU tests allow against JAX.
HIGH_ATOL = 3e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("size,S", [(512, 2), (1000, 2), (64, 3), (500, 2), (768, 3), (37, 1),
                                    (2048, 2)])
def test_reference_dog_kernel_matches_plain(dev, size, S):
    """Bitwise (the kernel's _rn arithmetic is the plain version's): sides
    whose octaves all keep 16-byte rows, ragged chains that leave them (1000,
    500, 768, 37) and a side at which a CTA walks several row blocks."""
    img = torch.from_numpy(
        np.random.default_rng(size).random((size, size), dtype=np.float32)
    ).to(dev)
    before = ss.LAUNCHES
    got = ss.reference_dog_pyramid_cuda(img, S)
    want = ss.reference_dog_pyramid_plain(img, S)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 1
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [512, 2048])
def test_patch_gather_kernel_is_bitwise_plain(dev, k):
    rng = np.random.default_rng(k)
    r, c, rows, cols = 7000, 1280, 96, 256
    atlas = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32)).to(dev)
    ys = rng.integers(0, (r - rows) // 8 + 1, size=k).astype(np.int32) * 8
    xs = rng.integers(0, (c - cols) // 128 + 1, size=k).astype(np.int32) * 128
    ys[0], xs[0] = r - rows, c - cols
    xs[1] = 5              # unaligned column: the scalar path
    ys[2], xs[2] = -3, -1  # negative origins count from the end, then clamp
    ys_t, xs_t = torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)
    got = pg.extract_atlas_patches_cuda(atlas, ys_t, xs_t, rows, cols)
    want = pg.extract_atlas_patches_plain(atlas, ys_t, xs_t, rows, cols)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shared", [False, True])
def test_patch_gather_batched_kernel_is_bitwise_plain(dev, shared):
    rng = np.random.default_rng(7)
    b, k, r, c, rows, cols = 4, 300, 3000, 1280, 96, 256
    shape = (r, c) if shared else (b, r, c)
    atlas = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    ys = rng.integers(0, (r - rows) // 8 + 1, size=(b, k)).astype(np.int32) * 8
    xs = rng.integers(0, (c - cols) // 128 + 1, size=(b, k)).astype(np.int32) * 128
    ys[-1, -1], xs[-1, -1] = r - rows, c - cols   # last legal origin of the last frame
    xs[1, 1] = 5                                  # unaligned column: the scalar path
    ys[2, 2], xs[2, 2] = -3, -1                   # negative: from the frame's own end
    ys[1, 3], xs[1, 3] = r + 500, c + 7           # over range: clamps into its own frame
    ys_t, xs_t = torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)
    before = pg.LAUNCHES_BATCHED
    got = pg.extract_atlas_patches_batched(atlas, ys_t, xs_t, rows, cols)
    want = pg.extract_atlas_patches_batched_plain(atlas, ys_t, xs_t, rows, cols)
    torch.cuda.synchronize()
    assert pg.LAUNCHES_BATCHED == before + 1
    assert got.shape == (b, k, rows, cols) and torch.equal(got, want)
    frame1 = atlas if shared else atlas[1]
    assert torch.equal(got[1, 3], frame1[r - rows:, c - cols:])


def test_batched_frontend_launches_each_kernel_once(dev, monkeypatch):
    from sift_parallel_optimization_tpu_torch.parallel.frontend import batched_extract_features

    for name in ("LAUNCHES", "LAUNCHES_BATCHED"):
        monkeypatch.setattr(pg, name, 0)
    monkeypatch.setattr(st, "LAUNCHES", 0)
    monkeypatch.setattr(dh, "LAUNCHES", 0)
    imgs = torch.from_numpy(np.stack([native.synth_frame(256, i, seed=0) for i in range(4)]))
    cfg = sift_config(256)
    out = batched_extract_features(imgs, cfg, 64, device=dev)
    torch.cuda.synchronize()
    assert (pg.LAUNCHES, pg.LAUNCHES_BATCHED, st.LAUNCHES, dh.LAUNCHES) == (0, 1, 1, 1)
    assert out.descriptors.shape == (4, 64, 128) and out.descriptors.is_cuda
    fe = SiftFrontend(cfg, max_keypoints=64, device=dev)
    for i in range(4):
        ref = fe(imgs[i].to(dev))
        assert torch.equal(out.keypoints.valid[i], ref.keypoints.valid)
        assert torch.equal(out.keypoints.octave[i], ref.keypoints.octave)
        torch.testing.assert_close(out.keypoints.x[i], ref.keypoints.x, rtol=0, atol=1e-3)


def _dogs(dev, shape, seed):
    return torch.from_numpy(
        (0.05 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape", [(5, 128, 128), (5, 250, 370), (4, 37, 70)])
def test_score_tables_rows_kernel_is_bitwise_plain(dev, shape):
    dog = _dogs(dev, shape, shape[1])
    got = st.score_tables_rows_cuda(dog, 0.04 / 3, 10.0)
    want = st.score_tables_rows_plain(dog, 0.04 / 3, 10.0)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("refine_iters", [0, 1])
def test_score_block_top2_kernel_is_bitwise_plain(dev, refine_iters):
    # Octaves of a 250 x 370 frame: block tables above 4096 voxels, every
    # voxel below; a ragged last block in each.
    shapes = [(5, 250 >> o, 370 >> o) for o in range(5)]
    flat = torch.cat([_dogs(dev, s, i).reshape(-1) for i, s in enumerate(shapes)])
    got = st.score_block_top2_cuda(flat[None], shapes, 0.04 / 3, 10.0, refine_iters)
    want = st.score_block_top2_plain(flat[None], shapes, 0.04 / 3, 10.0, refine_iters)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int((got[0] > 0).sum()) > 50
    # Three frames in one launch: each frame's tables, indices within the frame.
    batch = torch.stack([flat, flat.flip(0), flat])
    got = st.score_block_top2_cuda(batch, shapes, 0.04 / 3, 10.0, refine_iters)
    want = st.score_block_top2_plain(batch, shapes, 0.04 / 3, 10.0, refine_iters)
    torch.cuda.synchronize()
    assert got[0].shape[0] == 3 and all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got[1][0], got[1][2])


# Inputs the tiled score-table kernel can get wrong (chip_smoke.py holds the
# same kinds at full size): odd octaves at odd offsets of the flat DoG, rows
# wider than the slab takes three of, more score planes than a tile is long;
# constant regions, a two-level DoG (every voxel an extremum) and NaNs.
K3_SHAPES = {
    "odd octaves": ((5, 131, 77), (5, 66, 39), (5, 33, 20)),
    "wide rows": ((5, 12, 2600),),
    "many planes": ((12, 24, 28),),
    "one row a rectangle": ((5, 40, 2048),),
}


def _k3_frames(shapes, kind, frames):
    out = []
    for seed in range(frames):
        rng = np.random.default_rng(seed)
        parts = []
        for s in shapes:
            a = 0.05 * rng.normal(size=s)
            if kind == "constant regions":
                a[:, : s[1] // 2, :] = 0.0
                a[:, :, : s[2] // 3] = 0.25
            elif kind == "two levels":
                a = np.where(rng.random(size=s) < 0.5, -0.03, 0.04)
            elif kind == "nan":
                a[rng.random(size=s) < 0.01] = np.nan
            parts.append(a.astype(np.float32).reshape(-1))
        out.append(np.concatenate(parts))
    return torch.from_numpy(np.stack(out))


def _same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("refine_iters", [0, 1])
@pytest.mark.parametrize("kind", ["noise", "constant regions", "two levels", "nan"])
@pytest.mark.parametrize("name,frames", [("odd octaves", 1), ("odd octaves", 3), ("wide rows", 1),
                                         ("many planes", 2), ("one row a rectangle", 1)])
def test_score_tables_kernel_contract_cases_are_bitwise_plain(dev, name, frames, kind,
                                                              refine_iters):
    shapes = K3_SHAPES[name]
    flat = _k3_frames(shapes, kind, frames).to(dev)
    before = st.LAUNCHES
    got = st.score_block_top2_cuda(flat, shapes, 0.04 / 3, 10.0, refine_iters)
    want = st.score_block_top2_plain(flat, shapes, 0.04 / 3, 10.0, refine_iters)
    torch.cuda.synchronize()
    assert st.LAUNCHES == before + 1
    assert got[0].shape[0] == frames and all(_same_bits(g, w) for g, w in zip(got, want))
    assert int((got[0] > 0).sum()) > 50
    if refine_iters:
        off = 0
        for s in shapes:                       # the rows tables, octave by octave
            dog = flat[0, off:off + s[0] * s[1] * s[2]].view(s).contiguous()
            off += dog.numel()
            got = st.score_tables_rows_cuda(dog, 0.04 / 3, 10.0)
            want = st.score_tables_rows_plain(dog, 0.04 / 3, 10.0)
            torch.cuda.synchronize()
            assert all(_same_bits(g, w) for g, w in zip(got, want))


def test_gather_resample_kernel_matches_plain(dev):
    rng = np.random.default_rng(4)
    k, r, c = 512, 3000, 1280
    atlas = torch.from_numpy(rng.random((r, c), dtype=np.float32)).to(dev)
    grow = rng.integers(0, r - 128, size=k).astype(np.int32)
    x0 = rng.integers(0, c - 256, size=k).astype(np.int32)
    grow[:3], x0[:3] = (r - 128, -5, 7), (c - 256, 3, -1)   # edge and unnormalised origins
    params = np.stack([rng.uniform(-10, 140, k), rng.uniform(-10, 270, k),
                       rng.uniform(1, 60, k), rng.uniform(1, 60, k)], 1).astype(np.float32)
    args = (atlas, torch.from_numpy(grow).to(dev), torch.from_numpy(x0).to(dev),
            torch.from_numpy(params).to(dev))
    got = gr.gather_resample_cuda(*args)
    want = gr.gather_resample_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def kernel5_tol(a, b):
    """Kernel 5 against its plain version, elementwise: both sum the same 3k
    products, exact in f32, in fp32 and in another order (the tensor cores
    accumulate in their own order and rounding): (3k + 2) * 2^-22 of
    |A| |B|."""
    with fp32_matmul():
        return (3 * a.shape[-1] + 2) * 2.0**-22 * (a.abs() @ b.abs())


def _kernel5_operands(kind, dev):
    g = torch.Generator().manual_seed(len(kind))
    f = lambda *shape: torch.randn(*shape, generator=g).to(dev)
    if kind == "ragged":
        return f(3, 70, 37), f(3, 37, 53), None
    if kind == "several tiles":
        return f(2, 150, 94), f(2, 94, 200), None
    if kind == "k=1":
        return f(2, 9, 1), f(2, 1, 5), None
    if kind == "overlapping windows":
        return f(10, 384, 94), f(10 * 64 + 30, 576).as_strided((10, 94, 576), (64 * 576, 576, 1)), None
    if kind == "column windows into out":
        out = torch.zeros(512, 6 * 576, device=dev)
        return (f(512, 6 * 576).as_strided((53, 512, 94), (64, 6 * 576, 1)), f(53, 94, 64),
                out.as_strided((53, 512, 64), (64, 6 * 576, 1)))
    if kind == "broadcast frames":
        return f(3, 1, 100, 120), f(5, 120, 120), None
    if kind == "subsample and transposed bank":
        return f(5, 128, 128).transpose(-1, -2), f(2, 256, 256)[:, None, ::2, ::2], None
    if kind == "stride-2 base and bank":
        # A dense octave's column pass: the base a stride-2 view of frames
        # whose rows end on the last element's odd neighbour, K ragged.
        return f(2, 1, 154, 186)[..., ::2, ::2], f(5, 93, 60), None
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["ragged", "several tiles", "k=1", "overlapping windows",
                                  "column windows into out", "broadcast frames",
                                  "subsample and transposed bank", "stride-2 base and bank"])
def test_bf16x3_kernel_matches_plain(dev, kind):
    a, b, out = _kernel5_operands(kind, dev)
    before = bp.LAUNCHES
    got = bp.bf16x3_bmm_cuda(a, b, out=out)
    want = bp.bf16x3_bmm_plain(a, b)
    torch.cuda.synchronize()
    assert bp.LAUNCHES == before + 1 and got.shape == want.shape
    assert bool(((got - want).abs() <= kernel5_tol(a, b)).all()), float((got - want).abs().max())
    # The 3-pass function, not the fp32 product.
    with fp32_matmul():
        exact = (a.double() @ b.double())
        assert float((got.double() - exact).abs().max()) > 4 * float(
            ((a @ b).double() - exact).abs().max())
    if out is not None:
        base = out.as_strided((512, 6 * 576), (6 * 576, 1))
        assert bool((base[:, 53 * 64:] == 0).all())       # columns no window writes


# The constant blur matrix of each operand kind (the side the pyramid's
# modules hold split once): the row pass's blocks and banks are A, the
# column pass's blocks and banks B.
CONSTANT_SIDE = {"ragged": "b", "several tiles": "a", "k=1": "b", "overlapping windows": "a",
                 "column windows into out": "b", "broadcast frames": "b",
                 "subsample and transposed bank": "a", "stride-2 base and bank": "b"}


def _dense(x):
    return x.dense() if isinstance(x, bp.SplitPair) else x


def _check_split_launch(a, b, out, side):
    """Kernel 5 with ``side`` ("a", "b" or "ab") handed over split once:
    bitwise the kernel on the f32 operands (the same split, the same MMAs),
    within kernel5_tol of the plain version on the pairs, and not the fp32
    product."""
    split = {s: bp.split_pair(x) if s in side else x for s, x in (("a", a), ("b", b))}
    before = bp.LAUNCHES
    got = bp.bf16x3_bmm_cuda(split["a"], split["b"], out=out)
    f32 = bp.bf16x3_bmm_cuda(a, b)
    want = bp.bf16x3_bmm_plain(split["a"], split["b"])
    torch.cuda.synchronize()
    assert bp.LAUNCHES == before + 2 and got.shape == want.shape
    assert torch.equal(got, f32)
    tol = kernel5_tol(_dense(split["a"]), _dense(split["b"]))
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())
    with fp32_matmul():
        exact = a.double() @ b.double()
        assert float((got.double() - exact).abs().max()) > 4 * float(
            ((a @ b).double() - exact).abs().max())


@pytest.mark.parametrize("kind", list(CONSTANT_SIDE))
def test_bf16x3_kernel_with_the_constant_split_once(dev, kind):
    a, b, out = _kernel5_operands(kind, dev)
    _check_split_launch(a, b, out, CONSTANT_SIDE[kind])


@pytest.mark.parametrize("side", ["a", "b", "ab"])
@pytest.mark.parametrize("k", [1, 15, 17, 94, 95, 96, 257])
def test_bf16x3_kernel_ragged_depths(dev, k, side):
    """Depths around the 32-deep tile and the 16-byte chunks, M and N not
    multiples of the 64 x 64 tile, a split side's rows padded."""
    g = torch.Generator().manual_seed(k)
    a = torch.randn(2, 77, k, generator=g).to(dev)
    b = torch.randn(2, k, 93, generator=g).to(dev)
    _check_split_launch(a, b, None, side)


def test_bf16x3_kernel_attributes(dev):
    """The pyramid's instances fit 128 registers without spilling; the row
    and column passes' four CTAs an SM, the stride-2 bases' three."""
    for kinds in bp.PYRAMID_INSTANCES:
        got = bp.kernel_attributes(*kinds)
        assert got["registers"] <= 128 and got["local_bytes"] == 0, (kinds, got)
        assert got["ctas_per_sm"] >= (3 if kinds[2] else 4), (kinds, got)


@pytest.mark.parametrize("size", [512, 256])
def test_sift_pyramid_high_on_the_card_matches_cpu(dev, size):
    """512^2: banded base and octave 0, dense 256^2 and 128^2, the tail: two
    kernel 5 launches a blur call (10 for one frame, the same for two)."""
    cfg = sift_config(size, blur_precision="high")
    frames = np.stack([native.synth_frame(size, i, seed=0) for i in range(2)])
    pyr = pyramid_ref.SiftPyramid(cfg, size, device=dev)
    before = bp.LAUNCHES
    got = pyr(torch.from_numpy(frames).to(dev))
    torch.cuda.synchronize()
    calls = 1 + len(pyr.banks) + 1
    assert bp.LAUNCHES == before + 2 * calls
    want = pyramid_ref.SiftPyramid(cfg, size, device="cpu")(torch.from_numpy(frames))
    for o, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0, atol=HIGH_ATOL,
                                   err_msg=f"octave {o}")


def test_sift_pyramid_high_captures_in_a_cuda_graph(dev):
    """`cli bench` chains the "high" pyramid as CUDA graphs: every kernel 5
    instance it launches (the stride-2 bases' with more than 48 KB of shared
    memory among them) captures, and a replay equals the eager call."""
    cfg = sift_config(512, blur_precision="high")
    pyr = pyramid_ref.SiftPyramid(cfg, 512, device=dev)
    img = torch.from_numpy(native.synth_frame(512, 0, seed=0)).to(dev)
    want = [o.clone() for o in pyr(img)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pyr(img)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = pyr(img)
    g.replay()
    torch.cuda.synchronize()
    for o, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), o


def test_profile_device_counts_every_timed_launch(dev):
    """One kernel a call: the device-time helper sees exactly ``iters``
    device records inside its timed range (a profiler run can lose its
    first records; the helper opens with spare launches and checks)."""
    from sift_parallel_optimization_tpu_torch.utils.profiling import profile_device

    dog = _dogs(dev, (5, 64, 64), 3)
    for _ in range(3):
        ops, ms, _prof = profile_device(st.score_tables_rows_cuda, dog, 0.04 / 3, 10.0, iters=7)
        assert ops == 1 and 0 < ms < 1


def test_profile_device_counts_the_kernels_of_a_replayed_graph(dev):
    """A call that replays a captured graph of 40 kernels and launches one
    more eagerly: the helper counts all 41 device records a call, not the
    two host launches."""
    from sift_parallel_optimization_tpu_torch.utils.profiling import profile_device

    x = torch.zeros(1024, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(40):
            x.add_(1.0)

    def call():
        g.replay()
        x.mul_(0.5)

    for _ in range(3):
        ops, ms, _prof = profile_device(call, iters=5)
        assert ops == 41 and 0 < ms < 5


def test_wrappers_check_inputs(dev):
    with pytest.raises(ValueError, match="square"):
        ss.reference_dog_pyramid_cuda(torch.zeros(8, 16, device=dev), 2)
    atlas = torch.zeros(64, 64, device=dev)
    idx = torch.zeros(3, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        pg.extract_atlas_patches_cuda(atlas, idx, idx, 8, 8)
    with pytest.raises(ValueError, match="f32"):
        bp.bf16x3_bmm_cuda(atlas.to(torch.bfloat16), atlas.to(torch.bfloat16))
    with pytest.raises(ValueError, match="inner stride"):
        bp.bf16x3_bmm_cuda(atlas, atlas, out=torch.empty(64, 64, device=dev).t())
    samples, offsets, sig_o, oris = _hist_inputs(dev, (), 8)
    with pytest.raises(ValueError, match="contiguous"):
        dh.descriptor_hist_cuda(samples.transpose(-1, -2), offsets, sig_o, oris)
    with pytest.raises(ValueError, match="one device"):
        dh.descriptor_hist_cuda(samples, offsets.cpu(), sig_o, oris)


def _hist_inputs(dev, lead, k, n_ori=2, p_valid=0.9, second=0.5, sig=None, seed=0):
    """Kernel 6's inputs with the slots' (*lead, K) axes: sample grids (a
    random field on a ramp), offsets from the program's radii at the
    KITTI frontend's patch radius, sigma over the frontend's range (or
    ``sig``), theta, and validity (``second``: the share of valid slots with
    a second orientation)."""
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(lead)) * k
    s = torch.rand((n, 26, 26), generator=g)
    s = s + torch.linspace(0, 1, 26)[None, :, None] * torch.rand((n, 1, 1), generator=g)
    sig_o = torch.rand(n, generator=g) * 5 + 0.8 if sig is None else torch.full((n,), sig)
    _rad_o, rad_d = descriptor._radii(sig_o, descriptor.max_patch_radius(3))
    off = torch.linspace(-1.0, 1.0, 26)[None] * rad_d[:, None]
    valid1 = torch.rand(n, generator=g) < p_valid
    valid2 = valid1 & (torch.rand(n, generator=g) < second)
    oris = tuple((torch.where(v, (torch.rand(n, generator=g) * 2 - 1) * np.pi, 0.0), v)
                 for v in (valid1, valid2))[:n_ori]
    shape = lambda t: t.reshape(*lead, k, *t.shape[1:]).to(dev)
    return shape(s), shape(off), shape(sig_o), tuple((shape(t), shape(v)) for t, v in oris)


# sigma (octave px) at which the KITTI frontend's descriptor radius meets its
# clamp (max_patch_radius - 1): the two ends are just under it and far over.
_SIG_CLAMP = (descriptor.max_patch_radius(3) - 1.0) / (3.0 * 2**0.5 * 2.5)


@pytest.mark.parametrize("name,lead,k,kw", [
    ("kitti_offline", (8,), 2000, {}),
    ("tum live", (), 1000, {}),
    ("single orientation", (8,), 2000, dict(n_ori=1)),
    ("every slot invalid", (2,), 1000, dict(p_valid=0.0)),
    ("no second orientation", (8,), 2000, dict(second=0.0)),
    ("sigma under the radius clamp", (), 1000, dict(sig=_SIG_CLAMP * 0.999)),
    ("sigma far over the radius clamp", (), 1000, dict(sig=_SIG_CLAMP * 4)),
    ("sigma at the smallest octave scale", (), 1000, dict(sig=0.8)),
])
def test_descriptor_hist_kernel_matches_plain(dev, name, lead, k, kw):
    args = _hist_inputs(dev, lead, k, **kw)
    before = dh.LAUNCHES
    got = dh.descriptor_hist_cuda(*args)
    want = dh.descriptor_hist_plain(*args)
    again = dh.descriptor_hist_cuda(*args)
    torch.cuda.synchronize()
    assert dh.LAUNCHES == before + 2
    n_ori = len(args[3])
    assert got.shape == want.shape == (*lead, n_ori * k, 128)
    torch.testing.assert_close(got, want, rtol=0, atol=DESC_ATOL)
    # Zero rows exactly where an orientation is invalid, in both.
    invalid = torch.cat([~v for _t, v in args[3]], dim=-1)
    assert torch.equal((got == 0).all(-1), invalid) and torch.equal((want == 0).all(-1), invalid)
    # A repeat call gives the same bits: no sum runs in a varying order.
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_descriptor_hist_launches_once_a_describe(dev, monkeypatch):
    """One launch per orient_and_describe call: per frame and for a batch of
    8 KITTI-shaped frames (376 x 1241, K 2000, both orientations)."""
    monkeypatch.setattr(dh, "LAUNCHES", 0)
    h, w, b = 376, 1241, 8
    frames = torch.stack([torch.from_numpy(native.synth_frame(1280, i, seed=0)[:h, :w].copy())
                          for i in range(b)]).to(dev)
    fe = SiftFrontend(sift_config(h), h, w, max_keypoints=2000, dual_orientation=True,
                      device=dev)
    batched = fe(frames)
    torch.cuda.synchronize()
    assert dh.LAUNCHES == 1 and batched.descriptors.shape == (b, 4000, 128)
    one = fe(frames[0])
    torch.cuda.synchronize()
    assert dh.LAUNCHES == 2 and one.descriptors.shape == (4000, 128)
    single = SiftFrontend(sift_config(256), max_keypoints=64, device=dev)
    single(frames[0, :256, :256].contiguous())
    torch.cuda.synchronize()
    assert dh.LAUNCHES == 3


def test_main_path_launches_the_kernels(dev, monkeypatch):
    for mod in (ss, pg, st, gr, dh):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    img = torch.from_numpy(native.synth_frame(256, 0, seed=0)).to(dev)
    pyramid_ref.reference_dog_pyramid(img, 2)
    fe = SiftFrontend(sift_config(256), max_keypoints=64, device=dev)
    feats = fe(img)
    monkeypatch.setattr(descriptor, "USE_FUSED_SAMPLING", True)
    fused = fe(img)
    torch.cuda.synchronize()
    assert (ss.LAUNCHES, pg.LAUNCHES, st.LAUNCHES, gr.LAUNCHES, dh.LAUNCHES) == (1, 1, 2, 1, 2)
    assert int(feats.keypoints.count()) > 0
    assert torch.equal(feats.keypoints.valid, fused.keypoints.valid)


def _ba_problem(n_cams=8, n_pts=80, seed=0):
    """Cameras on an arc observing every point (tests/test_geometry_ba.py's
    scene, numpy only), a perturbed start and a few outliers."""
    from sift_parallel_optimization_tpu_torch.models import ba
    from sift_parallel_optimization_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32) + np.float32([0, 0, 6])
    rv = np.array([[0.0, 0.08 * (i - n_cams / 2), 0.0] for i in range(n_cams)], np.float32)
    tv = np.array([[0.4 * (i - n_cams / 2), 0.0, 0.0] for i in range(n_cams)], np.float32)
    k = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float64)

    def project(r, t):
        pc = pts @ synthetic.rodrigues_np(r).T + t
        return ((pc / pc[:, 2:]) @ k.T)[:, :2]

    uv = np.concatenate([project(rv[i], tv[i]) for i in range(n_cams)]).astype(np.float32)
    k = k.astype(np.float32)
    uv[::17] += 40.0
    obs = ba.Observations(torch.from_numpy(np.repeat(np.arange(n_cams), n_pts).astype(np.int32)),
                          torch.from_numpy(np.tile(np.arange(n_pts), n_cams).astype(np.int32)),
                          torch.from_numpy(uv), torch.ones(n_cams * n_pts, dtype=torch.bool))
    start = ba.BAState(torch.from_numpy(rv + 0.01 * rng.normal(size=rv.shape).astype(np.float32)),
                       torch.from_numpy(tv + 0.03 * rng.normal(size=tv.shape).astype(np.float32)),
                       torch.from_numpy(pts + 0.05 * rng.normal(size=pts.shape).astype(np.float32)))
    return start, obs, torch.from_numpy(k)


def _to(tup, dev):
    return type(tup)(*[t.to(dev) for t in tup])


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_bundle_adjust_on_the_card_matches_cpu(dev, solver):
    """The same GN steps on CUDA and CPU tensors: other summation orders,
    so states within 1e-4 of the scene's extent."""
    from sift_parallel_optimization_tpu_torch.models import ba

    start, obs, k = _ba_problem()
    kw = dict(n_iters=8, damping=1e-4, huber_delta=2.0, solver=solver)
    cpu = ba.bundle_adjust(start, obs, k, **kw)
    gpu = ba.bundle_adjust(_to(start, dev), _to(obs, dev), k.to(dev), **kw)
    for c, g in zip(cpu, gpu):
        assert g.is_cuda
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * float(c.abs().max())
    assert float(ba.rms_error(gpu, _to(obs, dev), k.to(dev))) < 30.0


def test_optimize_pose_graph_on_the_card_matches_cpu(dev):
    from sift_parallel_optimization_tpu_torch.models import pose_graph as pgo

    rng = np.random.default_rng(1)
    n = 10
    rv = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    tv = rng.normal(size=(n, 3)).astype(np.float32)
    i = np.array(list(range(n - 1)) + [n - 1, 0, 0], np.int32)
    j = np.array(list(range(1, n)) + [0, 0, 0], np.int32)
    rel = pgo.relative_pose(*[torch.from_numpy(a) for a in (rv[i], tv[i], rv[j], tv[j])])
    noise = lambda a: a + torch.from_numpy(rng.normal(size=a.shape).astype(np.float32)) * 0.02
    edges = pgo.PoseGraphEdges(torch.from_numpy(i), torch.from_numpy(j), noise(rel[0]),
                               noise(rel[1]), torch.tensor([1.0] * n + [0.0, 0.0]))
    poses = pgo.Poses(torch.from_numpy(rv) + 0.05, torch.from_numpy(tv) + 0.1)
    cpu = pgo.optimize_pose_graph(poses, edges, n_iters=10)
    gpu = pgo.optimize_pose_graph(_to(poses, dev), _to(edges, dev), n_iters=10)
    for c, g in zip(cpu, gpu):
        assert bool(torch.isfinite(g).all())
        assert float((g.cpu() - c).abs().max()) < 1e-4


def test_solvers_run_with_tf32_off_and_restore_it(dev, monkeypatch):
    """bundle_adjust and optimize_pose_graph pin fp32 matmuls inside (the
    caller's TF32 setting is put back after)."""
    from sift_parallel_optimization_tpu_torch.models import ba
    from sift_parallel_optimization_tpu_torch.models import pose_graph as pgo

    seen = []
    solve_ex = torch.linalg.solve_ex

    def spy(*args, **kwargs):
        seen.append((torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32))
        return solve_ex(*args, **kwargs)

    monkeypatch.setattr(torch.linalg, "solve_ex", spy)
    start, obs, k = _ba_problem(n_cams=4, n_pts=30)
    torch.set_float32_matmul_precision("high")
    try:
        ba.bundle_adjust(_to(start, dev), _to(obs, dev), k.to(dev), n_iters=2)
        poses = pgo.Poses(torch.zeros(3, 3, device=dev), torch.zeros(3, 3, device=dev))
        edges = pgo.PoseGraphEdges(torch.tensor([0, 1], dtype=torch.int32, device=dev),
                                   torch.tensor([1, 2], dtype=torch.int32, device=dev),
                                   torch.zeros(2, 3, device=dev), torch.ones(2, 3, device=dev),
                                   torch.ones(2, device=dev))
        pgo.optimize_pose_graph(poses, edges, n_iters=2)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert len(seen) == 4 and all(s == ("highest", False) for s in seen)


@pytest.mark.parametrize("solver", ["chain", "cg"])
@pytest.mark.parametrize("graph", ["se3", "sim3"])
def test_scalable_pose_graph_solvers_on_the_card_match_cpu(dev, solver, graph):
    """The chain + Woodbury and CG solvers (SE(3) and Sim(3)) on CUDA and
    CPU tensors: other summation orders, so 10 GN steps within 1e-4."""
    from sift_parallel_optimization_tpu_torch.models import pose_graph as pgo
    from sift_parallel_optimization_tpu_torch.models import pose_graph_sim3 as ps

    rng = np.random.default_rng(2)
    n = 24
    rv = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    tv = np.cumsum(rng.normal(size=(n, 3)), axis=0).astype(np.float32)
    i = np.array(list(range(n - 1)) + [0, 5], np.int32)
    j = np.array(list(range(1, n)) + [n - 1, 15], np.int32)
    rel = pgo.relative_pose(*[torch.from_numpy(a) for a in (rv[i], tv[i], rv[j], tv[j])])
    noise = lambda a: a + torch.from_numpy(rng.normal(size=a.shape).astype(np.float32)) * 0.02
    w = torch.tensor([1.0] * (n - 1) + [4.0, 4.0])
    kw = dict(n_iters=10, damping=1e-4, solver=solver, cg_iters=150, cg_tol=1e-12, offchain_cap=2)
    if graph == "se3":
        edges = pgo.PoseGraphEdges(torch.from_numpy(i), torch.from_numpy(j), noise(rel[0]),
                                   noise(rel[1]), w)
        poses = pgo.Poses(torch.from_numpy(rv) + 0.02, torch.from_numpy(tv) + 0.1)
        run = pgo.optimize_pose_graph
    else:
        metric = torch.tensor([0.0] * (n - 1) + [1.0, 1.0])
        edges = ps.Sim3Edges(torch.from_numpy(i), torch.from_numpy(j), noise(rel[0]),
                             noise(rel[1]), torch.zeros(n + 1), w, metric)
        poses = ps.se3_to_sim3_poses(torch.from_numpy(rv) + 0.02, torch.from_numpy(tv) + 0.1)
        run = ps.optimize_sim3_graph
    cpu = run(poses, edges, **kw)
    gpu = run(_to(poses, dev), _to(edges, dev), **kw)
    for c, g in zip(cpu, gpu):
        assert g.is_cuda and bool(torch.isfinite(g).all())
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * max(1.0, float(c.abs().max()))


def test_odometry_graph_step_equals_the_eager_step_on_the_card(dev):
    """run_odometry with loop closure on a synthetic out-and-back scene:
    the steady step captured as CUDA graphs and the eager step draw the same
    numbers from the same generator and give the same trajectory (1e-4);
    the graph run replayed captured steps."""
    from sift_parallel_optimization_tpu_torch.models import frontend, odometry
    from sift_parallel_optimization_tpu_torch.utils import synthetic

    k_np = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    pts, descs = synthetic.landmarks(rng, 300, lo=(-5, -3, 6), hi=(12, 3, 12))
    rv, tv = synthetic.out_and_back(14, step=(-1.0, 0.03, 0.07))
    feats = [frontend.features_from_numpy(
        synthetic.view_features(rng, pts, descs, rv[f], tv[f], k_np, 400, 300, 320), dev)
        for f in range(14)]
    runs = {}
    for graph in (False, True):
        gen = torch.Generator(device=dev).manual_seed(0)
        runs[graph] = odometry.run_odometry(gen, feats, torch.from_numpy(k_np).to(dev), window=4,
                                            pts_per_frame=64, loop_closure=True, graph=graph,
                                            return_info=True)
    (e_traj, _em, e_info), (g_traj, _gm, g_info) = runs[False], runs[True]
    assert g_info["graph_replays"] > 0 and e_info["graph_replays"] == 0
    assert g_info["loop_frames"] == e_info["loop_frames"] and e_info["loop_frames"]
    assert float((g_traj.rvecs - e_traj.rvecs).abs().max()) <= 1e-4
    assert float((g_traj.tvecs - e_traj.tvecs).abs().max()) <= 1e-4
