"""The benchmark's frozen copies give the program's own numbers today."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import frames, roofline, trace

from sift_parallel_optimization_tpu_torch.bench import roofline as port_roofline
from sift_parallel_optimization_tpu_torch.models import descriptor as port_desc
from sift_parallel_optimization_tpu_torch.models.keypoints import Keypoints
from sift_parallel_optimization_tpu_torch.ops import score_tables as port_tables
from sift_parallel_optimization_tpu_torch.utils import native as port_native
from sift_parallel_optimization_tpu_torch.utils import profiling as port_profiling

ORIGINAL_SCENE = dict(background=0.5, x_span=12.0, y_span=9.0, z_near=6.0, z_depth=12.0,
                      wsig_min=0.05, wsig_span=0.12, amp_span=0.9, noise=0.02,
                      min_sigma_px=0.8)


def _original_draws(size, rvec, tvec, seed):
    m64 = port_native._M64
    blobs, _ = port_native._uniforms((seed * 0x9E3779B97F4A7C15 + 777) & m64, 5 * 220)
    pose = 0
    for i in range(3):
        pose = ((pose * 0x100000001B3) & m64) ^ port_native._f32_bits(rvec[i])
        pose = ((pose * 0x100000001B3) & m64) ^ port_native._f32_bits(tvec[i])
    noise, _ = port_native._uniforms((seed * 0x2545F4914F6CDD1D + 99991 + pose) & m64,
                                     size * size)
    return blobs, noise


@pytest.mark.parametrize("size,focal,seed", [(64, 40.0, 9), (96, 80.0, 5), (128, 200.0, 3)])
def test_renderer_copy_matches_the_programs(size, focal, seed):
    rvec = np.array([0.01, 0.02, -0.03], np.float32)
    tvec = np.array([0.1, -0.2, 0.3], np.float32)
    want = port_native._render_frame_numpy(size, rvec, tvec, focal, seed)
    blobs, noise = _original_draws(size, rvec, tvec, seed)
    cam = dict(fx=focal, fy=focal, cx=size / 2, cy=size / 2)
    got = frames.render_view(size, size, rvec, tvec, cam, ORIGINAL_SCENE, blobs, noise)
    # Footprints are summed in float64 here, one by one in float32 there.
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-7)


def test_pool_is_a_function_of_the_seed():
    cfg = {"height": 40, "width": 56, "camera": dict(fx=50.0, fy=50.0, cx=28.0, cy=20.0),
           "scene": dict(ORIGINAL_SCENE, blobs=300),
           "motion": dict(forward=0.05, sway_x=0.1, sway_y=0.02, yaw=0.05, pitch=0.01,
                          period=50)}
    a, b = frames.render_pool(cfg, 3, 2**31 + 11), frames.render_pool(cfg, 3, 2**31 + 11)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, frames.render_pool(cfg, 3, 7))
    assert not np.array_equal(a[0], a[1])
    assert frames.pool_size(376, 1241, 52, 8) * 376 * 1241 * 4 > 50e6


def test_peaks_copy():
    assert roofline.H100_SXM.__dict__ == port_roofline.H100_SXM.__dict__


OCTAVES = {
    "kitti": [(376, 1241), (188, 621), (94, 311), (47, 156), (24, 78), (12, 39)],
    "tum": [(480, 640), (240, 320), (120, 160), (60, 80), (30, 40), (15, 20)],
    "square": [(512, 512), (256, 256), (128, 128), (64, 64), (32, 32), (16, 16)],
}


@pytest.mark.parametrize("shape", sorted(OCTAVES))
@pytest.mark.parametrize("frames_", [1, 8])
def test_score_tables_model_copy(shape, frames_):
    shapes = [(5, h, w) for h, w in OCTAVES[shape]]
    want = port_roofline.score_tables_model(shapes, frames_)
    got = roofline.score_tables_model(shapes, frames_)
    assert got.hbm_bytes == want.hbm_bytes
    assert got.elementwise_flops == want.elementwise_flops
    assert got.floor_ms(roofline.H100_SXM) == pytest.approx(
        want.floor_ms(port_roofline.H100_SXM), rel=1e-12)
    lay = port_tables.table_layout(tuple(shapes))
    assert [(o.n, o.dense, o.vg) for o in lay] == roofline.table_entries(shapes)


def _keypoints(octaves, k, seed, frames_=1):
    g = torch.Generator().manual_seed(seed)
    o = torch.randint(0, len(octaves), (frames_, k), generator=g)
    hw = torch.tensor(octaves, dtype=torch.float32)[o]
    mult = torch.exp2(o.float())
    y = (1 + torch.rand((frames_, k), generator=g) * (hw[..., 0] - 3)) * mult
    x = (1 + torch.rand((frames_, k), generator=g) * (hw[..., 1] - 3)) * mult
    return Keypoints(x=x, y=y, sigma=1.6 * mult, score=torch.ones_like(x),
                     orientation=torch.zeros_like(x), octave=o.to(torch.int32),
                     scale=torch.randint(1, 4, (frames_, k), generator=g, dtype=torch.int32),
                     valid=torch.ones((frames_, k), dtype=torch.bool))


@pytest.mark.parametrize("shape", sorted(OCTAVES))
def test_atlas_and_patch_origins_copy(shape):
    octs = OCTAVES[shape]
    shapes = [(6, h, w) for h, w in octs]
    lay = roofline.atlas_layout(shapes)
    want = port_desc._atlas_static(tuple(shapes), "cpu")
    assert (lay["n_rows"], lay["n_cols"]) == (want["n_rows"], want["n_cols"])
    radius = port_desc.max_patch_radius(3, 1.6)
    assert radius == roofline.max_patch_radius(3, 1.6)
    rows = port_desc.patch_rows_for(radius)
    assert rows == roofline.patch_rows_for(radius)
    kp = _keypoints(octs, 300, seed=len(shape))
    flat = Keypoints(*[f[0] for f in kp])
    grow, x0, *_ = port_desc._patch_origins(want, len(octs), flat, radius, rows)
    ys, xs = roofline.patch_origins(lay, {f: v.numpy() for f, v in flat._asdict().items()},
                                    radius, rows)
    assert np.array_equal(ys, grow.numpy()) and np.array_equal(xs, x0.numpy())


@pytest.mark.parametrize("n,frames_", [(40, 1), (300, 1), (120, 8)])
def test_patch_gather_model_copy(n, frames_):
    octs = OCTAVES["tum"]
    shapes = [(6, h, w) for h, w in octs]
    lay = roofline.atlas_layout(shapes)
    static = port_desc._atlas_static(tuple(shapes), "cpu")
    radius = roofline.max_patch_radius(3, 1.6)
    rows, cols = roofline.patch_rows_for(radius), roofline.PATCH_COLS
    kp = _keypoints(octs, n, seed=n, frames_=frames_)
    foot, ys_all, xs_all = 0.0, [], []
    for f in range(frames_):
        one = {k: v[f].numpy() for k, v in kp._asdict().items()}
        ys, xs = roofline.patch_origins(lay, one, radius, rows)
        foot += roofline.patch_footprint_bytes(lay["n_rows"], lay["n_cols"], ys, xs, rows, cols)
        ys_all.append(ys)
        xs_all.append(xs)
    ys_t, xs_t = torch.tensor(np.stack(ys_all)), torch.tensor(np.stack(xs_all))
    atlas_shape = ((frames_, static["n_rows"], static["n_cols"]) if frames_ > 1
                   else (static["n_rows"], static["n_cols"]))
    want_foot = port_roofline.patch_footprint_bytes(
        atlas_shape, ys_t if frames_ > 1 else ys_t[0], xs_t if frames_ > 1 else xs_t[0],
        rows, cols)
    assert foot == want_foot
    numel = frames_ * lay["n_rows"] * lay["n_cols"]
    got = roofline.patch_gather_model(frames_ * n, rows, cols, numel, foot)
    want = port_roofline.patch_gather_model(frames_ * n, rows, cols, numel, want_foot)
    assert got.hbm_bytes == want.hbm_bytes
    assert got.floor_ms(roofline.H100_SXM) == pytest.approx(
        want.floor_ms(port_roofline.H100_SXM), rel=1e-12)


def test_launch_and_busy_arithmetic_copy():
    assert trace.LAUNCHES == port_profiling._LAUNCHES
    rng = np.random.default_rng(4)
    iv = [(float(s), float(s + d)) for s, d in zip(rng.uniform(0, 100, 60), rng.uniform(0, 5, 60))]
    grid = np.zeros(110_000, bool)
    for s, e in iv:
        grid[int(round(s * 1000)):int(round(e * 1000))] = True
    assert trace.union_length(iv) == pytest.approx(grid.sum() / 1000, abs=0.1)
    assert sum(b - a for a, b in trace.union(iv)) == pytest.approx(trace.union_length(iv))
