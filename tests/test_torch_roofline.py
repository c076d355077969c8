"""The port's roofline (``bench/roofline.py``) against the JAX package's:
the same bytes, flops and gathered elements for the same configuration
(rel 1e-12; the one stated exception: ``descriptor_model`` counts copies
read plus write), the laws ``tests/test_roofline.py`` checks under the
H100's peaks, the peak lookup by part, and the kernel builders against the
bounds ``chip_smoke.py`` printed on the card (PERF.md section 6)."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu.bench import roofline as jr
from sift_parallel_optimization_tpu.models import descriptor as jdesc
from sift_parallel_optimization_tpu.models.frontend import sift_config as jax_sift_config
from sift_parallel_optimization_tpu_torch.bench import roofline as tr
from sift_parallel_optimization_tpu_torch.models import descriptor as tdesc
from sift_parallel_optimization_tpu_torch.models.frontend import sift_config

REL = 1e-12
H100 = tr.H100_SXM
# Port field -> JAX field.
FIELDS = {"hbm_bytes": "hbm_bytes", "matmul_f32_flops": "mxu_f32_flops",
          "matmul_default_flops": "mxu_bf16_flops", "elementwise_flops": "vpu_flops",
          "gather_elems": "gather_elems"}


def assert_same_counts(port, jax, skip=()):
    for pf, jf in FIELDS.items():
        if pf not in skip:
            assert getattr(port, pf) == pytest.approx(getattr(jax, jf), rel=REL, abs=0), pf


CFGS = [(256, 3), (512, 3), (1024, 3), (500, 2), (64, 4)]


@pytest.mark.parametrize("size,S", CFGS)
def test_pyramid_and_score_models_equal_jax(size, S):
    cfg, jcfg = sift_config(size, S=S), jax_sift_config(size, S=S)
    assert_same_counts(tr.reference_pyramid_model(size, S), jr.reference_pyramid_model(size, S))
    assert_same_counts(tr.sift_pyramid_model(cfg), jr.sift_pyramid_model(jcfg))
    assert_same_counts(tr.dense_score_model(cfg), jr.dense_score_model(jcfg))


@pytest.mark.parametrize("size,S", CFGS)
@pytest.mark.parametrize("k", [64, 512, 2048])
def test_frontend_models_equal_jax_but_for_copies(size, S, k):
    """Flops equal; bytes differ by the copy convention alone: the JAX
    module charges the patch gather one way and the atlas build as the
    larger of its read and write, the port both as read plus write."""
    cfg, jcfg = sift_config(size, S=S), jax_sift_config(size, S=S)
    assert_same_counts(tr.refit_model(k), jr.refit_model(k))
    rows = jdesc.patch_rows_for(jdesc.max_patch_radius(S, jcfg.sigma0))
    patch = k * rows * jdesc.PATCH_COLS * 4.0
    atlas_rows = sum((S + 3) * (2 * jdesc.ROW_PAD + n) for n in jr._octave_sizes(size, jcfg.n_octaves))
    atlas = atlas_rows * (jdesc.COL_PAD + size + 128) * 4.0
    pyr = sum(4.0 * n * n * (S + 3) for n in jr._octave_sizes(size, jcfg.n_octaves))
    extra = patch + min(atlas, pyr)
    port, jax = tr.descriptor_model(cfg, k), jr.descriptor_model(jcfg, k)
    assert_same_counts(port, jax, skip=("hbm_bytes",))
    assert port.hbm_bytes == pytest.approx(jax.hbm_bytes + extra, rel=REL)
    stages, jstages = tr.stage_models(cfg, k), jr.stage_models(jcfg, k)
    assert list(stages) == list(jstages)
    for name in stages:
        touched = name in ("descriptors", "frontend")
        assert_same_counts(stages[name], jstages[name], skip=("hbm_bytes",) if touched else ())
        assert stages[name].hbm_bytes == pytest.approx(
            jstages[name].hbm_bytes + (extra if touched else 0.0), rel=REL)


@pytest.mark.parametrize("k", [32, 256, 512, 2048])
def test_matching_model_equals_jax(k):
    assert_same_counts(tr.matching_model(k), jr.matching_model(k))
    assert_same_counts(tr.matching_model(k, dim=64), jr.matching_model(k, dim=64))


@pytest.mark.parametrize("window,pts,ba_iters", [(6, 128, 4), (8, 256, 2), (3, 16, 1)])
def test_tracking_models_equal_jax(window, pts, ba_iters):
    assert_same_counts(
        tr.tracking_step_cost(window=window, pts_per_frame=pts, desc_capacity=2 * pts,
                              ba_iters=ba_iters),
        jr.tracking_step_cost(window=window, pts_per_frame=pts, desc_capacity=2 * pts,
                              ba_iters=ba_iters))
    for a in (64 * pts, 8192):
        assert_same_counts(tr.loop_stage_cost(desc_capacity=2 * pts, archive_slots=a),
                           jr.loop_stage_cost(desc_capacity=2 * pts, archive_slots=a))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_link_byte_counts_equal_jax(n_dev):
    for size in (256, 512, 1024):
        cfg, jcfg = sift_config(size), jax_sift_config(size)
        assert tr.sharded_pyramid_ici_bytes(cfg, n_dev) == jr.sharded_pyramid_ici_bytes(jcfg, n_dev)
        assert tr.sharded_pyramid_overlap_model(cfg, n_dev) == pytest.approx(
            jr.sharded_pyramid_overlap_model(jcfg, n_dev), rel=REL)
    for b in (100.0, 12345.0):
        for name in ("ring_all_reduce_bytes", "ring_reduce_scatter_bytes", "ring_all_gather_bytes"):
            assert getattr(tr, name)(b, n_dev) == getattr(jr, name)(b, n_dev)
    assert tr.dp_frontend_ici_bytes() == jr.dp_frontend_ici_bytes() == 0.0
    assert tr.ba_cg_ici_bytes(50, 2000, n_dev) == jr.ba_cg_ici_bytes(50, 2000, n_dev)
    assert tr.ba_cg_ici_bytes(20, 500, n_dev, 4, 10) == jr.ba_cg_ici_bytes(20, 500, n_dev, 4, 10)
    assert tr.ring_matching_ici_bytes(64, 512, n_dev) == jr.ring_matching_ici_bytes(64, 512, n_dev)


def test_projections_follow_the_link_rate_of_the_peaks():
    """At the JAX module's planning rate and latency the projections equal
    JAX's; at NVLink's published rate they are the port's."""
    tpu_rate = dataclasses.replace(H100, link_gbps=jr.ICI_EFFECTIVE_GBPS)
    for n, b in ((1, 1e9), (2, 2e5), (8, 2.15e5), (8, 2.15e7)):
        assert tr.projected_efficiency(0.071, n, b, tpu_rate) == jr.projected_efficiency(0.071, n, b)
        for dep, ex in ((0.1, 2), (0.5, 6)):
            assert tr.projected_efficiency_overlap(
                0.071, n, b, dep, tpu_rate, exchange_latency_us=jr.ICI_EXCHANGE_LATENCY_US,
                n_exchanges=ex) == jr.projected_efficiency_overlap(0.071, n, b, dep, n_exchanges=ex)
    assert H100.link_gbps == 450.0
    b8 = tr.sharded_pyramid_ici_bytes(sift_config(512), 8)
    assert 0 < tr.projected_efficiency(0.071, 8, 100 * b8, H100) < tr.projected_efficiency(
        0.071, 8, b8, H100) <= 1.0


def test_floor_is_max_of_resources_under_h100_peaks():
    m = tr.CostModel(hbm_bytes=3.35e12 * 1e-3)  # exactly 1 ms at 3.35 TB/s
    assert m.floor_ms(H100) == pytest.approx(1.0, rel=1e-12)
    assert m.bound(H100) == "hbm" and m.kernel_bound(H100) == (m.floor_ms(H100), "bytes")
    m2 = tr.CostModel(hbm_bytes=3.35e9, matmul_default_flops=67e12 * 1e-2)
    assert m2.floor_ms(H100) == pytest.approx(10.0, rel=1e-12)
    assert m2.bound(H100) == "matmul" and m2.kernel_bound(H100)[1] == "operations"
    m3 = tr.CostModel(elementwise_flops=67e12 * 2e-3, gather_elems=3.35e12 * 1e-3 / 32)
    assert m3.floor_ms(H100) == pytest.approx(2.0) and m3.bound(H100) == "elementwise"
    m4 = tr.CostModel(gather_elems=3.35e12 * 3e-3 / 32)
    assert m4.floor_ms(H100) == pytest.approx(3.0) and m4.kernel_bound(H100)[1] == "bytes"
    # Both matmul classes run at the fp32 rate: the port pins fp32.
    assert (tr.CostModel(matmul_f32_flops=1e12).floor_ms(H100)
            == tr.CostModel(matmul_default_flops=1e12).floor_ms(H100))


def test_sol_pct_and_addition_laws():
    m = tr.reference_pyramid_model(512, 2)
    f = m.floor_ms(H100)
    assert m.sol_pct(f, H100) == 100.0
    assert m.sol_pct(2 * f, H100) == 50.0
    assert m.sol_pct(0.0, H100) == 0.0
    total = m + tr.refit_model(512)
    assert total.hbm_bytes == m.hbm_bytes and total.gather_elems == 512 * 19 * 2
    cfg256, cfg512 = sift_config(256), sift_config(512)
    for build in (tr.sift_pyramid_model, tr.dense_score_model):
        assert 0 < build(cfg256).floor_ms(H100) < build(cfg512).floor_ms(H100)
    assert 0 < tr.descriptor_model(cfg512, 256).floor_ms(H100) < tr.descriptor_model(
        cfg512, 512).floor_ms(H100)
    stages = tr.stage_models(cfg512, 512)
    parts = sum(stages[s].floor_ms(H100) for s in ("pyramid", "dense_score", "refit", "descriptors"))
    assert 0.5 * parts < stages["frontend"].floor_ms(H100) <= parts + 1e-12
    # A unit slip (bytes vs bits, ms vs us) cannot pass: the headline's floor
    # is ~8.4 MB at 3.35 TB/s.
    assert 0.002 < f < 0.004


def test_cpu_has_no_floor_and_an_unknown_part_raises(monkeypatch):
    assert tr.device_peaks("cpu") is None
    m = tr.frontend_model(sift_config(512), 512)
    assert m.floor_ms(None) is None and m.bound(None) is None and m.sol_pct(1.0, None) is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_a: "NVIDIA H100 80GB HBM3")
    assert tr.device_peaks("cuda") is H100
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_a: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no published peaks"):
        tr.device_peaks("cuda:0")
    with pytest.raises(ValueError, match="no roofline"):
        tr.device_peaks("meta")


# ---------------------------------------------------------------------------
# The kernel builders against chip_smoke.py's bounds of the card run (PERF.md
# section 6, the bounds phase: 4 decimals; the kernels line: full values).
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _octave_shapes(size, S=3, planes=None):
    cfg = sift_config(size, S=S)
    return tuple((cfg.S + 3 if planes is None else planes, n, n) for n in cfg.sizes)


def _atlas_shape(size, S=3):
    lay = tdesc._atlas_static(_octave_shapes(size, S), "cpu")
    return lay["n_rows"], lay["n_cols"]


def _close(got, want):
    """Within 1%, or within half a unit of the printed 4th decimal."""
    assert abs(got - want) <= max(0.01 * want, 0.5e-4), (got, want)


@pytest.mark.parametrize("n,want", [(512, 0.0024), (1024, 0.0096), (4096, 0.1536)])
def test_reference_dog_kernel_bound_equals_chip_smoke(n, want):
    ms, by = tr.reference_dog_kernel_model(n, 2).kernel_bound(H100)
    _close(ms, want)
    assert by == "bytes"


def test_patch_gather_bounds_equal_chip_smoke():
    assert _atlas_shape(512) == (11472, 768) and _atlas_shape(256) == (7632, 512)
    rows, cols = 96, 256
    cases = [(512, 1, 512, 0.025545590447761193), (256, 1, 512, 0.0197), (1024, 1, 2048, 0.0882),
             (512, 8, 512, 0.20436472358208954), (256, 8, 256, 0.0974), (1024, 8, 2048, 0.7056)]
    for size, b, k, want in cases:
        r, c = _atlas_shape(size)
        ms, by = tr.patch_gather_model(b * k, rows, cols, b * r * c).kernel_bound(H100)
        _close(ms, want)
        assert by == "bytes"


@pytest.mark.parametrize("atlas_shape", [(60, 80), (3, 60, 80)])
def test_patch_footprint_is_the_union_of_the_windows(atlas_shape):
    """Kernel 2a / 2b's read: the atlas pixels some window covers, origins
    normalised as the kernel normalises them (negative from the end, then
    clamped), per frame of a stack or over one shared atlas; the model
    charges it in place of the patches' pixels."""
    from sift_parallel_optimization_tpu_torch.ops.patch_gather import _normalise

    rng = np.random.default_rng(0)
    lead = () if len(atlas_shape) == 2 else (atlas_shape[0],)
    ys = torch.from_numpy(rng.integers(-70, 70, (*lead, 7)).astype(np.int32))
    xs = torch.from_numpy(rng.integers(-90, 90, (*lead, 7)).astype(np.int32))
    rows, cols = 9, 13
    y0, x0 = _normalise(ys, xs, atlas_shape[-2], atlas_shape[-1], rows, cols)
    covered = np.zeros((len(lead) and lead[0] or 1, *atlas_shape[-2:]), bool)
    for idx in np.ndindex(*ys.shape):
        covered[idx[0] if lead else 0, y0[idx]:y0[idx] + rows, x0[idx]:x0[idx] + cols] = True
    foot = tr.patch_footprint_bytes(atlas_shape, ys, xs, rows, cols)
    assert foot == covered.sum() * 4.0 < 7 * max(1, len(lead) and lead[0]) * rows * cols * 4
    n = ys.numel()
    model = tr.patch_gather_model(n, rows, cols, int(np.prod(atlas_shape)), foot)
    assert model.hbm_bytes == foot + n * (rows * cols * 4.0 + 8.0)


@pytest.mark.parametrize("size,b,want", [(256, 1, 0.0006), (512, 1, 0.002218469253731343),
                                         (512, 8, 0.0177), (1024, 1, 0.0088), (1024, 8, 0.0706)])
def test_score_tables_bound_equals_chip_smoke(size, b, want):
    ms, by = tr.score_tables_model(_octave_shapes(size, planes=5), b).kernel_bound(H100)
    _close(ms, want)
    assert by == "bytes"


def test_score_rows_and_resample_bounds_equal_chip_smoke():
    _close(tr.score_rows_model(5, 512, 512).kernel_bound(H100)[0], 0.0016)
    _close(tr.score_rows_model(5, 1024, 1024).kernel_bound(H100)[0], 0.0064)
    # Kernel 4's footprint depends on chip_smoke.py's drawn radii: replay its
    # generator through the kernel 2, 2b and 4 phases that draw from it.
    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    for size, k in cs.K2_CONFIGS:
        cs.gather_origins(torch, rng, k, *_atlas_shape(size), 96, 256, "cpu")
    for size, k in cs.K2B_CONFIGS:
        cs.batched_gather_origins(torch, rng, cs.BATCH, k, *_atlas_shape(size), 96, 256, "cpu")
    for (size, k), want in zip(((512, 512), (1024, 2048)), (0.0031930459701492537, 0.0128)):
        atlas = torch.empty(_atlas_shape(size), device="meta")
        params = cs.kernel4_inputs(torch, rng, k, atlas, "cpu")[3]
        foot = tr.resample_footprint_bytes(params, atlas.numel())
        ms, by = tr.gather_resample_model(k, foot).kernel_bound(H100)
        _close(ms, want)
        assert by == "bytes"
