"""The descriptor histograms (``ops/descriptor_hist``, kernel 6's plain
version) on CPU tensors: the wrapper against the composition it replaced,
against Lowe's histogram written out in float64, its placement of the
orientations' rows and its argument checks. The kernel is held to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import numpy as np
import pytest
import torch

from sift_parallel_optimization_tpu_torch.bench import roofline as R
from sift_parallel_optimization_tpu_torch.models import descriptor as tdesc
from sift_parallel_optimization_tpu_torch.models.frontend import SiftFrontend, sift_config
from sift_parallel_optimization_tpu_torch.ops import descriptor_hist as dh
from sift_parallel_optimization_tpu_torch.utils import native

# float32 against float64: every vote is non-negative, so the sums lose
# nothing to cancellation; a few float32 roundings a vote and two norms.
F64_ATOL = 1e-5


def _inputs(lead, k, seed, n_ori=2, p_valid=0.8):
    """Sample grids (a random field on a ramp), offsets from the program's
    own radii, sigma over the frontend's range, theta and validity, every
    tensor with the slots' (*lead, K) axes."""
    g = torch.Generator().manual_seed(seed)
    n = math.prod(lead) * k
    s = torch.rand((n, 26, 26), generator=g)
    s = s + torch.linspace(0, 1, 26)[None, :, None] * torch.rand((n, 1, 1), generator=g)
    sig_o = torch.rand(n, generator=g) * 5 + 0.8
    _rad_o, rad_d = tdesc._radii(sig_o)
    off = torch.linspace(-1.0, 1.0, 26)[None] * rad_d[:, None]
    valid1 = torch.rand(n, generator=g) < p_valid
    valid2 = valid1 & (torch.rand(n, generator=g) < 0.5)
    thetas = [torch.where(v, (torch.rand(n, generator=g) * 2 - 1) * math.pi, 0.0)
              for v in (valid1, valid2)]
    shape = lambda t: t.reshape(*lead, k, *t.shape[1:])
    oris = tuple((shape(t), shape(v)) for t, v in zip(thetas, (valid1, valid2)))
    return shape(s), shape(off), shape(sig_o), oris[:n_ori]


def _composition(samples, offsets, sig_o, theta, valid):
    """The histogram stage as orient_and_describe ran it per orientation on
    folded (B * K,) slots."""
    flat = lambda t, *tail: t.reshape(-1, *tail)
    hist = dh._descriptors_from_samples(flat(samples, 26, 26), flat(offsets, 26), flat(sig_o),
                                        flat(theta))
    return dh._normalize_desc(hist, flat(valid))


@pytest.mark.parametrize("lead,n_ori", [((), 1), ((), 2), ((3,), 1), ((3,), 2)])
def test_wrapper_equals_the_composition_bit_for_bit(lead, n_ori):
    k = 23
    samples, offsets, sig_o, oris = _inputs(lead, k, seed=len(lead) + n_ori, n_ori=n_ori)
    got = dh.descriptor_hist(samples, offsets, sig_o, oris)
    assert got.shape == (*lead, n_ori * k, 128) and got.dtype == torch.float32
    frames = got.reshape(-1, n_ori * k, 128)
    for i, (theta, valid) in enumerate(oris):
        want = _composition(samples, offsets, sig_o, theta, valid).reshape(-1, k, 128)
        # Orientation i of slot k sits in row i * K + k of its frame.
        block = frames[:, i * k:(i + 1) * k]
        assert torch.equal(block, want)
        v = valid.reshape(-1, k)
        assert bool((block[~v] == 0).all())
        norms = torch.linalg.vector_norm(block[v], dim=-1)
        assert bool(((norms - 1).abs() < 1e-5).all()) and int(v.sum()) > 0


def _lowe_f64(s, off, sig, theta):
    """Lowe's 4x4x8 descriptor of one slot, from its definition in float64."""
    s, off = s.astype(np.float64), off.astype(np.float64)
    gy = (s[2:, 1:-1] - s[:-2, 1:-1]) / 2
    gx = (s[1:-1, 2:] - s[1:-1, :-2]) / 2
    mag, ang = np.hypot(gx, gy), np.arctan2(gy, gx) - theta
    dy, dx = np.meshgrid(off[1:-1], off[1:-1], indexing="ij")
    c, sn, bw = np.cos(theta), np.sin(theta), max(3.0 * sig, 1e-6)
    u, v = (c * dy - sn * dx) / bw, (sn * dy + c * dx) / bw
    w = mag * np.exp(-(u * u + v * v) / 8.0)
    rows, cols = u + 1.5, v + 1.5
    obin = np.mod(ang, 2 * np.pi) / (2 * np.pi) * 8
    hist = np.zeros((4, 4, 8))
    for r in range(4):
        wr = np.maximum(0.0, 1 - np.abs(rows - r))
        for cc in range(4):
            wc = np.maximum(0.0, 1 - np.abs(cols - cc))
            for o in range(8):
                d = np.abs(obin - o)
                wo = np.maximum(0.0, 1 - np.minimum(d, 8 - d))
                hist[r, cc, o] = float((w * wr * wc * wo).sum())
    h = hist.ravel()
    h = np.minimum(h / max(np.linalg.norm(h), 1e-7), 0.2)
    return h / max(np.linalg.norm(h), 1e-7)


def test_plain_version_is_lowes_histogram():
    samples, offsets, sig_o, oris = _inputs((), 12, seed=5, p_valid=1.0)
    got = dh.descriptor_hist(samples, offsets, sig_o, oris).numpy()
    for i, (theta, valid) in enumerate(oris):
        for k in range(12):
            row = got[i * 12 + k]
            if not bool(valid[k]):
                assert not row.any()
                continue
            want = _lowe_f64(samples[k].numpy(), offsets[k].numpy(), float(sig_o[k]),
                             float(theta[k]))
            np.testing.assert_allclose(row, want, rtol=0, atol=F64_ATOL)


def _bad_inputs(case):
    samples, offsets, sig_o, oris = _inputs((2,), 5, seed=1)
    if case == "dtype":
        samples = samples.double()
    elif case == "mask dtype":
        oris = ((oris[0][0], oris[0][1].to(torch.uint8)),)
    elif case == "grid shape":
        samples = samples[..., :25, :].contiguous()
    elif case == "slot shape":
        sig_o = sig_o[:, :4].contiguous()
    elif case == "three orientations":
        oris = oris + oris[:1]
    elif case == "mixed devices":
        oris = ((oris[0][0].to("meta"), oris[0][1]),)
    elif case == "non-contiguous":
        offsets = offsets.transpose(0, 1).contiguous().transpose(0, 1)
    return samples, offsets, sig_o, oris


@pytest.mark.parametrize("case,match", [
    ("dtype", "f32"), ("mask dtype", "bool"), ("grid shape", "expected"),
    ("slot shape", "expected"), ("three orientations", "expected"),
    ("mixed devices", "one device"), ("non-contiguous", "contiguous"),
])
def test_argument_checks_raise(case, match):
    args = _bad_inputs(case)
    with pytest.raises(ValueError, match=match):
        dh.descriptor_hist(*args)
    with pytest.raises(ValueError, match=match):
        dh.descriptor_hist_cuda(*args)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        dh.descriptor_hist_cuda(*_inputs((), 4, seed=2))


@pytest.mark.parametrize("dual,batch", [(False, None), (True, None), (True, 2)])
def test_frontend_calls_the_histograms_once_a_describe(monkeypatch, dual, batch):
    """One descriptor_hist call per orient_and_describe, whatever the batch
    and orientations: on the card, one launch."""
    calls = []

    def counted(samples, offsets, sig_o, orientations):
        calls.append((tuple(samples.shape), len(orientations)))
        return dh.descriptor_hist(samples, offsets, sig_o, orientations)

    monkeypatch.setattr(tdesc, "descriptor_hist", counted)
    fe = SiftFrontend(sift_config(64), max_keypoints=16, dual_orientation=dual, device="cpu")
    frames = [native.synth_frame(64, i, seed=3) for i in range(batch or 1)]
    img = torch.from_numpy(np.stack(frames) if batch else frames[0])
    feats = fe(img)
    lead = (batch,) if batch else ()
    assert calls == [((*lead, 16, 26, 26), 2 if dual else 1)]
    assert feats.descriptors.shape == (*lead, 32 if dual else 16, 128)


def test_descriptor_hist_bound_reads_grids_once_and_writes_rows_once():
    model = R.descriptor_hist_model(16000, 2)
    read = 16000 * (26 * 26 + 26 + 1 + 2 * 1 + 2 * 0.25) * 4
    assert model.hbm_bytes == read + 16000 * 2 * 128 * 4
    assert R.descriptor_hist_model(1000, 1).hbm_bytes < R.descriptor_hist_model(1000, 2).hbm_bytes
    floor, by = model.kernel_bound(R.H100_SXM)
    assert by in ("bytes", "operations") and 0.01 < floor < 0.05
