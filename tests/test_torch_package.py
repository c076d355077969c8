"""Package hygiene of the PyTorch port: no JAX import, CPU tensors take the
plain paths, configs and keypoints cross over from the JAX package, and the
kernel build fails loudly."""

import dataclasses
import hashlib
import pkgutil
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import sift_parallel_optimization_tpu_torch as port
from sift_parallel_optimization_tpu.config import PyramidConfig as JaxConfig
from sift_parallel_optimization_tpu.config import ScaleSpaceMode as JaxMode
from sift_parallel_optimization_tpu.utils import native as jnative
from sift_parallel_optimization_tpu_torch import config as tconfig
from sift_parallel_optimization_tpu_torch.core import pyramid_ref as tpr
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.models import descriptor as tdesc
from sift_parallel_optimization_tpu_torch.ops import _build
from sift_parallel_optimization_tpu_torch.ops import descriptor_hist as tdh
from sift_parallel_optimization_tpu_torch.ops import gather_resample as tgr
from sift_parallel_optimization_tpu_torch.ops import patch_gather as tpg
from sift_parallel_optimization_tpu_torch.ops import scale_space as tss
from sift_parallel_optimization_tpu_torch.ops import score_tables as tst
from sift_parallel_optimization_tpu_torch.utils import native as tnative
from sift_parallel_optimization_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
HOST_SRC = REPO / "sift_parallel_optimization_tpu_torch" / "csrc" / "sift_host.cpp"


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
    )


def test_port_imports_no_jax():
    mods = _port_modules()
    for name in ("models.frontend", "models.geometry", "models.ba", "models.matching",
                 "models.sfm", "models.odometry", "parallel.frontend", "utils.device",
                 "utils.native", "utils.profiling", "cli", "bench.roofline", "bench.suite",
                 "ops.blur_product", "core.numpy_golden"):
        assert f"sift_parallel_optimization_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('sift_parallel_optimization_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax_module():
    """No source of the port or of chip_smoke.py imports jax or the JAX
    package, even inside a function that the import walk does not run."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|sift_parallel_optimization_tpu)\b[^_]",
                     re.MULTILINE)
    files = sorted(Path(port.__path__[0]).rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [str(f.relative_to(REPO)) for f in files if pat.search(f.read_text())]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["batched_extract_features", "empty_map", "resolve_device"])
def test_new_entry_points_default_to_the_card_and_raise_without_one(monkeypatch, entry):
    from sift_parallel_optimization_tpu_torch.models import sfm as tsfm
    from sift_parallel_optimization_tpu_torch.parallel import frontend as tpf
    from sift_parallel_optimization_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = np.zeros((2, 32, 32), np.float32)
    cfg = tfe.sift_config(32)
    calls = {
        "batched_extract_features": lambda dev: tpf.batched_extract_features(
            frames, cfg, 8, device=dev),
        "empty_map": lambda dev: tsfm.empty_map(2, 4, device=dev),
        "resolve_device": lambda dev: resolve_device(dev),
    }
    for dev in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry](dev)
    out = calls[entry]("cpu")                      # the caller asks for the CPU
    first = out if isinstance(out, torch.device) else (
        out.descriptors if entry == "batched_extract_features" else out.points)
    assert torch.device(getattr(first, "device", first)).type == "cpu"
    if entry == "batched_extract_features":
        # A CPU tensor is followed; nothing moves on its own.
        assert tpf.batched_extract_features(torch.from_numpy(frames), cfg, 8) \
            .descriptors.device.type == "cpu"
        with pytest.raises(ValueError, match=r"\(B, H, W\)"):
            tpf.batched_extract_features(torch.from_numpy(frames[0]), cfg, 8)


@pytest.mark.parametrize("entry", ["SiftFrontend", "empty_keypoints", "keypoints_from_numpy",
                                   "features_from_numpy", "sfm_map_from_numpy"])
def test_frontend_and_converters_default_to_the_card_and_raise_without_one(monkeypatch, entry):
    """One rule for the package (utils/device.py): ``device=None`` means the
    card and raises without one; the CPU is only ever asked for."""
    from sift_parallel_optimization_tpu_torch.models import keypoints as tkp
    from sift_parallel_optimization_tpu_torch.models import sfm as tsfm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kp = {f: np.zeros(4, np.float32) for f in tkp.Keypoints._fields}
    feats = {"keypoints": kp, "descriptors": np.zeros((4, 128), np.float32)}
    smap = tsfm.sfm_map_to_numpy(tsfm.empty_map(2, 4, device="cpu"))
    calls = {
        "SiftFrontend": lambda **kw: tfe.SiftFrontend(tfe.sift_config(32), max_keypoints=8, **kw),
        "empty_keypoints": lambda **kw: tkp.empty_keypoints(4, **kw),
        "keypoints_from_numpy": lambda **kw: tkp.keypoints_from_numpy(kp, **kw),
        "features_from_numpy": lambda **kw: tfe.features_from_numpy(feats, **kw),
        "sfm_map_from_numpy": lambda **kw: tsfm.sfm_map_from_numpy(smap, **kw),
    }
    for kw in ({}, {"device": None}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry](**kw)
    out = calls[entry](device="cpu")               # the caller asks for the CPU
    if entry == "SiftFrontend":
        assert out.device.type == "cpu"
        got = out(torch.from_numpy(tnative.synth_frame(32, 0, seed=1)))
        assert got.descriptors.shape == (8, 128) and got.descriptors.device.type == "cpu"
    else:
        leaves = [t for f in out for t in (f if isinstance(f, tuple) else (f,))]
        assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_cpu_tensors_take_plain_paths(monkeypatch):
    for mod in (tss, tpg, tst, tgr, tdh):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    monkeypatch.setattr(tpg, "LAUNCHES_BATCHED", 0)
    img = torch.from_numpy(tnative.synth_frame(64, 0, seed=5))
    tpr.reference_dog_pyramid(img, 2)
    feats = tfe.extract_features(img, tfe.sift_config(64), 32)
    assert feats.descriptors.shape == (32, 128)
    # Both accelerator branches, forced on CPU tensors: plain versions only.
    monkeypatch.setattr(tdesc, "USE_FUSED_SAMPLING", True)
    feats = tfe.extract_features(img, tfe.sift_config(64), 32, use_approx_topk=True)
    assert feats.descriptors.shape == (32, 128)
    tst.score_tables_rows(torch.zeros(5, 8, 8), 0.01, 10.0)
    from sift_parallel_optimization_tpu_torch.parallel.frontend import batched_extract_features

    monkeypatch.setattr(tdesc, "USE_FUSED_SAMPLING", False)
    feats = batched_extract_features(torch.stack([img, img]), tfe.sift_config(64), 32,
                                     use_approx_topk=True)
    assert feats.descriptors.shape == (2, 32, 128)
    assert tss.LAUNCHES == tpg.LAUNCHES == tst.LAUNCHES == tgr.LAUNCHES == tdh.LAUNCHES == 0
    assert tpg.LAUNCHES_BATCHED == 0


def test_wrappers_refuse_other_devices():
    meta = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tss.reference_dog_pyramid(meta, 2)
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpg.extract_atlas_patches(meta, idx, idx, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tss.reference_dog_pyramid_cuda(torch.zeros(8, 8), 2)
    dog = torch.empty((5, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tst.score_tables_rows(dog, 0.01, 10.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tst.score_block_top2(dog.reshape(1, -1), [(5, 8, 8)], 0.01, 10.0, 1)
    params = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgr.gather_resample(torch.empty((128, 256), device="meta"), idx, idx, params)
    with pytest.raises(ValueError, match="CUDA"):
        tst.score_block_top2_cuda(torch.zeros(1, 320), [(5, 8, 8)], 0.01, 10.0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        origin = torch.zeros(2, dtype=torch.int32)
        tgr.gather_resample_cuda(torch.zeros(128, 256), origin, origin, torch.zeros(2, 4))


def test_config_from_jax_fields_round_trips():
    jcfg = JaxConfig(length=256, S=3, mode=JaxMode.SIFT, max_octaves=4)
    d = dataclasses.asdict(jcfg)
    d["dtype"] = np.dtype(jcfg.dtype).name
    cfg = tconfig.config_from_jax_fields(d)
    assert cfg.mode is tconfig.ScaleSpaceMode.SIFT and cfg.dtype == torch.float32
    for f in ("length", "S", "sigma0", "assumed_blur", "max_octaves",
              "min_octave_size", "blur_precision", "n_octaves", "sizes",
              "n_scales", "n_dog"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.sift_sigmas() == jcfg.sift_sigmas()
    # As the JAX package's test_blur_precision_knob: "high" (3-pass bf16)
    # is accepted, the 1-pass "default" refused.
    assert tconfig.PyramidConfig(blur_precision="high").blur_precision == "high"
    with pytest.raises(ValueError, match="default"):
        tconfig.PyramidConfig(blur_precision="default")


def test_octave_counts_match_jax():
    from sift_parallel_optimization_tpu import config as jconfig

    for n in (1, 2, 7, 64, 100, 512, 1000):
        assert tconfig.num_octaves(n) == jconfig.num_octaves(n)
        assert tconfig.octave_sizes(n) == jconfig.octave_sizes(n)
        assert tconfig.octave_sizes(n, 3) == jconfig.octave_sizes(n, 3)


def test_native_loader_matches_jax_package(tmp_path, monkeypatch):
    # Two native results, never a native one against a NumPy fallback: the
    # port's loader first, then the JAX loader, with a failure it may have
    # cached in this process (a half-written library) cleared.
    assert tnative._load() is not None, tnative._build_error
    if jnative._load() is None:
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_build_error", None)
    assert jnative._load() is not None, jnative._build_error
    np.testing.assert_array_equal(tnative.synth_frame(96, 2, seed=4),
                                  jnative.synth_frame(96, 2, seed=4))
    rv, tv = np.array([0.0, 0.1, 0.0]), np.array([0.2, 0.0, 0.0])
    np.testing.assert_array_equal(tnative.render_frame(64, rv, tv, 64.0),
                                  jnative.render_frame(64, rv, tv, 64.0))
    img = tnative.synth_frame(32, 0)
    tnative.write_pgm(tmp_path / "a.pgm", img)
    np.testing.assert_array_equal(tnative.read_pgm(tmp_path / "a.pgm"),
                                  jnative.read_pgm(tmp_path / "a.pgm"))


def test_numpy_frame_fallback_matches_jax_fallback():
    # The windowed fallback drops blob tails below exp(-18) of the amplitude.
    np.testing.assert_allclose(tnative._synth_frame_numpy(64, 1, 7),
                               jnative._synth_frame_numpy(64, 1, 7), rtol=0, atol=1e-6)


def test_kernel_build_fails_loudly(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "LIB_PATH", tmp_path / "lib.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(force=True)


def test_native_loader_survives_simultaneous_first_loads(tmp_path):
    """Four processes build and load the port's host library from one fresh
    copy of its source (``csrc/sift_host.cpp``) into one empty build
    directory at the same moment: all get the library and equal frames."""
    shutil.copy(HOST_SRC, tmp_path / "sift_host.cpp")
    code = textwrap.dedent("""
        import hashlib, sys, time
        from pathlib import Path
        from sift_parallel_optimization_tpu_torch.utils import native
        d = Path(sys.argv[1])
        native._SRC, native._BUILD_DIR = d / "sift_host.cpp", d
        (d / f"ready.{sys.argv[2]}").touch()
        t0 = time.time()
        while len(list(d.glob("ready.*"))) < 4 and time.time() - t0 < 120:
            time.sleep(0.001)
        frame = native.synth_frame(64, 1)
        print(native._lib is not None, hashlib.sha256(frame.tobytes()).hexdigest())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), str(i)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    lines = {out.strip() for out, _err in outs}
    assert len(lines) == 1, outs
    native, digest = lines.pop().split()
    assert native == "True", outs
    assert digest == hashlib.sha256(tnative.synth_frame(64, 1).tobytes()).hexdigest()
    assert sorted(p.name for p in tmp_path.glob("libsift_host.so*")) == ["libsift_host.so"]


def test_native_loader_rebuilds_a_half_written_library(tmp_path, monkeypatch):
    """A library another process's build left half-written (newer than its source,
    so not stale) fails to open: the loader rebuilds it under the lock and
    opens it, instead of caching the failure."""
    shutil.copy(HOST_SRC, tmp_path / "sift_host.cpp")
    assert tnative._load() is not None
    real = (tnative._BUILD_DIR / "libsift_host.so").read_bytes()
    (tmp_path / "libsift_host.so").write_bytes(real[:64])   # the ELF header alone
    monkeypatch.setattr(tnative, "_SRC", tmp_path / "sift_host.cpp")
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    assert tnative._load() is not None, tnative._build_error
    frame = tnative.synth_frame(64, 1)
    monkeypatch.undo()
    np.testing.assert_array_equal(frame, tnative.synth_frame(64, 1))


def test_kernel_sources_hash_covers_every_source():
    names = [p.name for p in _build._sources()]
    assert names == ["bf16x3_mm.cu", "descriptor_hist.cu", "gather_resample.cu",
                     "patch_gather.cu", "reference_dog.cu", "score_tables.cu"]
    assert _build.source_hash() == _build.source_hash()
    assert len(_build.source_hash()) == 64


def test_cuda_timer_refuses_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.cuda_time_ms(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.device_kernel_ms(lambda: None)


def test_matcher_and_geometry_refuse_tf32_on_the_card(monkeypatch):
    """The pin that the JAX package's ``_f32_precision`` decorators are: with
    TF32 matmuls allowed, a CUDA tensor is refused (checked without a card
    through a stand-in tensor that says it is one)."""
    from sift_parallel_optimization_tpu_torch.models import geometry as tgeo
    from sift_parallel_optimization_tpu_torch.models import matching as tmatch

    class OnCard:
        is_cuda = True

    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    with pytest.raises(RuntimeError, match="TF32"):
        tpr.check_fp32_matmul(OnCard())
    for fn, n_args in ((tmatch.match_descriptors, 4), (tmatch.ransac_homography, 4),
                       (tmatch.ransac_fundamental, 4), (tgeo.triangulate, 4),
                       (tgeo.pnp_dlt, 4)):
        with pytest.raises(RuntimeError, match="TF32"):
            fn(*[OnCard()] * n_args)
    with pytest.raises(RuntimeError, match="TF32"):
        tgeo.project(OnCard(), None, None, None)
    # A CPU tensor is not held to it: its products are fp32 whatever the flag.
    d = torch.nn.functional.normalize(torch.ones(4, 128), dim=1)
    ok = torch.ones(4, dtype=torch.bool)
    assert tmatch.match_descriptors(d, d, ok, ok).idx2.shape == (4,)
