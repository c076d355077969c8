"""Rank workers of the port's multi-rank tests (``tests/test_torch_parallel_*``).

This module imports no JAX: a rank imports it and nothing of the test
files. A test starts the ranks of one suite at world sizes 2 and 4 with
:func:`start` (``python tests/torch_dist_workers.py``: one process imports
torch and the port, then forks one OS process a rank), and :func:`finish`
waits for them with a join timeout; ranks still running then are killed
and the test fails. The ranks meet
through a ``FileStore`` under the test's temporary directory (no TCP port
two xdist workers could both pick) and run gloo on the CPU with one thread
each. A suite runs every case of its test file on every mesh shape of the
world size (:data:`MESH_SHAPES`) and rank 0 writes the global results to
one ``.npz``. :func:`world1` runs a suite in the test's own process at world
size 1 (gloo over a ``HashStore``).

The inputs are built here from seeds with numpy, so a test builds the same
ones for the JAX package and for the port's unsharded functions.
"""

from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# Each spawn's join timeout (a hung collective must fail the test, not run
# the suite into its time limit) and the process group's own timeout.
JOIN_TIMEOUT_S = 120
PG_TIMEOUT_S = 90
MESH_SHAPES = {1: ((1, 1),), 2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2), (4, 1))}
K_NP = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]], np.float32)
SFM_FRAMES, SFM_B, SFM_PTS, SFM_CAPACITY = 7, 64, 200, 256


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def normal_image(size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(size, size)).astype(np.float32)


def unit_image(size: int, seed: int, width: int | None = None) -> np.ndarray:
    return np.random.default_rng(seed).random((size, width or size), np.float32)


def blob_frames(b: int, size: int) -> np.ndarray:
    """tests/test_parallel_frontend.py's frames: Gaussian blobs on grey with
    a little noise, frame i from seed i."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    out = []
    for i in range(b):
        img = np.full((size, size), 0.5, np.float32)
        fr = np.random.default_rng(i)
        for _ in range(12):
            cy, cx = fr.uniform(10, size - 10, 2)
            s = fr.uniform(2, 5)
            img += fr.uniform(-0.4, 0.4) * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
        img += 0.1 * (fr.random((size, size), np.float32) - 0.5)
        out.append(img)
    return np.stack(out).astype(np.float32)


def fake_keyframes(seed: int, F: int, K: int, n_shared: int = 20):
    """tests/test_parallel_matching.py's keyframes: adjacent frames share
    rotating landmarks, a few invalid slots a frame."""
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(F + n_shared, 128)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    desc = np.zeros((F, K, 128), np.float32)
    valid = np.zeros((F, K), bool)
    for f in range(F):
        own = rng.normal(size=(K - n_shared, 128)).astype(np.float32)
        own /= np.linalg.norm(own, axis=-1, keepdims=True)
        d = np.concatenate([bank[f:f + n_shared], own])
        d = d + 0.01 * rng.normal(size=d.shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        desc[f] = d
        valid[f, :K - 3] = True
    return desc, valid


def ba_scene(n_cams: int, n_pts: int, seed: int):
    """tests/test_parallel_ba.py's scene in numpy: cameras on an arc, exact
    projections, a perturbed start. Returns (start (rv, tv, pts), obs
    (cam, pt, uv, valid), K)."""
    from sift_parallel_optimization_tpu_torch.utils.synthetic import rodrigues_np

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, size=(n_pts, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    rv = np.array([[0.0, 0.08 * (i - n_cams / 2), 0.0] for i in range(n_cams)], np.float32)
    tv = np.array([[0.4 * (i - n_cams / 2), 0.0, 0.0] for i in range(n_cams)], np.float32)
    k = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    uv = []
    for i in range(n_cams):
        pc = pts.astype(np.float64) @ rodrigues_np(rv[i]).T + tv[i]
        uv.append(((pc / pc[:, 2:]) @ k.T.astype(np.float64))[:, :2])
    obs = (np.repeat(np.arange(n_cams), n_pts).astype(np.int32),
           np.tile(np.arange(n_pts), n_cams).astype(np.int32),
           np.concatenate(uv).astype(np.float32), np.ones(n_cams * n_pts, bool))
    start = (rv + 0.01 * rng.normal(size=rv.shape).astype(np.float32),
             tv + 0.03 * rng.normal(size=tv.shape).astype(np.float32),
             pts + 0.05 * rng.normal(size=pts.shape).astype(np.float32))
    return start, obs, k


def circle_graph(seed: int, n: int = 12, radius: float = 2.0, padding: int = 3):
    """tests/test_torch_pose_graph.py's circle in numpy: an odometry chain
    and one loop edge from the truth, ``padding`` inert edges, a drifted
    start. Returns (edges dict, start dict)."""
    import torch

    from sift_parallel_optimization_tpu_torch.models.pose_graph import relative_pose
    from sift_parallel_optimization_tpu_torch.utils.synthetic import rodrigues_np

    rng = np.random.default_rng(seed)
    rv, tv = [], []
    for k in range(n):
        ang = 2 * np.pi * k / n
        rv.append([0.0, ang, 0.0])
        c = np.array([radius * np.cos(ang), 0.0, radius * np.sin(ang)])
        tv.append(-rodrigues_np(np.array(rv[-1])) @ c)
    rv, tv = np.asarray(rv, np.float32), np.asarray(tv, np.float32)
    pairs = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0)]
    ii, jj = np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])
    rr, rt = (a.numpy() for a in relative_pose(*map(torch.from_numpy, (
        rv[ii], tv[ii], rv[jj], tv[jj]))))
    z = np.zeros((padding, 3), np.float32)
    edges = dict(i=np.concatenate([ii, np.zeros(padding)]).astype(np.int32),
                 j=np.concatenate([jj, np.zeros(padding)]).astype(np.int32),
                 rel_rvec=np.concatenate([rr, z]).astype(np.float32),
                 rel_tvec=np.concatenate([rt, z]).astype(np.float32),
                 weight=np.array([1.0] * (n - 1) + [4.0] + [0.0] * padding, np.float32))
    start = dict(rvecs=(rv + np.vstack([np.zeros((1, 3)), rng.normal(size=(n - 1, 3)) * 0.05])
                        ).astype(np.float32),
                 tvecs=(tv + np.vstack([np.zeros((1, 3)), rng.normal(size=(n - 1, 3)) * 0.15])
                        ).astype(np.float32))
    return edges, start


def sfm_features():
    """tests/test_torch_sfm_run.py's scene: 7 frames out and back, 256 slots."""
    from sift_parallel_optimization_tpu_torch.utils import synthetic

    rng = np.random.default_rng(0)
    pts, descs = synthetic.landmarks(rng, SFM_PTS)
    rv, tv = synthetic.out_and_back(SFM_FRAMES)
    return [synthetic.view_features(rng, pts, descs, rv[i], tv[i], K_NP, 400, 300, SFM_CAPACITY)
            for i in range(SFM_FRAMES)]


def sfm_sampler(kind, frame, valid, n_hyp, n_pts):
    """Injected RANSAC draws: a numpy generator seeded by (kind, frame),
    uniform over the valid slots, so every run of run_sfm draws alike."""
    import torch

    rng = np.random.default_rng([("init", "pnp", "loop").index(kind), frame])
    w = valid.cpu().numpy().astype(np.float64)
    w = w / w.sum() if w.sum() else np.full(len(w), 1.0 / len(w))
    return torch.from_numpy(rng.choice(len(w), size=(n_hyp, n_pts), p=w).astype(np.int64))


SFM_KW = dict(pts_per_frame=SFM_B, loop_min_gap=2, loop_min_inliers=20,
              pair_selection="covisibility", sampler=sfm_sampler)


def loop_world(n_frames: int = 6, b: int = 64, n_pts: int = 200):
    """tests/test_torch_loop_closure.py's map in numpy: the first point
    blocks hold the scene's landmarks, the way back drifts; the loop poses
    of frames 5 and 4 are their true poses. Returns (map arrays, frames,
    loop (rvec, tvec) pairs)."""
    from sift_parallel_optimization_tpu_torch.models import sfm
    from sift_parallel_optimization_tpu_torch.utils import synthetic

    rng = np.random.default_rng(0)
    pts, descs = synthetic.landmarks(rng, n_pts)
    rv, tv = synthetic.out_and_back(n_frames)
    drift = np.cumsum(rng.normal(size=(n_frames, 3)) * 0.02, axis=0).astype(np.float32)
    drift[:3] = 0.0
    P = n_frames * b
    m = sfm.sfm_map_to_numpy(sfm.empty_map(n_frames, b, device="cpu"))
    m.update(rvecs=rv.astype(np.float32), tvecs=(tv + drift).astype(np.float32),
             cam_valid=np.ones(n_frames, bool),
             points=np.pad(pts, ((0, P - n_pts), (0, 0))).astype(np.float32),
             pt_valid=np.arange(P) < n_pts,
             pt_desc=np.pad(descs, ((0, P - n_pts), (0, 0))).astype(np.float32))
    frames = [5, 4]
    return m, frames, [(rv[f].astype(np.float32), tv[f].astype(np.float32)) for f in frames]


def flat_map(m, prefix: str) -> dict:
    """An SfmMap as {prefix/field: array}, observations as prefix/obs_<field>."""
    out = {f"{prefix}/{f}": v.detach().cpu().numpy() for f, v in m._asdict().items()
           if f != "obs"}
    out.update({f"{prefix}/obs_{f}": v.cpu().numpy() for f, v in m.obs._asdict().items()})
    return out


# ---------------------------------------------------------------------------
# Suites: every case of one test file on one mesh -> {name: global array}
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def suite_scale_space(mesh, world: int) -> dict:
    import torch

    from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
    from sift_parallel_optimization_tpu_torch.core.pyramid_ref import gaussian_kernel_1d
    from sift_parallel_optimization_tpu_torch.parallel import halo
    from sift_parallel_optimization_tpu_torch.parallel import scale_space as ss
    from sift_parallel_optimization_tpu_torch.parallel.mesh import all_gather, axis_index, axis_size

    out = {}
    t = lambda a: torch.from_numpy(a)
    for o, d in enumerate(ss.sharded_reference_dog_pyramid(t(normal_image(64, 0)), 2, mesh)):
        out[f"row_pyr/{o}"] = _np(d.full_tensor())
    base = t(normal_image(32, 1))
    for S in (2, 5):
        out[f"scale_s{S}"] = _np(ss.scale_sharded_reference_dog_octave(mesh, S, 32)(base)
                                 .full_tensor())
    for o, d in enumerate(ss.octave_sharded_reference_dog_pyramid(t(normal_image(128, 2)), 2,
                                                                   mesh)):
        out[f"oct_pyr/{o}"] = _np(d.full_tensor())
    cfg = PyramidConfig(length=256, S=2, mode=ScaleSpaceMode.SIFT, max_octaves=3)
    pyr = ss.sharded_sift_gaussian_pyramid(t(unit_image(256, 3)), cfg, mesh)
    out["sift_placements"] = np.array([str(d.placements[1]) for d in pyr])
    for o, d in enumerate(pyr):
        out[f"sift_pyr/{o}"] = _np(d.full_tensor())

    # The shard_map bodies on this rank's rows, gathered here.
    n, i = axis_size(mesh, "spatial"), axis_index(mesh, "spatial")
    img = t(unit_image(64, 4, width=48))
    rows = img[i * (64 // n):(i + 1) * (64 // n)]
    out["sep_blur"] = _np(all_gather(ss.sharded_separable_blur(mesh)(rows, gaussian_kernel_1d(1.6)),
                                     mesh, "spatial"))
    bank = ss.sharded_blur_bank(mesh, 64, 48, [1.0, 2.5])(rows)          # (2, h, 48)
    out["blur_bank"] = _np(all_gather(bank.transpose(0, 1).contiguous(), mesh, "spatial")
                           .transpose(0, 1))
    ext = halo.exchange_rows(torch.arange(64 * 5, dtype=torch.float32).view(64, 5)[
        i * (64 // n):(i + 1) * (64 // n)], 3, mesh)
    out["halo"] = _np(all_gather(ext, mesh, "spatial"))
    return out


def suite_data(mesh, world: int) -> dict:
    """The data-axis paths: the sharded frontend, the ring table and
    close_loops with a mesh."""
    import torch

    from sift_parallel_optimization_tpu_torch.models import frontend as tfe
    from sift_parallel_optimization_tpu_torch.models import loop_closure as tlc
    from sift_parallel_optimization_tpu_torch.models import sfm as tsfm
    from sift_parallel_optimization_tpu_torch.models.geometry import Camera
    from sift_parallel_optimization_tpu_torch.parallel import frontend as tpf
    from sift_parallel_optimization_tpu_torch.parallel import matching as tpm

    out = {}
    feats = tpf.gather_features(tpf.batched_extract_features(
        torch.from_numpy(blob_frames(8, 64)), tfe.sift_config(64), 64, mesh=mesh), mesh)
    for f, v in feats.keypoints._asdict().items():
        out[f"frontend/{f}"] = _np(v)
    out["frontend/descriptors"] = _np(feats.descriptors)
    for F in (16, 13):
        desc, valid = fake_keyframes(F, F, 40)
        table = tpm.ring_pairwise_match_counts(mesh, torch.from_numpy(desc),
                                               torch.from_numpy(valid))
        out[f"ring/{F}"] = _np(table)
        out[f"pairs/{F}"] = _np(tpm.select_covisible_pairs(table, min_count=5, min_gap=2))
    arrays, frames, loops = loop_world()
    lm = tlc.close_loops(tsfm.sfm_map_from_numpy(arrays, "cpu"), 6, frames,
                         [Camera(torch.from_numpy(r), torch.from_numpy(tv)) for r, tv in loops],
                         64, mesh=mesh)
    for f in ("rvecs", "tvecs", "points"):
        out[f"close_loops/{f}"] = _np(getattr(lm, f))
    return out


def suite_ba(mesh, world: int) -> dict:
    import torch

    from sift_parallel_optimization_tpu_torch.models import ba as tba
    from sift_parallel_optimization_tpu_torch.models import pose_graph as tpg
    from sift_parallel_optimization_tpu_torch.parallel import ba as pba
    from sift_parallel_optimization_tpu_torch.parallel import pose_graph as ppg

    out = {}
    start, obs, k = ba_scene(5, 37, 0)
    st = tba.BAState(*map(torch.from_numpy, start))
    ob = tba.Observations(*map(torch.from_numpy, obs))
    for solver in ("dense", "cg"):
        got = pba.distributed_bundle_adjust(st, ob, torch.from_numpy(k), mesh, n_iters=6,
                                            damping=1e-4, solver=solver)
        for f, v in got._asdict().items():
            out[f"ba_{solver}/{f}"] = _np(v)
    edges, p0 = circle_graph(0)
    got = ppg.distributed_pgo(tpg.poses_from_numpy(p0, "cpu"),
                              tpg.pose_graph_edges_from_numpy(edges, "cpu"), mesh,
                              n_iters=25, damping=1e-4)
    out["pgo/rvecs"], out["pgo/tvecs"] = _np(got.rvecs), _np(got.tvecs)
    return out


def suite_dryrun(mesh, world: int) -> dict:
    """The dry run builds its own mesh over the world."""
    from sift_parallel_optimization_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(world, device="cpu")
    return {f"dryrun/{k}": np.asarray(v) for k, v in out.items()}


def suite_sfm(mesh, world: int) -> dict:
    """run_sfm with both meshes the (world, 1) mesh, all ranks on the data
    axis, and with no mesh in the same process (the same thread count, so
    the same BLAS sums)."""
    import torch

    from sift_parallel_optimization_tpu_torch.models import frontend as tfe
    from sift_parallel_optimization_tpu_torch.models import sfm as tsfm
    from sift_parallel_optimization_tpu_torch.parallel.mesh import make_mesh

    feats = [tfe.features_from_numpy(a, "cpu") for a in sfm_features()]
    K = torch.from_numpy(K_NP)
    mesh = make_mesh(world, 1)
    out = flat_map(tsfm.run_sfm(None, feats, K, pair_mesh=mesh, pgo_mesh=mesh, **SFM_KW), "sfm")
    return out | flat_map(tsfm.run_sfm(None, feats, K, **SFM_KW), "sfm_ref")


def names_only_slope(step, example, info=None, chain_lo=50, chain_hi=400, **kw):
    """``chained_slope_ms`` for record checks: runs the step once, times
    nothing (1.0), and reports the chain it was asked for."""
    float(step(example))
    if info is not None:
        info["chain"] = [chain_lo, chain_hi]
    return 1.0


def suite_mesh_sweep(mesh, world: int) -> dict:
    """``bench_matrix``'s mesh-shape sweep over the world (its records as
    JSON; the slopes are :func:`names_only_slope`)."""
    import json

    import torch

    from sift_parallel_optimization_tpu_torch.bench import suite

    records = []

    class Sink:
        def write(self, metric, value, unit, **extra):
            records.append({"metric": metric, "value": value, "unit": unit, **extra})

    saved, suite.chained_slope_ms = suite.chained_slope_ms, names_only_slope
    try:
        suite._mesh_sweep(suite._Records(Sink(), "cpu"), torch.from_numpy(unit_image(64, 5)), 64)
    finally:
        suite.chained_slope_ms = saved
    return {"mesh_sweep": np.array([json.dumps(r) for r in records])}


def suite_blur_precision(mesh, world: int) -> dict:
    """The sharded SIFT pyramid with its products at blur_precision="high"."""
    import torch

    from sift_parallel_optimization_tpu_torch.config import PyramidConfig, ScaleSpaceMode
    from sift_parallel_optimization_tpu_torch.parallel import scale_space as ss

    cfg = PyramidConfig(length=256, S=2, mode=ScaleSpaceMode.SIFT, max_octaves=3,
                        blur_precision="high")
    pyr = ss.sharded_sift_gaussian_pyramid(torch.from_numpy(unit_image(256, 3)), cfg, mesh)
    out = {"placements": np.array([str(d.placements[1]) for d in pyr])}
    out.update({f"sift_pyr/{o}": _np(d.full_tensor()) for o, d in enumerate(pyr)})
    return out


# suite -> (cases run on every mesh shape, cases run once a world).
SUITES = {"scale_space": ((suite_scale_space,), (suite_dryrun, suite_mesh_sweep)),
          "blur_precision": ((suite_blur_precision,), ()),
          "data": ((suite_data,), (suite_sfm,)),
          "ba": ((suite_ba,), ())}


def run_suite(name: str, world: int) -> dict:
    """Every case of suite ``name`` on every mesh shape of the world size,
    keyed "<n_data>x<n_spatial>/<case>", and its once-a-world cases keyed
    "world/<case>". Needs the default process group."""
    from sift_parallel_optimization_tpu_torch.parallel.mesh import make_mesh

    per_mesh, per_world = SUITES[name]
    out = {}
    for n_data, n_spatial in MESH_SHAPES[world]:
        mesh = make_mesh(n_data, n_spatial)
        for fn in per_mesh:
            out.update({f"{n_data}x{n_spatial}/{k}": v for k, v in fn(mesh, world).items()})
    for fn in per_world:
        out.update({f"world/{k}": v for k, v in fn(None, world).items()})
    return out


@contextlib.contextmanager
def one_thread():
    """One torch thread in this process for the block: the spawned ranks
    run beside it, one thread each, and more threads here only contend."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@contextlib.contextmanager
def world1():
    """A world-size-1 gloo group in this process (``HashStore``), destroyed
    after the block."""
    import torch.distributed as dist

    from sift_parallel_optimization_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(device="cpu", timeout_s=PG_TIMEOUT_S)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Spawning
# ---------------------------------------------------------------------------


def start(suite: str, worlds, tmp_path) -> tuple:
    """Start the ranks of ``suite`` for every world size in ``worlds``: one
    process imports torch and the port once and forks every rank of every
    world from there (before any torch op or thread), so the ranks skip the
    import. Returns the handle :func:`finish` takes."""
    tmp = str(tmp_path)
    outs = {n: os.path.join(tmp, f"{suite}_{n}.npz") for n in worlds}
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, tmp,
                             *map(str, worlds)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, process_group=0)
    return proc, outs, time.monotonic()


def finish(handle) -> dict:
    """Wait for every rank, at most :data:`JOIN_TIMEOUT_S` from the start;
    kill them all and raise if one runs past it or fails. Returns {world:
    rank 0's results}."""
    proc, outs, t0 = handle
    try:
        _so, se = proc.communicate(timeout=max(1.0, JOIN_TIMEOUT_S - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"ranks still running after {JOIN_TIMEOUT_S} s")
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)      # no rank outlives the test
    if proc.returncode != 0:
        raise RuntimeError(f"ranks failed (exit {proc.returncode}):\n{se[-4000:]}")
    res = {}
    for n, out in outs.items():
        with np.load(out) as f:
            res[n] = dict(f)
    return res


def _rank(suite: str, world: int, rank: int, store: str, out: str) -> int:
    import torch
    import torch.distributed as dist

    from sift_parallel_optimization_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(num_processes=world, process_id=rank, device="cpu",
                           store=dist.FileStore(store, world), timeout_s=PG_TIMEOUT_S)
    res = run_suite(suite, world)
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "a rank imported JAX"
    return 0


def _main(argv) -> int:
    """Import once, fork every rank of every world, wait for them all."""
    suite, tmp, worlds = argv[0], argv[1], [int(n) for n in argv[2:]]
    import torch  # noqa: F401 - imported before the forks, used after
    import torch.distributed  # noqa: F401

    import sift_parallel_optimization_tpu_torch.parallel  # noqa: F401
    import sift_parallel_optimization_tpu_torch.parallel.dryrun  # noqa: F401

    pids = []
    for n in worlds:
        for rank in range(n):
            pid = os.fork()
            if pid == 0:
                code = 1
                try:
                    code = _rank(suite, n, rank, os.path.join(tmp, f"store_{suite}_{n}"),
                                 os.path.join(tmp, f"{suite}_{n}.npz"))
                except BaseException:
                    import traceback

                    traceback.print_exc()
                finally:
                    sys.stdout.flush()
                    sys.stderr.flush()
                    os._exit(code)
            pids.append((n, rank, pid))
    failed = []
    for n, rank, pid in pids:
        _pid, status = os.waitpid(pid, 0)
        if os.waitstatus_to_exitcode(status) != 0:
            failed.append(f"world {n} rank {rank}: exit {os.waitstatus_to_exitcode(status)}")
    if failed:
        print("; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    raise SystemExit(_main(sys.argv[1:]))
