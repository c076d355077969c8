"""The port's data-axis paths on gloo ranks: the mesh frontend
(``parallel/frontend.batched_extract_features(mesh=)`` and
``gather_features``), the ring match table and the covisible-pair mask
(``parallel/matching``), ``run_sfm(pair_mesh=, pgo_mesh=)`` and
``close_loops(mesh=)``, against the JAX package on the virtual 8-device
CPU mesh and the port's unsharded paths.

The port runs at world sizes 4 (1x4, 2x2, 4x1), 2 (1x2, 2x1), spawned once
for the module (``tests/torch_dist_workers.py``), and 1 (1x1) in this
process. The JAX package's sharded functions run on its 4x1 mesh (the data
axis of four devices; the result does not depend on the mesh, which the JAX
package's own tests hold). Sizes are the JAX tests': 8 frames of 64^2 at
K=64, F=16 and F=13 keyframes of K=40.

Tolerances:

* Frontend: the keypoint SETS of every frame equal the JAX batched
  frontend's and the port's unsharded one's (valid slots equal, positions
  and scales within COORD_ATOL, the port's batched-frontend tolerance), and
  descriptors within DESC_ATOL where the orientation agrees.
* Ring table and covisible-pair mask: exactly equal to the single-device
  table in both packages.
* run_sfm with both meshes: the same cameras, landmarks and observations
  as mesh=None under the same injected draws, in the same rank; rotations
  within the PGO tolerance (1e-4 rad), translations, points and their
  descriptors within 1e-3 of their largest magnitude. The edge shards
  reorder the loop-closure PGO's sums (~1e-6), and the final BA carries
  that on into the scale about camera 0, which monocular BA leaves free
  (seen: 1e-4 of the largest translation at 4 ranks).
* close_loops(mesh=): poses within the PGO tolerance of
  tests/test_torch_pose_graph.py (1e-4) of the JAX package's and of the
  unsharded run, points within that times the scene's depth (12).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from sift_parallel_optimization_tpu.models import ba as jba
from sift_parallel_optimization_tpu.models import frontend as jfe
from sift_parallel_optimization_tpu.models import loop_closure as jlc
from sift_parallel_optimization_tpu.models import sfm as jsfm
from sift_parallel_optimization_tpu.models.geometry import Camera as JCamera
from sift_parallel_optimization_tpu.parallel import frontend as jpf
from sift_parallel_optimization_tpu.parallel import matching as jpm
from sift_parallel_optimization_tpu.parallel import mesh as jmesh
from sift_parallel_optimization_tpu_torch.models import frontend as tfe
from sift_parallel_optimization_tpu_torch.models import loop_closure as tlc
from sift_parallel_optimization_tpu_torch.models import sfm as tsfm
from sift_parallel_optimization_tpu_torch.models.geometry import Camera
from sift_parallel_optimization_tpu_torch.models.keypoints import Keypoints
from sift_parallel_optimization_tpu_torch.parallel import frontend as tpf
from sift_parallel_optimization_tpu_torch.parallel import matching as tpm

SHAPES = [(n, shape) for n in (1, 2, 4) for shape in W.MESH_SHAPES[n]]
IDS = [f"w{n}-{a}x{b}" for n, (a, b) in SHAPES]
COORD_ATOL, ORI_ATOL, DESC_ATOL = 1e-3, 1e-3, 5e-3
PGO_ATOL, DEPTH = 1e-4, 12.0
SCALE_RTOL = 1e-3


def _jax_mesh():
    return jmesh.make_mesh(4, 1, devices=jax.devices()[:4])


def _jax_frontend():
    feats = jax.jit(lambda x: jpf.batched_extract_features(x, jfe.sift_config(64), 64,
                                                           mesh=_jax_mesh()))(
        jnp.asarray(W.blob_frames(8, 64)))
    out = {f"frontend/{f}": np.asarray(getattr(feats.keypoints, f)) for f in Keypoints._fields}
    out["frontend/descriptors"] = np.asarray(feats.descriptors)
    return out


def _jax_ring():
    out = {}
    for F in (16, 13):
        desc, valid = W.fake_keyframes(F, F, 40)
        table = jax.jit(lambda d, v: jpm.ring_pairwise_match_counts(_jax_mesh(), d, v))(
            desc, valid)
        out[f"ring/{F}"] = np.asarray(table)
        out[f"pairs/{F}"] = np.asarray(jpm.select_covisible_pairs(table, 5, 2))
    return out


def _jax_close_loops():
    arrays, frames, loops = W.loop_world()
    jmap = jsfm.SfmMap(**{k: jnp.asarray(v) for k, v in arrays.items() if k != "obs"},
                       obs=jba.Observations(**{k: jnp.asarray(v)
                                               for k, v in arrays["obs"].items()}))
    cams = [JCamera(jnp.asarray(r), jnp.asarray(t)) for r, t in loops]
    got = jax.jit(lambda m, c: jlc.close_loops(m, 6, frames, c, 64, mesh=_jax_mesh()))(jmap, cams)
    return {f"close_loops/{f}": np.asarray(getattr(got, f)) for f in ("rvecs", "tvecs", "points")}


def _unsharded():
    out = {}
    feats = tpf.batched_extract_features(torch.from_numpy(W.blob_frames(8, 64)),
                                         tfe.sift_config(64), 64)
    out.update({f"frontend/{f}": v.numpy() for f, v in feats.keypoints._asdict().items()})
    out["frontend/descriptors"] = feats.descriptors.numpy()
    for F in (16, 13):
        desc, valid = W.fake_keyframes(F, F, 40)
        out[f"ring/{F}"] = tpm.pairwise_match_counts(torch.from_numpy(desc),
                                                     torch.from_numpy(valid)).numpy()
    arrays, frames, loops = W.loop_world()
    got = tlc.close_loops(tsfm.sfm_map_from_numpy(arrays, "cpu"), 6, frames,
                          [Camera(torch.from_numpy(r), torch.from_numpy(t)) for r, t in loops],
                          64)
    out.update({f"close_loops/{f}": getattr(got, f).numpy() for f in ("rvecs", "tvecs", "points")})
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port {world: {key: array}}, JAX {key: array}, unsharded {key:
    array}); worlds 2 and 4 spawned while this process runs the rest (the
    JAX runs in threads: XLA compiles outside the GIL)."""
    tmp = tmp_path_factory.mktemp("ranks")
    handle = W.start("data", (2, 4), tmp)
    try:
        with ThreadPoolExecutor(3) as pool, W.one_thread():
            jax_runs = [pool.submit(f) for f in (_jax_frontend, _jax_ring, _jax_close_loops)]
            with W.world1():
                port = {1: W.run_suite("data", 1)}
            flat = _unsharded()
            jax_out = {k: v for run in jax_runs for k, v in run.result().items()}
    finally:
        port.update(W.finish(handle))
    return port, jax_out, flat


def _get(results, n, shape, key):
    return results[0][n][f"{shape[0]}x{shape[1]}/{key}"]


def _frontend_close(get, want):
    """Per frame: the same valid slots, keypoints and (where the orientation
    agrees) descriptors."""
    valid = want("valid")
    assert valid.sum() > 8 * 5
    np.testing.assert_array_equal(get("valid"), valid)
    for f in ("x", "y", "sigma", "octave", "scale"):
        np.testing.assert_allclose(get(f)[valid], want(f)[valid], rtol=1e-4, atol=COORD_ATOL,
                                   err_msg=f)
    dori = np.abs(get("orientation") - want("orientation"))
    close = np.minimum(dori, 2 * np.pi - dori) < ORI_ATOL
    assert close[valid].mean() >= 0.90
    ddesc = np.abs(get("descriptors") - want("descriptors")).max(-1)
    assert (ddesc[close & valid] < DESC_ATOL).all()


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
def test_mesh_frontend_matches_jax_and_unsharded(results, n, shape):
    get = lambda f: _get(results, n, shape, f"frontend/{f}")
    assert get("descriptors").shape == (8, 64, 128)
    _frontend_close(get, lambda f: results[1][f"frontend/{f}"])
    _frontend_close(get, lambda f: results[2][f"frontend/{f}"])


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("F", [16, 13])      # a multiple of every axis size, and padded
def test_ring_table_and_pairs_equal_single_device(results, n, shape, F):
    got = _get(results, n, shape, f"ring/{F}")
    np.testing.assert_array_equal(got, results[1][f"ring/{F}"])
    np.testing.assert_array_equal(got, results[2][f"ring/{F}"])
    assert (np.diag(got, 1) > 5).all()
    pairs = _get(results, n, shape, f"pairs/{F}")
    np.testing.assert_array_equal(pairs, results[1][f"pairs/{F}"])
    ii, jj = np.nonzero(pairs)
    assert len(ii) > 0 and (jj - ii >= 2).all() and (got[ii, jj] >= 5).all()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_run_sfm_with_meshes_equals_unsharded(results, n):
    """With the (n, 1) mesh, every rank on the data axis, against
    run_sfm(mesh=None) in the same rank (the same thread count: the same
    BLAS sums)."""
    ref = {k.split("/", 2)[2]: v for k, v in results[0][n].items()
           if k.startswith("world/sfm_ref/")}
    assert len(ref) == 10
    for key, want in ref.items():
        got = results[0][n][f"world/sfm/{key}"]
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            atol = PGO_ATOL if key == "rvecs" else SCALE_RTOL * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=key)
    # The run closed loops, so the PGO really went through the mesh.
    loops = results[0][n]["world/sfm/obs_valid"][3 * W.SFM_FRAMES * W.SFM_B:]
    assert loops.reshape(-1, W.SFM_B).any(-1).sum() >= 1


@pytest.mark.parametrize("n, shape", SHAPES, ids=IDS)
def test_close_loops_with_mesh_matches_jax_and_unsharded(results, n, shape):
    for want in (results[1], results[2]):
        for f, atol in (("rvecs", PGO_ATOL), ("tvecs", PGO_ATOL), ("points", PGO_ATOL * DEPTH)):
            np.testing.assert_allclose(_get(results, n, shape, f"close_loops/{f}"),
                                       want[f"close_loops/{f}"], rtol=0, atol=atol, err_msg=f)


def test_mesh_arguments_are_checked():
    """A mesh that is no (data, spatial) DeviceMesh is refused before any
    work; frames that do not split over the data axis too."""
    feats = [tfe.features_from_numpy(a, "cpu") for a in W.sfm_features()[:2]]
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsfm.run_sfm(None, feats, torch.from_numpy(W.K_NP), pair_mesh=object())
    with W.world1():
        from sift_parallel_optimization_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(1, 1)
        out = tpf.batched_extract_features(torch.from_numpy(W.blob_frames(2, 64)),
                                           tfe.sift_config(64), 16, mesh=mesh)
        assert out.descriptors.shape == (2, 16, 128)
        assert tpf.gather_features(out, mesh).keypoints.valid.dtype == torch.bool
