"""The port's ``parallel/`` against the JAX package: sharded and windowed
Schur BA, window splitting, feature-sharded tracking and meshes (CPU).

JAX runs on its 8-virtual-device CPU mesh (``tests/conftest.py``); the port
runs the same shard layouts in process, every shard on the CPU. The solvers
compare in f64 to 1e-8 with equal iteration counts: the in-process sum over
shards adds the partials in shard order, so sharded results are not
bit-equal to unsharded ones. The sharded LK has no reduction and is.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as ndshift

from _torch_clip import FEATURES, TRIALS, _frame_draws, _inject

from velocity_tpu.config import BAConfig as JaxBAConfig
from velocity_tpu.config import LKConfig as JaxLKConfig
from velocity_tpu.config import SolverConfig as JaxSolverConfig
from velocity_tpu.config import TrackerConfig as JaxTrackerConfig
from velocity_tpu.geometry.projection import Intrinsics as JaxIntrinsics
from velocity_tpu.parallel import ba_schur_sharded as jax_ba_schur_sharded
from velocity_tpu.parallel import make_mesh as jax_make_mesh
from velocity_tpu.parallel import windowed_ba as jax_windowed_ba
from velocity_tpu.parallel.track_shard import lk_forward_backward_sharded as jax_fb_sharded
from velocity_tpu.pipeline.tracker import frame_pyramids_jit as jax_frame_pyramids
from velocity_tpu.pipeline.tracker import fused_frame_step_pyr as jax_fused_step
from velocity_tpu.solvers.ba import BAProblem as JaxBAProblem
from velocity_tpu_torch.config import BAConfig, LKConfig, SolverConfig, TrackerConfig
from velocity_tpu_torch.geometry.projection import Intrinsics
from velocity_tpu_torch.ops.lk_lanes import lk_forward_backward_lanes
from velocity_tpu_torch.parallel import (
    ba_schur_sharded, device_counts, make_mesh, split_windows, stitch_windows, windowed_ba)
from velocity_tpu_torch.parallel.mesh import InProcess
from velocity_tpu_torch.parallel.track_shard import lk_forward_backward_sharded
from velocity_tpu_torch.pipeline.tracker import frame_pyramids, fused_frame_step_pyr
from velocity_tpu_torch.solvers.ba import BAProblem
from velocity_tpu_torch.solvers.schur import ba_schur

torch.set_num_threads(1)

FX, CX, CY = 1993.89, 960.5, 540.5
CPU = torch.device("cpu")


def _mesh(**sizes):
    return make_mesh(sizes, devices=[CPU] * int(np.prod(list(sizes.values()))))


def _project_np(pc):
    return np.stack([FX * pc[..., 0] / pc[..., 2] + CX, FX * pc[..., 1] / pc[..., 2] + CY],
                    axis=-1)


def _scene(nc=6, nt=40, noise_px=0.3, seed=0, perturb=1.0):
    """(pixels, mask, points0, cams0) of the scene of ``tests/test_ba.py``:
    small rotations, noisy pixels, structure and cameras perturbed (by
    ``perturb`` times 5 cm, 3 cm and 5 mrad)."""
    from velocity_tpu_torch.geometry.rotations import rpy_to_matrix

    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-2, 2, (nt, 2)), rng.uniform(6, 10, (nt, 1))], axis=1)
    pos = np.stack([np.linspace(0, 1.8, nc), np.linspace(0, 0.15, nc),
                    np.linspace(0, 0.35, nc)], axis=1)
    rpy = np.zeros((nc, 3))
    rpy[1:] = rng.uniform(-0.02, 0.02, (nc - 1, 3))
    pix = np.stack([_project_np(pts @ rpy_to_matrix(torch.as_tensor(rpy[c])).numpy() + pos[c])
                    for c in range(nc)])
    pix += rng.normal(0, noise_px, pix.shape)
    rng = np.random.default_rng(seed + 1)
    cams0 = np.concatenate([pos, rpy], axis=1)
    cams0[0] = 0
    cams0[1:, 0:3] += perturb * rng.normal(0, 0.03, (nc - 1, 3))
    cams0[1:, 3:6] += perturb * rng.normal(0, 0.005, (nc - 1, 3))
    return pix, np.ones((nc, nt), bool), pts + perturb * rng.normal(0, 0.05, pts.shape), cams0


def _pad(arrays, nt_pad):
    """Pad the track capacity with masked lanes at benign dummy geometry."""
    pix, mask, pts0, cams0 = arrays
    extra = nt_pad - pts0.shape[0]
    return (np.concatenate([pix, np.zeros((pix.shape[0], extra, 2))], axis=1),
            np.concatenate([mask, np.zeros((mask.shape[0], extra), bool)], axis=1),
            np.concatenate([pts0, np.tile([[0.0, 0.0, 8.0]], (extra, 1))]), cams0)


def _intr():
    return Intrinsics(*(torch.tensor(v, dtype=torch.float64) for v in (FX, FX, CX, CY, 0.0)))


def _jintr():
    return JaxIntrinsics(*(jnp.float64(v) for v in (FX, FX, CX, CY, 0.0)))


def _problem(arrays):
    pix, mask, pts0, cams0 = arrays
    return BAProblem(_intr(), torch.as_tensor(pix), torch.as_tensor(mask),
                     torch.as_tensor(pts0), torch.as_tensor(cams0))


def _jproblem(arrays):
    pix, mask, pts0, cams0 = arrays
    return JaxBAProblem(_jintr(), jnp.asarray(pix), jnp.asarray(mask), jnp.asarray(pts0),
                        jnp.asarray(cams0))


# ------------------------------------------------------------------- meshes


def test_make_mesh_rules():
    """JAX's rules: a default 'point' axis over every CUDA device, -1 for the
    rest at most once, the too-few-devices error; an explicit device list
    may repeat one device. Without a CUDA device and without ``devices``,
    make_mesh raises: it never builds a CPU mesh by itself."""
    if torch.cuda.is_available():
        assert device_counts() == torch.cuda.device_count()
        default = make_mesh()
        assert default.shape == {"point": device_counts()}
        with pytest.raises(ValueError, match=f"needs {device_counts() + 1} devices"):
            make_mesh({"point": device_counts() + 1})
    else:
        assert device_counts() == 0
        for sizes in (None, {"point": 1}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_mesh(sizes)
    m = make_mesh({"window": 2, "point": -1}, devices=[CPU] * 8)
    assert m.shape == {"window": 2, "point": 4}
    assert m.devices.shape == (2, 4) and m.device(window=1, point=3) == CPU
    assert make_mesh({"feature": 3}, devices=[CPU] * 8).shape == {"feature": 3}
    with pytest.raises(ValueError, match="at most one -1"):
        make_mesh({"a": -1, "b": -1}, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        make_mesh({"point": 8}, devices=[CPU])
    # the same rules as JAX's make_mesh on its 8 CPU devices
    assert dict(jax_make_mesh({"window": 2, "point": -1}).shape) == m.shape


def test_in_process_collective():
    """The in-process back end sums per-shard tuples in shard order and
    gathers shards by concatenation."""
    comm = InProcess(3)
    assert list(comm.indices) == [0, 1, 2]
    parts = [(torch.tensor([1.0, 2.0]), torch.tensor(10.0 * s)) for s in range(3)]
    a, b = comm.all_reduce_sum(parts)
    assert a.tolist() == [3.0, 6.0] and float(b) == 30.0
    g = comm.gather([torch.full((2, 3), float(s)) for s in range(3)], dim=0)
    assert g.shape == (6, 3) and g[:, 0].tolist() == [0, 0, 1, 1, 2, 2]


# ------------------------------------------------------------ sharded BA


@pytest.fixture(scope="module")
def sharded_case():
    """The 40-track scene padded to 48 lanes; JAX's ba_schur_sharded on its
    8-device mesh."""
    arrays = _pad(_scene(), 48)
    cfg = JaxBAConfig(max_iters=8)
    want = jax_ba_schur_sharded(_jproblem(arrays), jax_make_mesh({"point": 8}), "point", cfg)
    return arrays, want


@pytest.mark.parametrize("shards", [8, 1])
def test_sharded_ba_matches_single_device_and_jax(sharded_case, shards):
    """ba_schur_sharded over 8 (and 1) in-process shards: equal to ba_schur
    and to JAX's sharded solve to 1e-8 (f64), with equal iteration counts."""
    arrays, want = sharded_case
    prob = _problem(arrays)
    cfg = BAConfig(max_iters=8)
    single = ba_schur(prob, cfg)
    got = ba_schur_sharded(prob, _mesh(point=shards), "point", cfg)
    assert got.iterations == single.iterations == int(want.iterations)
    for g, s, w in ((got.points, single.points, want.points), (got.cams, single.cams, want.cams)):
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=0, atol=1e-8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(got.residual_rms), float(want.residual_rms), rtol=1e-8)


def test_sharded_ba_masked_padding_inert():
    """Masked padding lanes do not move the real tracks: 40 tracks padded
    to 64 and sharded 8 ways equal the unpadded single-device solve."""
    arrays = _scene(noise_px=0.2)
    base = ba_schur(_problem(arrays), BAConfig(max_iters=8))
    got = ba_schur_sharded(_problem(_pad(arrays, 64)), _mesh(point=8), "point",
                           BAConfig(max_iters=8))
    np.testing.assert_allclose(got.points.numpy()[:40], base.points.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.points.numpy()[40:], np.tile([[0.0, 0.0, 8.0]], (24, 1)))
    with pytest.raises(ValueError, match="not divisible"):
        ba_schur_sharded(_problem(arrays), _mesh(point=3), "point")


# ------------------------------------------------------------ windowed BA


def _chain_windows(nw=2, nc=5, nt=32, seed=4):
    """Windows of a straight chain, each in its first camera's frame (the
    case of ``tests/test_parallel.py``): pixels noiseless."""
    rng = np.random.default_rng(seed)
    pix = np.zeros((nw, nc, nt, 2))
    pts_all, cams_all = [], []
    base = np.zeros(3)
    step = np.array([0.35, 0.01, 0.06])
    for w in range(nw):
        pts = np.concatenate([rng.uniform(-2, 2, (nt, 2)), rng.uniform(6, 10, (nt, 1))],
                             axis=1) - base
        pos = np.arange(nc)[:, None] * step
        for c in range(nc):
            pix[w, c] = _project_np(pts + pos[c])
        pts_all.append(pts + rng.normal(0, 0.02, pts.shape))
        cams0 = np.concatenate([pos, np.zeros((nc, 3))], axis=1)
        cams0[1:, 0:3] += rng.normal(0, 0.01, (nc - 1, 3))
        cams_all.append(cams0)
        base = base + step * (nc - 1)
    return (pix, np.ones((nw, nc, nt), bool), np.stack(pts_all), np.stack(cams_all)), step


def _windowed(arrays, mesh, cfg, **kw):
    pix, mask, pts0, cams0 = arrays
    return windowed_ba(torch.as_tensor(pix), torch.as_tensor(mask), torch.as_tensor(pts0),
                       torch.as_tensor(cams0), _intr(), mesh, config=cfg, **kw)


def _jax_windowed(arrays, mesh_sizes, cfg, **kw):
    pix, mask, pts0, cams0 = arrays
    return jax_windowed_ba(jnp.asarray(pix), jnp.asarray(mask), jnp.asarray(pts0),
                           jnp.asarray(cams0), _jintr(), jax_make_mesh(mesh_sizes),
                           config=cfg, **kw)


def _assert_windows_match(got, want):
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_windowed_ba_and_stitching():
    """2 windows x (4 x point) mesh: per-window BA equal to JAX's on its
    2 x 4 device mesh (cameras, points and iterations, f64 to 1e-8); each
    window recovers its local trajectory and the chain stitch the global
    one (the tolerances of ``tests/test_parallel.py``)."""
    arrays, step = _chain_windows()
    nw, nc = 2, 5
    want = _jax_windowed(arrays, {"window": 2, "point": 4},
                         JaxBAConfig(max_iters=30, tol=1e-12))
    got = _windowed(arrays, _mesh(window=2, point=4), BAConfig(max_iters=30, tol=1e-12))
    _assert_windows_match(got, want)
    cams = got[1].numpy()
    for w in range(nw):
        np.testing.assert_allclose(cams[w, :, 0:3], np.arange(nc)[:, None] * step, atol=4e-3)
    glob = stitch_windows(cams[:, :, 0:3], overlap=1)
    np.testing.assert_allclose(glob, np.arange(nw * nc - 1)[:, None] * step, atol=8e-3)


@pytest.fixture(scope="module")
def pinned_case():
    """Two windows that stop at different iterations (a noiseless window
    near its optimum and a noisy, strongly perturbed one), 48 tracks, with
    fix_rotations and pin_tracks=4; JAX's windowed_ba on a 2 x 4 mesh."""
    quiet = _pad(_scene(noise_px=0.0, seed=3, perturb=1e-3), 48)
    noisy = _pad(_scene(noise_px=0.5, seed=7, perturb=3.0), 48)
    arrays = tuple(np.stack([a, b]) for a, b in zip(quiet, noisy))
    kw = dict(fix_rotations=True, pin_tracks=4)
    want = _jax_windowed(arrays, {"window": 2, "point": 4}, JaxBAConfig(max_iters=20), **kw)
    return arrays, kw, want


@pytest.mark.parametrize("layout", [dict(window=1, point=1), dict(window=2, point=4),
                                    dict(window=1, point=8), dict(window=2, point=1)])
def test_windowed_ba_pinned_windows_stop_apart(pinned_case, layout):
    """fix_rotations and pin_tracks=4 over every shard layout: cameras,
    points and per-window iterations equal to JAX's (f64, 1e-8); the two
    windows stop at different iterations, the pinned lanes never move and
    the rotations stay put."""
    arrays, kw, want = pinned_case
    got = _windowed(arrays, _mesh(**layout), BAConfig(max_iters=20), **kw)
    _assert_windows_match(got, want)
    iters = got[2].tolist()
    assert iters[0] != iters[1] and max(iters) < 20, iters
    np.testing.assert_array_equal(got[0].numpy()[:, :4], arrays[2][:, :4])
    np.testing.assert_array_equal(got[1].numpy()[:, :, 3:6], arrays[3][:, :, 3:6])


def test_windowed_ba_frozen_window_is_its_own_solve(pinned_case):
    """A window that stopped keeps its result: each window of the batch
    equals that window solved alone (the batch of one)."""
    arrays, kw, _ = pinned_case
    both = _windowed(arrays, _mesh(window=1, point=1), BAConfig(max_iters=20), **kw)
    for w in range(2):
        alone = _windowed(tuple(a[w : w + 1] for a in arrays), _mesh(window=1, point=1),
                          BAConfig(max_iters=20), **kw)
        assert alone[2].tolist() == [both[2].tolist()[w]]
        for a, b in zip(alone[:2], both[:2]):
            np.testing.assert_allclose(a.numpy()[0], b.numpy()[w], rtol=0, atol=1e-12)


def test_split_windows():
    assert split_windows(10, 4, 1) == [(0, 4), (3, 7), (6, 10)]
    assert split_windows(7, 4, 1) == [(0, 4), (3, 7)]
    assert split_windows(4, 4, 1) == [(0, 4)]
    with pytest.raises(ValueError, match="exceed"):
        split_windows(10, 3, 3)


# ------------------------------------------------------- sharded tracking


@pytest.fixture(scope="module")
def lk_pair():
    """The images of ``tests/test_parallel.py``: a smooth random texture and
    its subpixel shift; 64 points."""
    rng = np.random.default_rng(3)
    base = gaussian_filter(rng.random((300, 420)).astype(np.float32) * 255, 2)
    shifted = ndshift(base, (1.3, -2.1), order=3).astype(np.float32)
    pts = np.stack([rng.uniform(40, 380, 64), rng.uniform(40, 260, 64)], 1).astype(np.float32)
    return base, shifted, pts


def test_sharded_lk_bit_equal_and_matches_jax(lk_pair):
    """8 in-process shards are the single call bit for bit; against JAX's
    sharded call on its 8 devices, status equal and points within 1e-5 px
    (JAX's own sharded-vs-single tolerance)."""
    a, b, pts = lk_pair
    kw = dict(fb_threshold=1.0, win=15, max_level=2, iters=10, eps=0.01)
    ta, tb, tp = (torch.as_tensor(x) for x in (a, b, pts))
    single = lk_forward_backward_lanes(ta, tb, tp, **kw)
    got = lk_forward_backward_sharded(ta, tb, tp, _mesh(feature=8), "feature", **kw)
    assert torch.equal(got.points, single.points) and torch.equal(got.status, single.status)
    want = jax_fb_sharded(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts),
                          jax_make_mesh({"feature": 8}), "feature", **kw)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        lk_forward_backward_sharded(ta, tb, tp, _mesh(feature=3), "feature", **kw)


def test_sharded_lk_warped_with_guess_bit_equal(lk_pair):
    """The stage-3 form (a destination warp) and the stage-2 form (a
    guess) are bit-equal to the single call too."""
    a, b, pts = lk_pair
    ta, tb, tp = (torch.as_tensor(x) for x in (a, b, pts))
    M = torch.tensor([[1.0, 0.002, -2.0], [0.001, 1.0, 1.2]])
    for kw in (dict(fb_threshold=0.3, warp_dst=M, win=31, max_level=0, iters=15, eps=0.01),
               dict(fb_threshold=1.0, guess=tp + torch.tensor([-2.0, 1.0]), win=15,
                    max_level=2, iters=10, eps=0.1)):
        single = lk_forward_backward_lanes(ta, tb, tp, **kw)
        got = lk_forward_backward_sharded(ta, tb, tp, _mesh(feature=4), "feature", **kw)
        assert torch.equal(got.points, single.points)
        assert torch.equal(got.status, single.status)


def _step_inputs():
    """The frame step of ``tests/test_parallel.py::TestShardedTrackerProduct``."""
    rng = np.random.default_rng(5)
    base = gaussian_filter(rng.random((240, 320)).astype(np.float32) * 255, 2)
    im1 = ndshift(base, (0.9, -1.4), order=3).astype(np.float32)
    N = 128
    pts = np.zeros((N, 2), np.float32)
    pts[:, 0] = rng.uniform(60, 260, N)
    pts[:, 1] = rng.uniform(60, 180, N)
    p3 = np.concatenate([rng.uniform(-1, 1, (N, 2)), rng.uniform(6, 9, (N, 1))],
                        1).astype(np.float32)
    return base, im1, pts, np.ones(N, bool), p3


def test_fused_step_sharded_matches_unsharded_and_jax():
    """The frame step with shard_features=8 routes stages 2 and 3 through
    the sharded forward-backward: bit-equal to the unsharded step on the
    same RANSAC noise, and against JAX's sharded step on JAX's noise,
    validity equal, translation within 1e-4 and points within 1e-4 px plus
    1e-6 relative (JAX's own sharded-vs-single tolerances, plus 8 f32 ulps
    of the coordinate: the port's stencil pyramids and JAX's matmul ones
    sum in another order, and one point of 128 at 257 px lands 4 ulps,
    1.2e-4 px, away)."""
    im0, im1, pts, vg, p3 = _step_inputs()
    N = pts.shape[0]
    assert (N, 64) == (FEATURES, TRIALS)  # the shape of _frame_draws
    key = jax.random.PRNGKey(0)
    base = dict(max_features=N, ransac_trials=TRIALS)
    jcfg = JaxTrackerConfig(lk_coarse=JaxLKConfig(15, 2, 10, 0.1),
                            lk_fine=JaxLKConfig(31, 0, 15, 0.01), **base)
    jcfg = dataclasses.replace(jcfg, shard_features=8)
    jintr = JaxIntrinsics(*(jnp.float32(v) for v in (500.0, 500.0, 160.0, 120.0, 0.0)))
    pyr0, spyr0 = jax_frame_pyramids(jnp.asarray(im0), jcfg)
    out = jax_fused_step(pyr0, spyr0, jnp.asarray(im1), jnp.asarray(pts), jnp.asarray(vg),
                         jnp.asarray(vg), jnp.asarray(p3), jintr, key, jcfg,
                         JaxSolverConfig(dtype="float32"), jnp.float32, None)
    want = [np.asarray(out[k]) for k in (2, 3, 5)]

    intr = Intrinsics(*(torch.tensor(v) for v in (500.0, 500.0, 160.0, 120.0, 0.0)))
    cfg = TrackerConfig(lk_coarse=LKConfig(15, 2, 10, 0.1), lk_fine=LKConfig(31, 0, 15, 0.01),
                        **base)

    def run(c):
        with pytest.MonkeyPatch.context() as mp:
            draws = _frame_draws(key)  # JAX's noise of this step
            _inject(mp, draws)
            pyr, spyr = frame_pyramids(torch.as_tensor(im0), c)
            o = fused_frame_step_pyr(pyr, spyr, torch.as_tensor(im1), torch.as_tensor(pts),
                                     torch.as_tensor(vg), torch.as_tensor(vg),
                                     torch.as_tensor(p3), intr, None, c,
                                     SolverConfig(dtype="float32"), torch.float32, None)
            assert not draws
        return [o[k] for k in (2, 3, 5)]

    single = run(cfg)
    got = run(dataclasses.replace(cfg, shard_features=8))
    for g, s in zip(got, single):
        assert torch.equal(g, s)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-4)



# ------------------------------------------------------- entry-point twin


def test_entry_runs_the_fused_step():
    """``graft_entry_torch.entry(device="cpu")``: its ``fn(*args)`` is
    ``pipeline.tracker.fused_frame_step`` at ``TrackerConfig()`` (1024
    lanes) with the f32 solver, bit for bit against the function called
    directly on the same inputs and an equally seeded generator."""
    import graft_entry_torch
    from velocity_tpu_torch.pipeline.tracker import fused_frame_step

    fn, args = graft_entry_torch.entry(device="cpu")
    assert all(a.device == CPU for a in args[:7]) and args[3].shape == (1024, 2)
    got = fn(*args)
    gen = torch.Generator()
    gen.manual_seed(0)
    want = fused_frame_step(*args[:8], gen, TrackerConfig(), SolverConfig(dtype="float32"),
                            torch.float32)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) > 512 and torch.isfinite(got[4]).all()


# dryrun_multichip's f32 problem on a 2 x 2 mesh against 1 x 1: the point
# shards' partial sums of 512 tracks are added in another order, and three
# Gauss-Newton steps of a BA with a free scale gauge amplify that rounding
# (on this CPU at one thread: cameras 1.04e-5, points 2.1e-6 relative)
DRYRUN_RTOL = 1e-4


def test_dryrun_multichip_matches_one_shard():
    """``dryrun_multichip(4, device="cpu")``: window 2 x point 2 in process,
    within DRYRUN_RTOL (max |a - b| / max |b|) of the same windowed BA step
    on a 1 x 1 mesh, with equal iterations."""
    import graft_entry_torch

    points, cams, iters = graft_entry_torch.dryrun_multichip(4, device="cpu")
    mesh, args = graft_entry_torch.multichip_problem(4, device="cpu")
    assert mesh.shape == {"window": 2, "point": 2} and args[0].shape == (2, 8, 1024, 2)
    ref = windowed_ba(*args, _mesh(window=1, point=1), config=BAConfig(max_iters=3))
    for got, want in ((points, ref[0]), (cams, ref[1])):
        assert float((got - want).abs().max() / want.abs().max()) <= DRYRUN_RTOL
    assert torch.equal(iters, ref[2])
    assert graft_entry_torch.multichip_problem(3, device="cpu")[0].shape == {"window": 1,
                                                                            "point": 3}


def test_entry_points_do_not_run_on_the_cpu_unasked():
    import graft_entry_torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry_torch.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry_torch.dryrun_multichip(4)
