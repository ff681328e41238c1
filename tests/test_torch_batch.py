"""The lanes form of the port's frame step, which ``run_batch`` runs as one
batched segment per device, on the CPU: each piece with a lane axis against
the same piece called lane by lane, bit for bit (K2's plain version on an
image stack, the pyramids, the lanes LK engine, RANSAC with one generator
per lane, the LM with lanes that stop at different iterations, the pose
solve, the frame step and ``scan_segment``), and the whole step on two
lanes against JAX's vmap of its step, as ``_batched_segment`` builds it.

Lanes: the small clip of ``tests/_torch_clip.py`` (seed 0, 40 km/h) and
seed 1 at 35 km/h, as in ``test_torch_multivideo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_clip import (HEIGHT, N_FRAMES, SCALE, WIDTH, _cfg, _frame_draws, _inject_lanes,
                         _jax_info, _jcfg, make_clip)

from velocity_tpu.pipeline.roi import inside_bbox
from velocity_tpu.pipeline.speedest import SpeedEstimator as JaxSpeedEstimator
from velocity_tpu.pipeline.tracker import frame_pyramids_jit as jax_frame_pyramids
from velocity_tpu.pipeline.tracker import fused_frame_step_pyr as jax_step
from velocity_tpu_torch.convert import state_from_numpy
from velocity_tpu_torch.geometry.projection import Intrinsics, project_camera_points
from velocity_tpu_torch.ops import slab_pallas as k2
from velocity_tpu_torch.ops.lk import _pad_edge
from velocity_tpu_torch.ops.lk_lanes import lk_forward_backward_lanes
from velocity_tpu_torch.ops.pyramid import build_pyramid, resize_nearest
from velocity_tpu_torch.ops.ransac import estimate_affine_ransac, fit_affine_lsq
from velocity_tpu_torch.pipeline.roi import inside_bbox as port_inside_bbox
from velocity_tpu_torch.pipeline.scan import scan_segment
from velocity_tpu_torch.pipeline.speedest import _init_features, _init_geometry
from velocity_tpu_torch.pipeline.tracker import frame_pyramids, fused_frame_step_pyr
from velocity_tpu_torch.solvers.lm import lm_solve
from velocity_tpu_torch.solvers.pose import estimate_world_camera_pose, solve_translation
from velocity_tpu_torch.testing.synthetic_clip import render_clip

torch.set_num_threads(1)

LANE1_KMH = 35.0


@pytest.fixture(scope="module")
def clips():
    return [make_clip(),
            render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=1,
                        speed_kmh=LANE1_KMH)]


def _equal(got, want):
    """Tensors, or tuples / lists of them, bit for bit."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, torch.Tensor):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("S", [24, 72])
def test_slabs_of_a_stack_are_each_images(S):
    """K2's plain version (and its CPU wrapper) on a (3, H, W) stack, point
    i from image i // (N // 3), gives each image's slabs and clamped
    corners as a 2-D call on that image, corners past every side included;
    a stack whose count does not divide N is refused."""
    rng = np.random.default_rng(S)
    V, H, W, n = 3, 90, 130, 40
    imgs = torch.as_tensor(rng.uniform(0, 255, (V, H, W)).astype(np.float32))
    corners = rng.integers(-S - 5, [W + 5, H + 5], (V * n, 2)).astype(np.int32)
    corners[:4] = [[-3 * S, 5], [W + 7, -S], [4, H + 2 * S], [W, H]]
    corners = torch.as_tensor(corners)
    for fn in (k2.extract_slabs_ref, k2.extract_slabs):
        got, got_c = fn(imgs, corners, S)
        for v in range(V):
            want = k2.extract_slabs_ref(imgs[v], corners[v * n:(v + 1) * n], S)
            _equal((got[v * n:(v + 1) * n], got_c[v * n:(v + 1) * n]), want)
    with pytest.raises(ValueError, match="split evenly"):
        k2.extract_slabs(imgs[:2], corners[:n + 1], S)


def test_pyramids_of_a_stack_are_each_frames(clips):
    """frame_pyramids, build_pyramid, resize_nearest and the edge pad of a
    (2, H, W) stack: each lane's level equals the 2-D call's."""
    cfg = _cfg().tracker
    frames = torch.stack([torch.as_tensor(c.reader.grays[0]) for c in clips])
    full, small = frame_pyramids(frames, cfg)
    for v in range(len(clips)):
        f, s = frame_pyramids(frames[v], cfg)
        _equal([lv[v] for lv in full + small], list(f + s))
        _equal(build_pyramid(frames.float(), 2)[2][v], build_pyramid(frames[v].float(), 2)[2])
        _equal(resize_nearest(frames, 0.25)[v], resize_nearest(frames[v], 0.25))
        _equal(_pad_edge(full[1], 24)[v], _pad_edge(full[1][v], 24))


@pytest.mark.parametrize("stage", ["coarse win 15", "warped win 51"])
def test_lk_lanes_per_lane(clips, stage):
    """The lanes LK engine, forward-backward, on both lanes' frames 0 -> 1
    stacked, with their frame-0 features on one axis (warped: each lane
    through its own clip's motion, a different T23 per lane), gives each
    lane's points and status as its own call, bit for bit: K2 reads each
    point's lane image, K1 steps every lane's points, and a block in which
    one lane has nothing left to do leaves it as it is."""
    cfg = _cfg()
    V = len(clips)
    src = torch.stack([torch.as_tensor(c.reader.grays[0]).float() for c in clips])
    dst = torch.stack([torch.as_tensor(c.reader.grays[1]).float() for c in clips])
    pts = torch.stack([torch.as_tensor(_init_features(cfg, src[v].to(torch.uint8),
                                                      c.annotation.q * SCALE)[0])
                       for v, c in enumerate(clips)])
    n = pts.shape[1]
    warp = None
    if stage == "coarse win 15":
        kw = dict(win=15, max_level=3, iters=10, eps=0.03, fb_threshold=1.0)
    else:
        kw = dict(win=51, max_level=0, iters=10, eps=0.01, fb_threshold=0.3)
        warp = torch.stack([torch.as_tensor(c.motion_affine(0, 1), dtype=torch.float32)
                            for c in clips])
    L = kw["max_level"]
    spyr, dpyr = build_pyramid(src, L), build_pyramid(dst, L)
    got = lk_forward_backward_lanes(spyr[0], dpyr[0], pts.reshape(-1, 2), src_pyr=spyr,
                                    dst_pyr=dpyr, warp_dst=warp, **kw)
    for v in range(V):
        sp, dp = build_pyramid(src[v], L), build_pyramid(dst[v], L)
        want = lk_forward_backward_lanes(sp[0], dp[0], pts[v], src_pyr=sp, dst_pyr=dp,
                                         warp_dst=None if warp is None else warp[v], **kw)
        assert want.status.float().mean() > 0.5
        _equal((got.points[v * n:(v + 1) * n], got.status[v * n:(v + 1) * n]), tuple(want))


def test_ransac_lanes_per_lane():
    """RANSAC with a lane axis and one generator per lane (lane v seeded
    v) equals each lane's own call with its generator, bit for bit, as does
    the call handed the lanes' noise; a lane with too few points keeps the
    identity as alone; fit_affine_lsq per lane likewise."""
    rng = np.random.default_rng(0)
    V, n = 3, 200
    src = torch.as_tensor(rng.uniform(0, 400, (V, n, 2)).astype(np.float32))
    A = torch.tensor([[[1.01, 0.02, -0.7], [-0.01, 0.99, 1.3]],
                      [[0.99, -0.01, 0.0], [0.015, 1.0, 2.3]],
                      [[1.0, 0.0, 5.0], [0.0, 1.0, -3.0]]])
    dst = src @ A[:, :, :2].transpose(1, 2) + A[:, None, :, 2]
    dst = dst + torch.as_tensor(rng.normal(0, 0.5, (V, n, 2)).astype(np.float32))
    dst[:, :40] += torch.as_tensor(rng.uniform(-50, 50, (V, 40, 2)).astype(np.float32))
    mask = torch.as_tensor(rng.random((V, n)) > 0.1)
    mask[2, 2:] = False  # two points: RANSAC falls back to the identity
    gens = [torch.Generator().manual_seed(v) for v in range(V)]
    got = estimate_affine_ransac(src, dst, mask, gens, trials=64)
    noise = torch.as_tensor(rng.gumbel(size=(V, 64, n)).astype(np.float32))
    got_noise = estimate_affine_ransac(src, dst, mask, trials=64, gumbel=noise)
    for v in range(V):
        want = estimate_affine_ransac(src[v], dst[v], mask[v], torch.Generator().manual_seed(v),
                                      trials=64)
        _equal(tuple(x[v] for x in got), tuple(want))
        want = estimate_affine_ransac(src[v], dst[v], mask[v], trials=64, gumbel=noise[v])
        _equal(tuple(x[v] for x in got_noise), tuple(want))
        _equal(fit_affine_lsq(src, dst, mask.float())[v],
               fit_affine_lsq(src[v], dst[v], mask[v].float()))
    assert torch.equal(got.M[2], torch.tensor([[1.0, 0, 0], [0, 1.0, 0]]))
    assert (got.n_inliers[:2] > 100).all()


def test_lm_lanes_freeze_each_lane_at_its_own_stop():
    """lm_solve on two lanes of a curve fit, one started near its optimum
    and one far: each lane's x, iteration count, last step rms and residual
    rms are its own solve's, bit for bit. The near lane stops first and is
    not stepped again while the far lane goes on (stepping it again would
    move its x); a cap on iterations stops each lane as alone."""
    s = torch.linspace(0.0, 2.0, 40)
    truth = torch.tensor([[2.0, -0.7], [1.5, 0.4]])
    y = truth[:, :1] * torch.exp(truth[:, 1:] * s)
    x0 = torch.tensor([[2.00001, -0.70001], [0.5, -0.5]])

    def lanes_fn(x):
        return y - x[:, 0:1] * torch.exp(x[:, 1:2] * s)

    for cap in (30, 6):
        got = lm_solve(lanes_fn, x0, max_iters=cap, tol=1e-6)
        for v in range(2):
            want = lm_solve(lambda x, v=v: y[v] - x[0] * torch.exp(x[1] * s), x0[v],
                            max_iters=cap, tol=1e-6)
            _equal((got.x[v], got.iterations[v], got.delta_rms[v], got.residual_rms[v]),
                   (want.x, want.iterations, want.delta_rms, want.residual_rms))
        if cap == 30:
            assert got.iterations[0] < got.iterations[1] < cap
        else:
            assert got.iterations[1] == cap


def test_pose_lanes_per_lane(clips):
    """solve_translation and estimate_world_camera_pose(find_R=False) on two
    lanes (stacked cameras; lane 1 with gross outliers, so that only its
    robust second pass rejects) equal each lane's own solve, bit for bit."""
    cfg = _cfg().solver
    rng = np.random.default_rng(1)
    n = 64
    intrs = [c.reader.info.intrinsics(scale=SCALE) for c in clips]
    pw = torch.as_tensor(rng.uniform([-1.0, -0.5, 5.0], [1.0, 0.5, 7.0], (2, n, 3))
                         .astype(np.float32))
    t_true = torch.tensor([[0.1, -0.05, 0.3], [-0.2, 0.1, 0.6]])
    p = torch.stack([project_camera_points(intrs[v], pw[v] + t_true[v]) for v in range(2)])
    p[1, :6] += 40.0
    mask = torch.as_tensor(rng.random((2, n)) > 0.05)
    t0 = torch.zeros((2, 3))
    intr = Intrinsics.stack(intrs)
    eye = torch.eye(3)
    got_t = solve_translation(intr, p, pw, t0, mask, cfg)
    got = estimate_world_camera_pose(intr, p, pw, t0=t0, R0=eye, mask=mask, config=cfg)
    for v in range(2):
        want_t = solve_translation(intrs[v], p[v], pw[v], t0[v], mask[v], cfg)
        _equal((got_t.x[v], got_t.iterations[v], got_t.residual_rms[v]),
               (want_t.x, want_t.iterations, want_t.residual_rms))
        want = estimate_world_camera_pose(intrs[v], p[v], pw[v], t0=t0[v], R0=eye,
                                          mask=mask[v], config=cfg)
        _equal((got.t[v], got.residual_rms[v], got.p_proj[v], got.iterations[v]),
               (want.t, want.residual_rms, want.p_proj, want.iterations))
    with pytest.raises(ValueError, match="find_R=False"):
        estimate_world_camera_pose(intr, p, pw, t0=t0, R0=eye, find_R=True, config=cfg)


def _port_start(clip, cfg):
    """A lane's frame-0 state, as run_batch builds it: (frames, pyr, spyr,
    pts, vg, vp, t0, p3, intr)."""
    frames = torch.as_tensor(clip.reader.grays[:N_FRAMES])
    q = clip.annotation.q * SCALE
    p, valid, boxa, _ = _init_features(cfg, frames[0], q)
    t0, p3, _ = _init_geometry(cfg, clip.reader.info, q, p, valid, SCALE)
    return (frames, *frame_pyramids(frames[0], cfg.tracker), torch.as_tensor(p),
            torch.as_tensor(valid), torch.as_tensor(valid & port_inside_bbox(p, boxa)),
            torch.as_tensor(t0, dtype=torch.float32),
            torch.as_tensor(p3, dtype=torch.float32),
            clip.reader.info.intrinsics(scale=SCALE))


def test_scan_segment_lanes_per_lane(clips):
    """scan_segment with a lane axis over frames 1..2 of both lanes (one
    step per frame for both) gives each lane's carry and outputs, stacked
    (V, k, ...), as its own scan_segment with its generator, bit for bit;
    an empty segment returns its start and (V, 0, ...) outputs."""
    cfg = _cfg()
    starts = [_port_start(c, cfg) for c in clips]
    stack = lambda i: torch.stack([s[i] for s in starts])  # noqa: E731
    pyr = tuple(torch.stack(lv) for lv in zip(*(s[1] for s in starts)))
    spyr = tuple(torch.stack(lv) for lv in zip(*(s[2] for s in starts)))
    intr = Intrinsics.stack([s[8] for s in starts])
    args = (pyr, spyr, stack(3), stack(4), stack(5), stack(6), stack(7), intr)
    gens = [torch.Generator().manual_seed(v) for v in range(2)]
    carry, outs = scan_segment(stack(0)[:, 1:3], *args, gens, cfg.tracker, cfg.solver,
                               torch.float32)
    assert outs[0].shape == (2, 2, cfg.tracker.max_features, 2) and outs[3].shape == (2, 2, 3)
    for v, s in enumerate(starts):
        w_carry, w_outs = scan_segment(s[0][1:3], *s[1:8], s[8], torch.Generator().manual_seed(v),
                                       cfg.tracker, cfg.solver, torch.float32)
        _equal(tuple(o[v] for o in outs), w_outs)
        _equal([lv[v] for lv in carry[0] + carry[1]], list(w_carry[0] + w_carry[1]))
        _equal(tuple(c[v] for c in carry[2:]), w_carry[2:])
    carry_e, outs_e = scan_segment(stack(0)[:, 1:1], *args, gens, cfg.tracker, cfg.solver,
                                   torch.float32)
    assert all(c is a for c, a in zip(carry_e, args))
    assert [o.shape[:2] for o in outs_e] == [(2, 0)] * 7


def test_frame_step_lanes_matches_jax_vmap(clips, monkeypatch):
    """One step of both lanes from frame 0 to 1: the port's batched step
    against JAX's vmap of its step (``_batched_segment``'s form, lane v's
    key split(PRNGKey(v), n)[1]), the port handed JAX's Gumbel draws of
    each lane, from the JAX step's own inputs. Per lane at the tolerances
    of ``test_torch_slice.py``: points within 1e-3 px where both are valid,
    >= 99% equal validity, stage-2 counts within 1, the stage-3 affine
    within 1e-3 px on the valid points, the translation within 1e-3
    relative, the residual within 0.05 px."""
    cfg, jcfg = _cfg(), _jcfg()
    est = JaxSpeedEstimator(jcfg)
    ps, valids, vps, t0s, p3s, g0, g1 = [], [], [], [], [], [], []
    for c in clips:
        q = c.annotation.q * SCALE
        p, valid, boxa, _ = est._init_features(c.reader.grays[0], q)
        t0, p3, _ = est._init_geometry(_jax_info(c), q, p, valid, SCALE)
        ps.append(p), valids.append(valid), vps.append(valid & inside_bbox(p, boxa))
        t0s.append(t0), p3s.append(p3)
        g0.append(c.reader.grays[0]), g1.append(c.reader.grays[1])
    intr = jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[_jax_info(c).intrinsics(scale=SCALE).astype(jnp.float32)
                          for c in clips])
    pyr, spyr = jax.vmap(lambda im: jax_frame_pyramids(im, jcfg.tracker))(
        jnp.asarray(np.stack(g0)))
    keys = jnp.stack([jax.random.split(jax.random.PRNGKey(v), N_FRAMES)[1]
                      for v in range(len(clips))])
    P, Vg, Vp, T0, P3 = (np.stack(x) for x in (ps, valids, vps, t0s, p3s))

    def step(pyr, spyr, im, pts, vg, vp, p3, intr, key, t):
        return jax_step(pyr, spyr, im, pts, vg, vp, p3, intr, key, jcfg.tracker, jcfg.solver,
                        jnp.float32, t)

    want = jax.vmap(step)(pyr, spyr, jnp.asarray(np.stack(g1)), jnp.asarray(P),
                          jnp.asarray(Vg), jnp.asarray(Vp), jnp.asarray(P3, jnp.float32), intr,
                          keys, jnp.asarray(T0, jnp.float32))
    draws = [_frame_draws(keys[v]) for v in range(len(clips))]
    _inject_lanes(monkeypatch, draws)
    st = state_from_numpy(pyr=pyr, spyr=spyr, pts=P, vg=Vg, vp=Vp, t=T0, p3=P3, intr=intr,
                          device="cpu")
    got = fused_frame_step_pyr(st["pyr"], st["spyr"], torch.as_tensor(np.stack(g1)), st["pts"],
                               st["vg"], st["vp"], st["p3"], st["intr"], [None, None],
                               cfg.tracker, cfg.solver, torch.float32, st["t"])
    assert not any(draws)
    (jpts, jvg, _, jt, jres, _, jn2, jT) = (np.asarray(x) for x in want[2:10])
    (_, _, pts, vg, _, t, res, _, n2, T) = got
    for v in range(len(clips)):
        assert (vg[v].numpy() == jvg[v]).mean() >= 0.99
        both = vg[v].numpy() & jvg[v]
        assert both.sum() > 40
        np.testing.assert_allclose(pts[v].numpy()[both], jpts[v][both], rtol=0, atol=1e-3)
        assert abs(int(n2[v]) - int(jn2[v])) <= 1
        src = P[v][Vg[v]].astype(np.float64)

        def mapped(M):
            M = np.asarray(M, np.float64)
            return src @ M[:, :2].T + M[:, 2]

        np.testing.assert_allclose(mapped(T[v].numpy()), mapped(jT[v]), rtol=0, atol=1e-3)
        assert np.linalg.norm(t[v].numpy() - jt[v]) <= 1e-3 * np.linalg.norm(jt[v])
        assert abs(float(res[v]) - float(jres[v])) < 0.05

