"""The lane axis of every LK configuration other than the lanes engine, which
``run_batch`` now steps as one batched segment per device, on the CPU: K3's
plain version and the padded patch extraction on an image stack, the fast
and gather LK engines on two lanes' frames, and the feature-sharded LK on
them, each against the same call lane by lane (or unsharded), bit for bit;
then the whole step with ``lk_backend`` "fast" and "reference" on two lanes
against JAX's vmap of its step, as ``_batched_segment`` builds it.

Lanes: the small clip of ``tests/_torch_clip.py`` (seed 0, 40 km/h) and
seed 1 at 35 km/h, as in ``test_torch_batch.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_clip import (N_FRAMES, SCALE, WIDTH, HEIGHT, _cfg, _frame_draws, _inject_lanes,
                         _jax_info, _jcfg, make_clip)

from velocity_tpu.pipeline.roi import inside_bbox
from velocity_tpu.pipeline.speedest import SpeedEstimator as JaxSpeedEstimator
from velocity_tpu.pipeline.tracker import frame_pyramids_jit as jax_frame_pyramids
from velocity_tpu.pipeline.tracker import fused_frame_step_pyr as jax_step
from velocity_tpu_torch.convert import state_from_numpy
from velocity_tpu_torch.geometry.projection import Intrinsics
from velocity_tpu_torch.ops import interp
from velocity_tpu_torch.ops import patch_pallas as k3
from velocity_tpu_torch.ops.lk import lk_forward_backward, lk_pyramidal
from velocity_tpu_torch.ops.lk_fast import lk_forward_backward_fast, lk_pyramidal_fast
from velocity_tpu_torch.ops.lk_lanes import lk_forward_backward_lanes
from velocity_tpu_torch.parallel import make_mesh
from velocity_tpu_torch.parallel.track_shard import lk_forward_backward_sharded
from velocity_tpu_torch.pipeline.roi import inside_bbox as port_inside_bbox
from velocity_tpu_torch.pipeline.scan import scan_segment
from velocity_tpu_torch.pipeline.speedest import _init_features, _init_geometry
from velocity_tpu_torch.pipeline.tracker import frame_pyramids, fused_frame_step_pyr
from velocity_tpu_torch.testing.synthetic_clip import render_clip

torch.set_num_threads(1)

LANE1_KMH = 35.0
# the stage forms of the LK engines: stage 2 (win 15, 4 levels, fb 1 px) and
# stage 3 (win 51, one level, fb 0.3 px, one affine per lane)
STAGES = {"coarse win 15": dict(win=15, max_level=3, iters=10, eps=0.03, fb_threshold=1.0),
          "warped win 51": dict(win=51, max_level=0, iters=10, eps=0.01, fb_threshold=0.3)}


@pytest.fixture(scope="module")
def clips():
    return [make_clip(),
            render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=1,
                        speed_kmh=LANE1_KMH)]


@pytest.fixture(scope="module")
def pair(clips):
    """Both lanes' frames 0 and 1 stacked (2, H, W) f32, their frame-0
    features (2, n, 2) and each clip's motion 0 -> 1 (2, 2, 3)."""
    cfg = _cfg()
    src = torch.stack([torch.as_tensor(c.reader.grays[0]).float() for c in clips])
    dst = torch.stack([torch.as_tensor(c.reader.grays[1]).float() for c in clips])
    pts = torch.stack([torch.as_tensor(_init_features(cfg, src[v].to(torch.uint8),
                                                      c.annotation.q * SCALE)[0])
                       for v, c in enumerate(clips)])
    warp = torch.stack([torch.as_tensor(c.motion_affine(0, 1), dtype=torch.float32)
                        for c in clips])
    return src, dst, pts, warp


def _equal(got, want):
    """Tensors, or tuples / lists of them, bit for bit."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)


def _lanes_equal(got, want_fn, pts, V):
    """``got`` (an LKResult over V lanes of n points each) equals
    ``want_fn(v)`` on each lane's rows, bit for bit; most points track."""
    n = pts.shape[1]
    for v in range(V):
        want = want_fn(v)
        assert want.status.float().mean() > 0.5
        _equal((got.points[v * n:(v + 1) * n], got.status[v * n:(v + 1) * n]), tuple(want))


# (label, H, W, size): K3's shapes at this scale, and a top pyramid level
# smaller than the patch, which interp.extract_patches edge-pads first
PATCH_CASES = (("P34", 90, 130, 34), ("Q82", 100, 140, 82), ("top level", 17, 30, 34))


@pytest.mark.parametrize("label,H,W,size", PATCH_CASES)
def test_patches_of_a_stack_are_each_images(label, H, W, size):
    """K3's plain version and CPU wrapper, and interp.extract_patches, on a
    (3, H, W) stack, point i from image i // (N // 3): each image's patches
    and clamped corners as a 2-D call on that image, corners past every
    side included; a top level smaller than the patch is padded image by
    image."""
    rng = np.random.default_rng(size + H)
    V, n = 3, 40
    imgs = torch.as_tensor(rng.uniform(0, 255, (V, H, W)).astype(np.float32))
    corners = rng.integers(-size - 5, [W + 5, H + 5], (V * n, 2)).astype(np.int32)
    corners[:4] = [[-3 * size, 5], [W + 7, -size], [4, H + 2 * size], [W, H]]
    corners = torch.as_tensor(corners)
    fns = [interp.extract_patches]
    if size <= min(H, W):
        fns += [k3.extract_patches_ref, k3.extract_patches]
    for fn in fns:
        got, got_c = fn(imgs, corners, size)
        assert got.shape == (V * n, size, size)
        for v in range(V):
            want = fn(imgs[v], corners[v * n:(v + 1) * n], size)
            _equal((got[v * n:(v + 1) * n], got_c[v * n:(v + 1) * n]), want)


def test_bilinear_sample_of_a_stack_reads_each_lanes_image():
    """bilinear_sample on a (2, H, W) stack with a lane per sample (both
    borders, samples past every edge) equals the 2-D call on each lane's
    image; a stack without lanes, or lanes without a stack, is refused."""
    rng = np.random.default_rng(7)
    imgs = torch.as_tensor(rng.uniform(0, 255, (2, 30, 40)).astype(np.float32))
    x = torch.as_tensor(rng.uniform(-3, 43, (2, 50, 6)).astype(np.float32))
    y = torch.as_tensor(rng.uniform(-3, 33, (2, 50, 6)).astype(np.float32))
    lane = torch.arange(2)[:, None, None]
    for border in ("clamp", "zero"):
        got = interp.bilinear_sample(imgs, x, y, border, lane=lane)
        for v in range(2):
            _equal(got[v], interp.bilinear_sample(imgs[v], x[v], y[v], border))
    with pytest.raises(ValueError, match="lane"):
        interp.bilinear_sample(imgs, x, y)
    with pytest.raises(ValueError, match="lane"):
        interp.bilinear_sample(imgs[0], x, y, lane=lane)


@pytest.mark.parametrize("fb", [False, True], ids=["pyramidal", "forward-backward"])
@pytest.mark.parametrize("stage", list(STAGES))
def test_lk_fast_lanes_per_lane(pair, stage, fb):
    """The fast LK engine on both lanes' frames 0 -> 1 stacked, with their
    frame-0 features on one axis (warped: each lane through its own clip's
    motion, a different T23 per lane), gives each lane's points and status
    as its own call, bit for bit: K3 reads each point's lane image, the
    warped stencil takes each point's map, and the resampling products run
    over all points at once."""
    src, dst, pts, warp = pair
    kw = dict(STAGES[stage])
    fbt = kw.pop("fb_threshold")
    M = warp if stage == "warped win 51" else None
    V = src.shape[0]
    if fb:
        got = lk_forward_backward_fast(src, dst, pts.reshape(-1, 2), fb_threshold=fbt,
                                       warp_dst=M, **kw)
        _lanes_equal(got, lambda v: lk_forward_backward_fast(
            src[v], dst[v], pts[v], fb_threshold=fbt, warp_dst=None if M is None else M[v],
            **kw), pts, V)
    else:
        got = lk_pyramidal_fast(src, dst, pts.reshape(-1, 2), warp_dst=M, **kw)
        _lanes_equal(got, lambda v: lk_pyramidal_fast(
            src[v], dst[v], pts[v], warp_dst=None if M is None else M[v], **kw), pts, V)


@pytest.mark.parametrize("stage", list(STAGES))
def test_lk_gather_lanes_per_lane(pair, stage):
    """The gather LK engine (``ops/lk.py``), forward-backward, on both
    lanes stacked (warped: one map per lane, which the backward leg takes
    on its source side, its gradients chain-ruled per point), gives each
    lane's points and status as its own call, bit for bit; so does its
    forward leg alone."""
    src, dst, pts, warp = pair
    kw = dict(STAGES[stage])
    fbt = kw.pop("fb_threshold")
    M = warp if stage == "warped win 51" else None
    got = lk_forward_backward(src, dst, pts.reshape(-1, 2), fb_threshold=fbt, warp_dst=M, **kw)
    _lanes_equal(got, lambda v: lk_forward_backward(
        src[v], dst[v], pts[v], fb_threshold=fbt, warp_dst=None if M is None else M[v], **kw),
        pts, src.shape[0])
    fwd = lk_pyramidal(src, dst, pts.reshape(-1, 2), warp_dst=M, **kw)
    _lanes_equal(fwd, lambda v: lk_pyramidal(src[v], dst[v], pts[v],
                                             warp_dst=None if M is None else M[v], **kw),
                 pts, src.shape[0])


@pytest.mark.parametrize("stage", list(STAGES))
def test_sharded_lk_lanes_equals_unsharded(pair, stage):
    """lk_forward_backward_sharded on both lanes stacked, 2 in-process CPU
    shards (shard s takes half s of every lane's points, its guess split
    alike, each lane's map whole), equals the unsharded lanes call, bit for
    bit, and so each lane's own call."""
    src, dst, pts, warp = pair
    kw = dict(STAGES[stage])
    M = warp if stage == "warped win 51" else None
    guess = (pts + torch.tensor([1.0, -0.5])).reshape(-1, 2) if M is None else None
    flat = pts.reshape(-1, 2)
    want = lk_forward_backward_lanes(src, dst, flat, guess=guess, warp_dst=M, **kw)
    mesh = make_mesh({"feature": 2}, devices=["cpu"] * 2)
    got = lk_forward_backward_sharded(src, dst, flat, mesh, "feature", guess=guess,
                                      warp_dst=M, **kw)
    _equal(tuple(got), tuple(want))
    assert want.status.float().mean() > 0.5
    n = pts.shape[1]
    one = lk_forward_backward_lanes(src[1], dst[1], pts[1],
                                    guess=None if guess is None else guess[n:],
                                    warp_dst=None if M is None else M[1], **kw)
    _equal((got.points[n:], got.status[n:]), tuple(one))


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


CONFIGS = {"fast": dict(lk_backend="fast"), "reference": dict(lk_backend="reference"),
           "shard_features 2": dict(shard_features=2)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_scan_segment_lanes_per_lane(clips, name):
    """scan_segment with a lane axis over frames 1..2 of both lanes, with
    the fast engine, the gather engine and 2 feature shards, gives each
    lane's carry and outputs as its own scan_segment with its generator,
    bit for bit. Lane 1 keeps most of its points; lane 0's stage 2
    collapses at frame 1 under the gather engine, as in JAX."""
    cfg = _cfg(**CONFIGS[name])
    starts = [_port_start(c, cfg) for c in clips]
    stack = lambda i: torch.stack([s[i] for s in starts])  # noqa: E731
    pyr = tuple(torch.stack(lv) for lv in zip(*(s[1] for s in starts)))
    spyr = tuple(torch.stack(lv) for lv in zip(*(s[2] for s in starts)))
    intr = Intrinsics.stack([s[8] for s in starts])
    args = (pyr, spyr, stack(3), stack(4), stack(5), stack(6), stack(7), intr)
    gens = [torch.Generator().manual_seed(v) for v in range(2)]
    carry, outs = scan_segment(stack(0)[:, 1:3], *args, gens, cfg.tracker, cfg.solver,
                               torch.float32)
    for v, s in enumerate(starts):
        w_carry, w_outs = scan_segment(s[0][1:3], *s[1:8], s[8], torch.Generator().manual_seed(v),
                                       cfg.tracker, cfg.solver, torch.float32)
        _equal(tuple(o[v] for o in outs), w_outs)
        _equal(tuple(c[v] for c in carry[2:]), w_carry[2:])
    assert outs[1][1].float().mean() > 0.9


@pytest.mark.parametrize("lk_backend", ["fast", "reference"])
def test_frame_step_lanes_matches_jax_vmap(clips, monkeypatch, lk_backend):
    """One step of both lanes from frame 0 to 1 with the fast and the gather
    LK engines: the port's batched step against JAX's vmap of its step
    (``_batched_segment``'s form, lane v's key split(PRNGKey(v), n)[1]), the
    port handed JAX's Gumbel draws of each lane, from the JAX step's own
    inputs. Per lane at the tolerances of ``test_torch_slice.py``: points
    within 1e-3 px where both are valid, >= 99% equal validity, stage-2
    counts within 1, the stage-3 affine within 1e-3 px on the valid points,
    the translation within 1e-3 relative, the residual within 0.05 px. With
    the gather engine lane 0's stage 2 collapses at this frame in both
    packages: its validity is compared (no point survives), its points are
    not, and its stage-3 affine, stage 1's model from quarter-scale points,
    is held to 1e-3 px at that scale."""
    cfg, jcfg = _cfg(lk_backend), _jcfg(lk_backend)
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
    assert jvg[1].any()
    for v in range(len(clips)):
        assert (vg[v].numpy() == jvg[v]).mean() >= 0.99
        both = vg[v].numpy() & jvg[v]
        if jvg[v].any():  # not a lane whose stage 2 collapsed in JAX
            assert both.sum() > 40
        np.testing.assert_allclose(pts[v].numpy()[both], jpts[v][both], rtol=0, atol=1e-3)
        assert abs(int(n2[v]) - int(jn2[v])) <= 1
        src = P[v][Vg[v]].astype(np.float64)

        def mapped(M):
            M = np.asarray(M, np.float64)
            return src @ M[:, :2].T + M[:, 2]

        # a lane whose stage 2 collapsed keeps stage 1's model, fit on the
        # quarter-scale points (1e-3 px there): 1e-3 / coarse_scale px here
        collapsed = int(jn2[v]) <= cfg.tracker.min_affine_inliers
        atol = 1e-3 / cfg.tracker.coarse_scale if collapsed else 1e-3
        np.testing.assert_allclose(mapped(T[v].numpy()), mapped(jT[v]), rtol=0, atol=atol)
        assert np.linalg.norm(t[v].numpy() - jt[v]) <= 1e-3 * np.linalg.norm(jt[v])
        assert abs(float(res[v]) - float(jres[v])) < 0.05
