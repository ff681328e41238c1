"""The frame step in the form that a CUDA graph captures, on the CPU: JAX's
``lax.scan`` and ``lax.while_loop`` keep control on the device, and so does
the port's step now.

- ``fused_frame_step_pyr`` in its captured form (its loops at their fixed
  trip count, ``utils/loops.py``) reads nothing back to the host (every LK
  backend, one lane and two);
- the frozen LM (``lm_solve`` and the lanes form in that form) gives the
  early-exit loop's x, step rms and count bit for bit;
- the lanes LK engine, which then runs every block of a level, gives the
  points of the eager engine, which stops once no point is left active,
  bit for bit;
- the host MSV keeps its early exit;
- the kernels' launch counters move as one (``ops/launches.py``), and the
  loop form is the eager one outside a capture.

On the card, ``scan_segment`` replays the captured step, bit-equal to the
eager step (``chip_smoke.py`` phase ``graph``; the card test below, which
runs where JAX is absent: ``python -m pytest --noconftest -m cuda
tests/test_torch_scan_form.py``). The small clip and configuration of
``tests/_torch_clip.py``, built here from the port alone.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
from velocity_tpu_torch.geometry.projection import Intrinsics
from velocity_tpu_torch.geometry.rotations import rpy_to_matrix
from velocity_tpu_torch.ops import launches, lk_lanes
from velocity_tpu_torch.pipeline.roi import inside_bbox
from velocity_tpu_torch.pipeline.scan import scan_segment
from velocity_tpu_torch.pipeline.speedest import _init_features, _init_geometry
from velocity_tpu_torch.pipeline.tracker import frame_pyramids, fused_frame_step_pyr
from velocity_tpu_torch.solvers import triangulate
from velocity_tpu_torch.solvers.lm import lm_solve
from velocity_tpu_torch.testing.synthetic_clip import render_clip
from velocity_tpu_torch.utils.loops import fixed_trip_loops, fixed_trips

torch.set_num_threads(1)

HOST_READS = {"__bool__", "item", "tolist", "__int__", "__float__", "cpu", "numpy"}
# tests/_torch_clip.py's clip and configuration (that module imports JAX)
N_FRAMES, WIDTH, HEIGHT, SCALE = 8, 480, 270, 0.5


def _cfg(lk_backend="lanes"):
    return PipelineConfig(solver=SolverConfig(dtype="float32"), msv_frame=3,
                          tracker=TrackerConfig(max_features=128, ransac_trials=64,
                                                lk_backend=lk_backend))


class HostReadError(AssertionError):
    pass


class NoHostReads(TorchFunctionMode):
    """Raises on every tensor method that brings a value to the host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in HOST_READS:
            raise HostReadError(f"host read: Tensor.{name}")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def clips():
    return [render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=0),
            render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=1, speed_kmh=35.0)]


def _start(clip, cfg):
    """A lane's frame-0 state as the scan runner builds it: (frames, pyr,
    spyr, pts, vg, vp, t0, p3, intr)."""
    frames = torch.as_tensor(clip.reader.grays[:N_FRAMES])
    q = clip.annotation.q * SCALE
    p, valid, boxa, _ = _init_features(cfg, frames[0], q)
    t0, p3, _ = _init_geometry(cfg, clip.reader.info, q, p, valid, SCALE)
    return (frames, *frame_pyramids(frames[0], cfg.tracker), torch.as_tensor(p),
            torch.as_tensor(valid), torch.as_tensor(valid & inside_bbox(p, boxa)),
            torch.as_tensor(t0, dtype=torch.float32), torch.as_tensor(p3, dtype=torch.float32),
            clip.reader.info.intrinsics(scale=SCALE))


def _stacked(starts):
    """The lanes' frame-0 states stacked on a lane axis."""
    stack = lambda i: torch.stack([s[i] for s in starts])  # noqa: E731
    pyr = tuple(torch.stack(lv) for lv in zip(*(s[1] for s in starts)))
    spyr = tuple(torch.stack(lv) for lv in zip(*(s[2] for s in starts)))
    return (stack(0), pyr, spyr, *(stack(i) for i in range(3, 8)),
            Intrinsics.stack([s[8] for s in starts]))


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("lk_backend", ["lanes", "fast", "reference"])
def test_frame_step_reads_nothing_back(clips, lk_backend, lanes):
    """One frame step (frame 0 -> 1) in its captured form under a mode that
    raises on every host read (``__bool__``, ``item``, ``tolist``,
    ``__int__``, ``__float__``, ``cpu``, ``numpy``): it finishes, with
    finite translations. The mode does catch a read: the eager LM raises
    under it."""
    cfg = _cfg(lk_backend)
    starts = [_start(c, cfg) for c in clips[:lanes]]
    frames, pyr, spyr, pts, vg, vp, t0, p3, intr = (
        _stacked(starts) if lanes > 1 else starts[0])
    im = frames[:, 1] if lanes > 1 else frames[1]
    gens = [torch.Generator().manual_seed(v) for v in range(lanes)]
    with fixed_trip_loops(), NoHostReads():
        out = fused_frame_step_pyr(pyr, spyr, im, pts, vg, vp, p3, intr,
                                   gens if lanes > 1 else gens[0], cfg.tracker, cfg.solver,
                                   torch.float32, t0)
    assert torch.isfinite(out[5]).all() and out[5].shape == t0.shape
    with pytest.raises(HostReadError), NoHostReads():
        lm_solve(lambda x: x - 1.0, torch.zeros(2))


def _exp_fit(dtype):
    """Two exponential fits, one started at its solution (it stops at tol
    within a few steps) and one far from it; a lane function over both and
    each lane's own."""
    s = torch.linspace(0.0, 2.0, 40, dtype=dtype)
    truth = torch.tensor([[2.0, -0.7], [1.5, 0.4]], dtype=dtype)
    y = truth[:, :1] * torch.exp(truth[:, 1:] * s)
    x0 = torch.tensor([[2.00001, -0.70001], [0.5, -0.5]], dtype=dtype)

    def lanes_fn(x):
        return y - x[:, 0:1] * torch.exp(x[:, 1:2] * s)

    def lane_fn(v):
        return lambda x: y[v] - x[0] * torch.exp(x[1] * s)

    return x0, lanes_fn, lane_fn


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frozen_lm_matches_the_early_exit_loop(dtype):
    """``lm_solve`` in its captured form runs every iteration and freezes x,
    the step rms and the count once converged: the early-exit loop's x, step
    rms, count and residual rms, bit for bit, with the ramp and without it,
    for a solve that stops at tol and one that stops at the cap; its count
    is an int64 tensor."""
    x0, _, lane_fn = _exp_fit(dtype)
    stops = set()
    for v in range(2):
        for cap in (30, 6):
            for use_ramp in (True, False):
                kw = dict(max_iters=cap, tol=1e-6, use_ramp=use_ramp,
                          damping=torch.tensor(0.5, dtype=dtype))
                want = lm_solve(lane_fn(v), x0[v], **kw)
                with fixed_trip_loops():
                    got = lm_solve(lane_fn(v), x0[v], **kw)
                _same(got.x, want.x)
                _same(got.delta_rms, want.delta_rms)
                _same(got.residual_rms, want.residual_rms)
                assert got.iterations.dtype == torch.int64
                assert int(got.iterations) == want.iterations
                stops.add("cap" if want.iterations == cap else "tol")
    assert stops == {"cap", "tol"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frozen_lm_lanes_match_each_lanes_early_exit_loop(dtype):
    """The lanes LM, in its captured form and eagerly, on two lanes, one
    that stops at tol and one that stops at the cap (cap 6), and with the
    cap out of reach (cap 30): each lane's x, step rms, count and residual
    rms are those of its own early-exit solve, bit for bit."""
    x0, lanes_fn, lane_fn = _exp_fit(dtype)
    for cap, fixed in ((30, True), (6, True), (30, False), (6, False)):
        with fixed_trip_loops() if fixed else contextlib.nullcontext():
            got = lm_solve(lanes_fn, x0, max_iters=cap, tol=1e-6)
        assert got.iterations.dtype == torch.int64 and got.iterations.shape == (2,)
        counts = []
        for v in range(2):
            want = lm_solve(lane_fn(v), x0[v], max_iters=cap, tol=1e-6)
            _same(got.x[v], want.x)
            _same(got.delta_rms[v], want.delta_rms)
            _same(got.residual_rms[v], want.residual_rms)
            assert int(got.iterations[v]) == want.iterations
            counts.append(want.iterations)
        if cap == 6:
            assert counts[0] < cap == counts[1]
        else:
            assert counts[0] < counts[1] < cap


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("stage", ["plain", "warped"])
def test_lk_all_blocks_match_the_early_exit_engine(clips, stage, lanes, monkeypatch):
    """In its captured form the lanes LK engine runs every block of a
    level; run eagerly it stops once no trackable point is left undone (the
    JAX ``while_loop``). Both give the same points and status bit for bit,
    forward-backward, at stage 2's settings (plain) and stage 3's (warped
    through each clip's motion), on one lane and on two; the eager run
    makes fewer blocks, so the case is not vacuous."""
    cfg = _cfg().tracker
    lk = cfg.lk_coarse if stage == "plain" else cfg.lk_fine
    starts = [_start(c, _cfg()) for c in clips[:lanes]]
    frames = torch.stack([s[0][:2] for s in starts]).float()
    pts = torch.stack([s[3] for s in starts]).reshape(-1, 2)
    warp = None
    if stage == "warped":
        warp = torch.stack([torch.as_tensor(c.motion_affine(0, 1), dtype=torch.float32)
                            for c in clips[:lanes]])
    src, dst = (frames[:, 0], frames[:, 1]) if lanes > 1 else (frames[0, 0], frames[0, 1])
    if lanes == 1 and warp is not None:
        warp = warp[0]
    kw = dict(fb_threshold=1.0, warp_dst=warp, win=lk.window, max_level=lk.max_level,
              iters=lk.max_iters, eps=lk.eps)
    real, blocks = lk_lanes.lk_block, []

    def counting(*args, **kwargs):
        blocks[-1] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(lk_lanes, "lk_block", counting)
    blocks.append(0)
    with fixed_trip_loops():
        got = lk_lanes.lk_forward_backward_lanes(src, dst, pts, **kw)
    blocks.append(0)
    want = lk_lanes.lk_forward_backward_lanes(src, dst, pts, **kw)
    assert blocks[1] < blocks[0], blocks
    _same(got.points, want.points)
    _same(got.status, want.status)


def test_msv_lm_keeps_its_early_exit(monkeypatch):
    """The host MSV (``msv_refine_translation``, cap ``max_iters_msv``)
    keeps the early-exit loop: on a scene it solves below the cap, its
    count is a host int below the cap, its residual function runs a few
    times per iteration rather than the cap's, and the captured form of the
    same solve reports the same count and x."""
    rng = np.random.default_rng(0)
    fx, fy, cx, cy = 1200.0, 1190.0, 640.0, 360.0
    intr = Intrinsics(*(torch.tensor(v, dtype=torch.float64) for v in (fx, fy, cx, cy, 0.0)))
    n, nf = 64, 6
    R = rpy_to_matrix(torch.tensor([0.05, -0.2, 0.1], dtype=torch.float64)).numpy()
    pw = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.7, 0.3, n), np.zeros(n)], 1)
    t0 = np.array([0.6, 0.45, 3.0])
    p3 = pw @ R + t0
    t_rel = np.stack([np.array([0.02, 0.0, 0.37]) * k for k in range(nf)])
    pix = []
    for t in t_rel:
        pc = p3 + t
        pix.append(np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1)
                   + rng.normal(0, 0.05, (n, 2)))
    origins = t0 + t_rel
    args = (intr, torch.as_tensor(np.array(pix)), torch.ones(n, dtype=torch.bool),
            torch.as_tensor(origins))
    cfg = SolverConfig()
    calls, forms = [0], []
    real = triangulate.lm_solve

    def counting(residual_fn, x0, **kw):
        forms.append(fixed_trips())

        def fn(x):
            calls[0] += 1
            return residual_fn(x)

        return real(fn, x0, **kw)

    monkeypatch.setattr(triangulate, "lm_solve", counting)
    res = triangulate.msv_refine_translation(*args, config=cfg)
    assert forms == [False]
    assert isinstance(res.iterations, int) and 0 < res.iterations < cfg.max_iters_msv
    assert calls[0] <= 3 * (res.iterations + 1)

    short = SolverConfig(max_iters_msv=res.iterations + 5)
    with fixed_trip_loops():
        fz = triangulate.msv_refine_translation(*args, config=short)
    assert int(fz.iterations) == res.iterations
    _same(fz.t, res.t)


def test_loop_form_is_eager_outside_a_capture():
    """``fixed_trips()`` is False outside ``fixed_trip_loops()`` and on
    another thread, True inside it, and False again after an exception
    leaves it."""
    assert not fixed_trips()
    seen = []
    with fixed_trip_loops():
        assert fixed_trips()
        t = threading.Thread(target=lambda: seen.append(fixed_trips()))
        t.start()
        t.join()
        with fixed_trip_loops():
            assert fixed_trips()
        assert fixed_trips()
    assert seen == [False] and not fixed_trips()
    with pytest.raises(ValueError), fixed_trip_loops():
        raise ValueError
    assert not fixed_trips()


def test_launch_counts_move_as_one():
    """``ops/launches.py`` reads, sets, adds and differences the six
    wrappers' counters (K5's ``extract_warped`` keyed by (P, Q), K6's
    ``source_window`` by (win, P, cubic)) as the graph's capture and
    replays do."""
    saved = launches.read()
    try:
        launches.set_counts()
        assert launches.read() == {name: (0, {}) for name in launches.counters()}
        add = {"lk_block": (3, {(15, False): 3}), "extract_slabs": (2, {24: 1, 72: 1}),
               "extract_patches": (0, {}), "corner_subpix": (1, {27: 1}),
               "extract_warped": (7, {(64, 72): 7}),
               "source_window": (17, {(15, 24, False): 15, (51, 56, False): 1,
                                      (51, 64, True): 1})}
        before = launches.read()
        launches.add(add)
        launches.add(add)
        assert launches.counters()["lk_block"].launches == 6
        assert launches.counters()["extract_warped"].launches_by_shape == {(64, 72): 14}
        assert launches.counters()["source_window"].launches_by_shape == {
            (15, 24, False): 30, (51, 56, False): 2, (51, 64, True): 2}
        assert launches.since(before) == {name: (2 * n, {k: 2 * m for k, m in by.items()})
                                         for name, (n, by) in add.items()}
        launches.set_counts(before)
        assert launches.read() == before
    finally:
        launches.set_counts(saved)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device: the step's "
                    "CUDA graph is captured and replayed only on a card")
@pytest.mark.parametrize("lk_backend", ["lanes", "fast"])
def test_graph_segment_matches_the_eager_step_on_card(clips, lk_backend):
    """On the card ``scan_segment`` replays one captured graph per frame:
    its outputs and carry equal those of the eager step called frame by
    frame with a generator in the same state, bit for bit, on one lane and
    on two; the kernels' counters read one capture's launches per replay.
    On the lanes backend a replay launches K1 42 times (every block of every
    level), K2 36 (the destination slabs of the linear levels' blocks), K5 7
    (stage 3's six forward blocks and the backward leg's source windows) and
    K6 17 (each level's source window: 15 at win 15, stage 3's two at
    win 51), on one lane and on two alike; the fast backend launches neither
    K5 nor K6."""
    from velocity_tpu_torch.pipeline import step_graph

    cfg = _cfg(lk_backend)
    dev = torch.device("cuda")
    for lanes in (1, 2):
        starts = [tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in _start(c, cfg))
                  for c in clips[:lanes]]
        frames, pyr, spyr, pts, vg, vp, t0, p3, intr = (
            _stacked(starts) if lanes > 1 else starts[0])
        pyr = tuple(lv.to(dev) for lv in pyr)
        spyr = tuple(lv.to(dev) for lv in spyr)
        intr = intr.to(dtype=torch.float32, device=dev)

        def gens():
            g = [torch.Generator(device=dev).manual_seed(v) for v in range(lanes)]
            return g if lanes > 1 else g[0]

        seg = frames[:, 1:] if lanes > 1 else frames[1:]
        before = launches.read()
        carry, outs = scan_segment(seg, pyr, spyr, pts, vg, vp, t0, p3, intr, gens(),
                                   cfg.tracker, cfg.solver, torch.float32)
        steps = seg.shape[1] if lanes > 1 else len(seg)
        counted = launches.since(before)
        if lk_backend == "lanes":
            assert {k: counted[k][0] for k in ("lk_block", "extract_slabs", "extract_warped",
                                               "source_window")} == {
                "lk_block": 42 * steps, "extract_slabs": 36 * steps,
                "extract_warped": 7 * steps, "source_window": 17 * steps}
            assert counted["source_window"][1] == {(15, 24, False): 15 * steps,
                                                   (51, 56, False): steps,
                                                   (51, 64, True): steps}
        else:
            assert counted["extract_warped"][0] == counted["source_window"][0] == 0
        g = gens()
        state = (pyr, spyr, pts, vg, vp, t0)
        want = []
        for j in range(seg.shape[1] if lanes > 1 else len(seg)):
            state, rec = step_graph._frame(seg[:, j] if lanes > 1 else seg[j], state, p3, intr,
                                           g, cfg.tracker, cfg.solver, torch.float32, False)
            want.append(rec)
        axis = 1 if lanes > 1 else 0
        for got_o, want_o in zip(outs, zip(*want)):
            _same(got_o, torch.stack(want_o, dim=axis))
        for got_c, want_c in zip(step_graph._flat(carry), step_graph._flat(state)):
            _same(got_c, want_c)
