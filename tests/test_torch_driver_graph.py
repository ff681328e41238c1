"""The per-frame drivers' replay path, held to the eager drivers bit for bit.

On a card ``SpeedEstimator.run`` and ``StillsSpeedEstimator.run`` take each
frame's step as one replay of the captured CUDA graph
(``pipeline/step_graph.py``), then read the stage-2 count and run the rescue
eagerly where it collapsed, as JAX's driver runs its unjitted rescue after
its jitted step; on the CPU they step eagerly. After a replay the outputs
the driver held from the frame before are overwritten, so the rescue reads
the previous frame's state from the graph's input buffers.

Here a stand-in for the graph, defined below with the graph's buffer
contract, is put where the driver takes its captured step
(``speedest._captured_step``), so the CPU runs the replay path:

- the driver through the stand-in against the eager driver, bit for bit:
  plain, lean, the rescue forced on every frame through a matcher built
  from the clip's known motion, and a clip with a jump whose one collapse
  follows a replayed frame (a rescue that read an overwritten buffer fails
  these);
- the stills driver through the stand-in against the eager one, with
  lanes re-seeded and promoted on the host between replays;
- the forced-rescue run through the stand-in against JAX's driver;
- on the CPU the drivers never reach the graph.

The card test holds the real graph against the eager driver (``python -m
pytest --noconftest -m cuda tests/test_torch_driver_graph.py``; this file
imports JAX only inside the JAX test). The clip and configuration of
``tests/_torch_clip.py`` (480x270, msv_frame 3, 128 features, 64 trials,
f32 solver), rendered to 16 frames for the jump.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
from velocity_tpu_torch.ops.ransac import DrawnNoise, draw_gumbel
from velocity_tpu_torch.pipeline import anchor, speedest, step_graph
from velocity_tpu_torch.pipeline.speedest import SpeedEstimator
from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator
from velocity_tpu_torch.pipeline.tracker import RANSAC_CALLS
from velocity_tpu_torch.testing.synthetic_clip import SyntheticVideoReader, render_clip
from velocity_tpu_torch.utils.loops import fixed_trip_loops

torch.set_num_threads(1)

# tests/_torch_clip.py's sizes (that module imports JAX)
N_FRAMES, WIDTH, HEIGHT = 8, 480, 270
ALWAYS = 10**6  # min_affine_inliers that sends every frame through the rescue
# the jump clip: the 16-frame clip's frames 0-5, then 12 and 13; stage 2
# collapses at frame 6 (the jump) and holds at frame 7
JUMP = [0, 1, 2, 3, 4, 5, 12, 13]
# the stills burst of test_torch_stills.py: few strong corners, so the
# driver re-seeds lanes from the MSV frame on and promotes some
BURST = dict(speed_kmh=40.0, depth0_m=4.0, stride=3, filename="synthetic.JPG", native_scale=1.0)


def _cfg(**tracker):
    return PipelineConfig(solver=SolverConfig(dtype="float32"), msv_frame=3,
                          tracker=TrackerConfig(max_features=128, ransac_trials=64, **tracker))


def _stills_cfg():
    return dataclasses.replace(_cfg(car_affine=True, harris_quality=0.12), native_scale=1.0)


class StandInGraph:
    """``step_graph._StepGraph``'s buffer contract without CUDA: the inputs
    are copied into buffers it owns (made from the first call's inputs),
    the frame's RANSAC noise is drawn from the generator before the step,
    as the graph's ``__call__`` draws it, ``_frame`` runs on the input
    buffers in the captured form of its loops with that noise, and its
    outputs are copied into the same output tensors on every call, which
    the next call overwrites."""

    def __init__(self, im, carry, p3, intr, cfg, solver_cfg, solver_dtype, lean):
        self.args = (cfg, solver_cfg, solver_dtype, lean)
        self.inputs = step_graph._clone((im, carry, p3, intr))
        pts = carry[2]
        self.trials, self.n, self.lanes = cfg.ransac_trials, pts.shape[-2], pts.dim() == 3
        self.outputs = None
        self.replays = 0

    def __call__(self, im, carry, p3, intr, generator):
        for buf, x in zip(step_graph._flat(self.inputs), step_graph._flat((im, carry, p3, intr))):
            if buf is not x:
                buf.copy_(x)
        noise = [draw_gumbel(generator, self.trials, self.n, im.device, self.lanes)
                 for _ in range(RANSAC_CALLS)]
        with fixed_trip_loops():
            out = step_graph._frame(*self.inputs, DrawnNoise(noise), *self.args)
        if self.outputs is None:
            self.outputs = step_graph._clone(out)
        else:
            for buf, x in zip(step_graph._flat(self.outputs), step_graph._flat(out)):
                buf.copy_(x)
        self.replays += 1
        return self.outputs


def _replaying_step(graphs):
    """A stand-in for ``speedest._captured_step``: one ``StandInGraph`` per
    input shapes and configuration, as ``step_graph._graph_step`` keeps one
    graph per key, kept in ``graphs``."""

    def captured_step(im, carry, p3, intr, cfg, solver_cfg, solver_dtype):
        key = (tuple((tuple(t.shape), t.dtype)
                     for t in step_graph._flat((im, carry, p3, intr))),
               cfg, solver_cfg, solver_dtype)
        if key not in graphs:
            graphs[key] = StandInGraph(im, carry, p3, intr, cfg, solver_cfg, solver_dtype, False)
        return graphs[key]

    return captured_step


def _key(x):
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    return repr(x)


@pytest.fixture(scope="module", autouse=True)
def msv_once():
    """The host MSV re-anchor (about 15 s of CPU on this clip, where it
    stops at its iteration cap) runs once per distinct input: a call whose
    arguments equal an earlier call's byte for byte gets a copy of that
    call's result, which the same inputs give."""
    real, memo = anchor.reanchor, {}

    def reanchor(*args, **kwargs):
        key = tuple(_key(a) for a in args) + tuple((k, _key(v)) for k, v in sorted(kwargs.items()))
        if key not in memo:
            memo[key] = real(*args, **kwargs)
        return copy.deepcopy(memo[key])

    with pytest.MonkeyPatch.context() as mp:
        # the per-frame loop, the stills driver's too, imports it at each run
        mp.setattr(anchor, "reanchor", reanchor)
        yield


@pytest.fixture(scope="module")
def clip():
    return render_clip(n_frames=16, width=WIDTH, height=HEIGHT, seed=0)


@pytest.fixture(scope="module")
def burst():
    return render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=0, **BURST)


def _known_motion(clip, calls):
    """A rescue matcher that returns the clip's true motion between the two
    frames it is given, and records their indices in ``calls``."""

    def matcher(im_prev, im_cur, pts, valid):
        pair = (clip.frame_index(im_prev), clip.frame_index(im_cur))
        calls.append(pair)
        return clip.motion_affine(*pair)

    return matcher


def _jump_reader(clip):
    r = clip.reader
    return SyntheticVideoReader(r.grays[JUMP], r.info, r.fps)


def _same_run(got, want):
    """The replaying driver's run equals the eager driver's bit for bit."""
    np.testing.assert_array_equal(got.B, want.B)
    np.testing.assert_array_equal(got.S[:, 2:], want.S[:, 2:])
    np.testing.assert_array_equal(got.track_px, want.track_px)
    np.testing.assert_array_equal(got.proj_px, want.proj_px)
    np.testing.assert_array_equal(got.valid, want.valid)


def _driver_case(case, clip, calls, device="cpu"):
    """(estimator, reader, run keywords) of a case of the driver."""
    matcher = _known_motion(clip, calls)
    reader = _jump_reader(clip) if case == "jump" else clip.reader
    cfg = _cfg(min_affine_inliers=ALWAYS) if case == "rescue" else _cfg()
    est = SpeedEstimator(cfg, device=device, fallback_matcher=matcher)
    return est, reader, dict(annotation=clip.annotation, n_frames=N_FRAMES, verbose=False,
                             lean=case == "lean")


def _rescued_pairs(case):
    """The frame pairs (clip indices) whose step the driver rescues."""
    if case == "rescue":
        return [(i - 1, i) for i in range(1, N_FRAMES)]
    return [(5, 12)] if case == "jump" else []


@pytest.mark.parametrize("case", ["plain", "lean", "rescue", "jump"])
def test_driver_replay_matches_the_eager_driver(clip, case, monkeypatch):
    """SpeedEstimator.run through the stand-in graph (every frame from 1 on
    one call of it) against the eager driver, bit for bit: B, S[:, 2:],
    the track and reprojection history and the validity. ``rescue``: the
    matcher is asked on every frame pair in both runs; ``jump``: stage 2
    collapses at frame 6 only, right after a replayed frame that was not
    rescued, so the rescue must read that frame's state from the buffers
    the replay read it from, not from its overwritten outputs."""
    want_calls, got_calls = [], []
    est, reader, kw = _driver_case(case, clip, want_calls)
    want = est.run(reader, **kw)
    graphs = {}
    monkeypatch.setattr(speedest, "_captured_step", _replaying_step(graphs))
    est, reader, kw = _driver_case(case, clip, got_calls)
    got = est.run(reader, **kw)
    assert [g.replays for g in graphs.values()] == [N_FRAMES - 1]
    assert want_calls == got_calls == _rescued_pairs(case)
    _same_run(got, want)


def test_stills_replay_matches_the_eager_driver(burst, monkeypatch):
    """StillsSpeedEstimator.run through the stand-in graph against the
    eager stills driver, bit for bit: the lanes re-seeded and the structure
    rebuilt on the host between replays reach the next replay through its
    input buffers; both runs re-seed on the same stills."""
    runs = []
    for replay in (False, True):
        seeded, graphs = [], {}
        est = StillsSpeedEstimator(_stills_cfg(), device="cpu")
        replenish = est._replenish

        def counting(*args, **kwargs):
            out = replenish(*args, **kwargs)
            seeded.append(out[3])
            return out

        est._replenish = counting
        if replay:
            monkeypatch.setattr(speedest, "_captured_step", _replaying_step(graphs))
        runs.append((est.run(burst.stills(), annotation=burst.annotation, verbose=False),
                     seeded, graphs))
    (want, want_seeded, _), (got, got_seeded, graphs) = runs
    assert [g.replays for g in graphs.values()] == [N_FRAMES - 1]
    assert got_seeded == want_seeded and sum(want_seeded) > 0
    _same_run(got, want)


def test_forced_rescue_replay_matches_jax(clip, monkeypatch):
    """The driver through the stand-in graph with the rescue forced on
    every frame, against JAX's SpeedEstimator.run on the same clip, both
    rescued through the clip's known motion and the port handed JAX's RANSAC
    draws, at the tolerances of ``test_torch_speedest.py::
    test_forced_rescue_step_matches_jax``: tracked points within 1e-3 px
    where both are valid, >= 99% equal validity, every frame's translation
    within 1e-3 relative, the mean residual within 0.05 px."""
    from _torch_clip import _inject, _jax_gumbel_driver, _jax_reads_clip, _jcfg

    import velocity_tpu.ops.match as jax_match
    from velocity_tpu.pipeline.speedest import SpeedEstimator as JaxSpeedEstimator

    jax_calls, calls = [], []
    known = _known_motion(clip, jax_calls)
    monkeypatch.setattr(jax_match, "affine_from_feature_match",
                        lambda im_prev, im_cur, pts, valid, scale: known(im_prev, im_cur, pts,
                                                                         valid))
    want = JaxSpeedEstimator(_jcfg(min_affine_inliers=ALWAYS)).run(
        "synthetic.MOV", annotation=_jax_reads_clip(monkeypatch, clip), n_frames=N_FRAMES,
        verbose=False)
    _, draws = _jax_gumbel_driver(N_FRAMES)
    _inject(monkeypatch, draws)
    graphs = {}
    monkeypatch.setattr(speedest, "_captured_step", _replaying_step(graphs))
    got = SpeedEstimator(_cfg(min_affine_inliers=ALWAYS), device="cpu",
                         fallback_matcher=_known_motion(clip, calls)).run(
        clip.reader, annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    assert not draws
    assert [g.replays for g in graphs.values()] == [N_FRAMES - 1]
    assert calls == jax_calls == _rescued_pairs("rescue")
    assert (got.valid == want.valid).mean() >= 0.99
    both = got.valid & want.valid
    assert both[1:].sum(axis=1).min() > 40
    np.testing.assert_allclose(got.track_px[both], want.track_px[both], rtol=0, atol=1e-3)
    dt = np.linalg.norm(got.B[1:, 3:6] - want.B[1:, 3:6], axis=1)
    assert (dt <= 1e-3 * np.linalg.norm(want.B[1:, 3:6], axis=1)).all(), dt
    assert abs(got.residual_px - want.residual_px) <= 0.05


def test_drivers_step_eagerly_on_the_cpu(clip, monkeypatch):
    """On the CPU the drivers never reach the captured step: for CPU
    tensors ``_captured_step`` gives None, and a run on the CPU makes no
    call to ``step_graph._graph_step``."""

    def no_graph(*args, **kwargs):
        raise AssertionError("a driver on the CPU reached the captured step")

    monkeypatch.setattr(speedest, "_graph_step", no_graph)
    im = torch.zeros((HEIGHT, WIDTH), dtype=torch.uint8)
    assert speedest._captured_step(im, (), None, (), None, None, torch.float32) is None
    res = SpeedEstimator(_cfg(), device="cpu").run(clip.reader, annotation=clip.annotation,
                                                   n_frames=3, verbose=False)
    assert np.isfinite(res.B[:, 3:6]).all()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device: the frame "
                    "step's CUDA graph is captured and replayed only on a card")
def test_drivers_replay_the_captured_step_on_card(clip, burst, monkeypatch):
    """On the card each driver takes every frame from 1 on through one
    replay of the captured step: bit-equal to the eager driver (the step
    put back to the eager ``fused_frame_step_pyr``) plain, with the rescue
    forced, on the jump clip, and for the stills; one capture per
    configuration, its replays up by N_FRAMES - 1 a run; a failing capture
    raises."""
    step_graph.release_step_graphs()
    real = speedest._captured_step
    for case in ("plain", "rescue", "jump", "stills"):
        runs = []
        for captured in (False, True):
            monkeypatch.setattr(speedest, "_captured_step",
                                real if captured else lambda *args: None)
            before = {k: g.replays for k, g in step_graph.step_graphs().items()}
            calls = []
            if case == "stills":
                est = StillsSpeedEstimator(_stills_cfg(), device="cuda")
                runs.append(est.run(burst.stills(), annotation=burst.annotation, verbose=False))
            else:
                est, reader, kw = _driver_case(case, clip, calls, device="cuda")
                runs.append(est.run(reader, **kw))
            assert calls == _rescued_pairs(case)
            added = sorted(g.replays - before.get(k, 0)
                           for k, g in step_graph.step_graphs().items())
            assert added == [0] * (len(added) - captured) + [N_FRAMES - 1] * captured
        _same_run(runs[1], runs[0])

    step_graph.release_step_graphs()

    class Failing:
        def __init__(self, *args, **kwargs):
            raise RuntimeError("capture failed")

    monkeypatch.setattr(step_graph, "_StepGraph", Failing)
    with pytest.raises(RuntimeError, match="capture failed"):
        SpeedEstimator(_cfg(), device="cuda").run(clip.reader, annotation=clip.annotation,
                                                  n_frames=3, verbose=False)
