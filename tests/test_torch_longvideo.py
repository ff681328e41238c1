"""The port's long-video runner against the JAX package on a small synthetic
clip (CPU), its checkpoints, its decode thread, and the stitching units.

The clip: ``_torch_clip``'s scene, 25 frames of 480x270 (seed 0, 40 km/h),
msv_frame 3, 128 features, 64 RANSAC trials, f32 solver, segments on a
6-row grid with a BA overlap of 3. The stage-3 forward-backward gate is
tightened to 0.05 px so that tracks die as the car recedes (at the default
0.3 px every lane lives through 25 frames): the lanes drop below half the
capacity by row 12, which replenishes, and the replenished lanes are
promoted at rows 18 and 24, in both packages. JAX's segments have 3 and 6
rows (two scan compiles); it runs once per file, recording the inputs of
its first promotion, refresh and replenishment and of its BA refinement.

RANSAC: JAX draws row r from ``split(PRNGKey(0), n)[r]``; the port draws
row r from a generator seeded r, and the tests hand it JAX's draws by row
(a retried row gets its draws again).
"""

import contextlib
import copy
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_clip import SCALE, _cfg, _frame_draws, _jax_reads_clip, _jcfg

import velocity_tpu.parallel.checkpoint as jax_checkpoint
import velocity_tpu.pipeline.datasets as jax_datasets
import velocity_tpu.pipeline.longvideo as jax_longvideo
import velocity_tpu.solvers.triangulate as jax_triangulate
import velocity_tpu_torch.pipeline.longvideo as lv
from velocity_tpu_torch.parallel.checkpoint import WindowState, load_state, save_state
from velocity_tpu_torch.parallel.windows import align_overlap, split_windows, stitch_windows
from velocity_tpu_torch.pipeline import tracker as port_tracker
from velocity_tpu_torch.pipeline.longvideo import LongVideoRunner
from velocity_tpu_torch.pipeline.scan import FrameStream
from velocity_tpu_torch.testing.synthetic_clip import render_clip

torch.set_num_threads(1)

N_FRAMES, CUT, WINDOW, OVERLAP = 25, 16, 6, 3
FIRST_BOUNDARY = WINDOW  # the first grid boundary after the MSV frame (3)
TRACKER = dict(fb_threshold_fine=0.05)
RUN_KW = dict(window=WINDOW, overlap=OVERLAP, ba_refine=True, verbose=False)


@pytest.fixture(scope="module")
def clip():
    return render_clip(n_frames=N_FRAMES, width=480, height=270, seed=0)


def _draws_by_row(n):
    """JAX's RANSAC noise of each row r of an n-row run: the two draws of
    the frame step with key split(PRNGKey(0), n)[r]."""
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return {r: _frame_draws(keys[r]) for r in range(1, n)}


def _inject_rows(mp, draws):
    """Hand the port's RANSAC the noise of the row its generator is seeded
    with: a row's first call gets stage 1's draw, its second stage 2's (a
    retried row starts again)."""
    real = port_tracker.estimate_affine_ransac
    calls = {}

    def ransac_with_row_noise(*args, **kwargs):
        row = kwargs["generator"].initial_seed()
        k = calls.get(row, 0)
        calls[row] = k + 1
        kwargs["gumbel"] = draws[row][k % 2]
        return real(*args, **kwargs)

    mp.setattr(port_tracker, "estimate_affine_ransac", ransac_with_row_noise)
    return calls


def _events(log: str):
    """{kind: [(row, count), ...]} from a runner's verbose lines."""
    out = {"promoted": [], "refreshed": [], "replenished": []}
    for line in log.splitlines():
        if line.startswith("[window @"):
            row = int(line[len("[window @"):line.index("]")])
            for kind in out:
                if f"] {kind}" in line:
                    words = line.split(f"] {kind} ")[1].split()
                    n = int(words[2] if kind == "refreshed" else words[0])
                    out[kind].append((row, n))
    return out


@pytest.fixture(scope="module")
def jax_run(clip):
    """JAX's LongVideoRunner on the clip, verbose, with the inputs of every
    N-ray triangulation (the caller's promotion or refresh state),
    replenishment and BA refinement recorded."""
    mp = pytest.MonkeyPatch()
    rec = {"nray": [], "replenish": [], "ba": []}
    real_nray = jax_triangulate.nray_intercept_masked_np

    def recording_nray(*args, **kwargs):
        caller = sys._getframe(1).f_locals
        state = {k: copy.deepcopy(caller[k]) for k in
                 ("i", "p3h", "vp_np", "pending", "B", "track_px", "valid_hist")}
        out = real_nray(*args, **kwargs)
        rec["nray"].append(("refresh" if "min_obs" in kwargs else "promote", state,
                            tuple(np.array(o) for o in out)))
        return out

    real_repl = jax_longvideo.LongVideoRunner._replenish

    def recording_replenish(self, *args):
        out = real_repl(self, *args)
        rec["replenish"].append((copy.deepcopy(args), copy.deepcopy(out)))
        return out

    real_ba = jax_longvideo.LongVideoRunner._ba_refine

    def recording_ba(self, track_px, valid_hist, B, ba_meta, intr, mesh, verbose, overlap=1):
        args = copy.deepcopy((track_px, valid_hist, B, ba_meta, overlap))
        out = real_ba(self, track_px, valid_hist, B, ba_meta, intr, mesh, verbose,
                      overlap=overlap)
        rec["ba"].append((args, B.copy()))
        return out

    mp.setattr(jax_triangulate, "nray_intercept_masked_np", recording_nray)
    mp.setattr(jax_longvideo.LongVideoRunner, "_replenish", recording_replenish)
    mp.setattr(jax_longvideo.LongVideoRunner, "_ba_refine", recording_ba)
    log = io.StringIO()
    try:
        ann = _jax_reads_clip(mp, clip)
        with contextlib.redirect_stdout(log):
            res = jax_longvideo.LongVideoRunner(_jcfg(**TRACKER)).run(
                "synthetic.MOV", annotation=ann, **dict(RUN_KW, verbose=True))
    finally:
        mp.undo()
    return res, _events(log.getvalue()), rec


def _port_run(clip, n=N_FRAMES, **kw):
    """The port's runner on the CPU with JAX's draws by row; returns
    (result, events)."""
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        _inject_rows(mp, _draws_by_row(N_FRAMES))
        with contextlib.redirect_stdout(log):
            res = LongVideoRunner(_cfg(**TRACKER), device="cpu").run(
                clip.reader, annotation=clip.annotation, n_frames=n,
                **dict(RUN_KW, verbose=True, **kw))
    return res, _events(log.getvalue())


@pytest.fixture(scope="module")
def port_run(clip):
    return _port_run(clip)


def _speed(B, rows):
    d = np.linalg.norm(np.diff(B[rows[0] - 1 : rows[-1] + 1, 0:3], axis=0), axis=1)
    return float(np.mean(d / np.diff(B[rows[0] - 1 : rows[-1] + 1, 12]) * 3.6))


# ------------------------------------------------------------------ run level


def test_run_matches_jax(jax_run, port_run):
    """Through the MSV frame and the first boundary (rows 0..6) the runs
    agree tightly: speed within 0.5%, translations within 1e-3 relative,
    equal validity on >= 99% of the history. After it they are held
    loosely: the refresh at row 6 re-triangulates the structure from the
    tracks (ROADMAP section 3: re-triangulation turns track differences of
    1e-4 px into centimetres), so the mean speed is held within 2% and each
    row's translation within 2% of its distance from frame 0. Both
    packages refresh at every boundary from 6 on, replenish at 12 and
    promote at 18, and the refreshed and promoted counts agree within 10%."""
    want, want_ev, _ = jax_run
    got, got_ev = port_run
    assert got.S.shape == want.S.shape == (N_FRAMES, 9)
    np.testing.assert_array_equal(got.B[:, 12:14], want.B[:, 12:14])
    tight = list(range(1, FIRST_BOUNDARY + 1))
    assert abs(_speed(got.B, tight) - _speed(want.B, tight)) <= 0.005 * _speed(want.B, tight)
    dt = np.linalg.norm(got.B[tight, 3:6] - want.B[tight, 3:6], axis=1)
    assert (dt <= 1e-3 * np.linalg.norm(want.B[tight, 3:6], axis=1)).all(), dt
    assert (got.valid[: FIRST_BOUNDARY + 1] == want.valid[: FIRST_BOUNDARY + 1]).mean() >= 0.99
    assert abs(got.speed_kmh - want.speed_kmh) <= 0.02 * want.speed_kmh
    dl = np.linalg.norm(got.B[1:, 3:6] - want.B[1:, 3:6], axis=1)
    assert (dl <= 0.02 * np.linalg.norm(want.B[1:, 3:6], axis=1)).all(), dl
    for kind in ("refreshed", "replenished", "promoted"):
        g, w = got_ev[kind], want_ev[kind]
        assert [r for r, _ in g] == [r for r, _ in w] and w, (kind, g, w)
        for (_, a), (_, b) in zip(g, w):
            assert abs(a - b) <= max(1, 0.1 * b), (kind, g, w)
    assert got.timings["replenished_frames"] == len(got_ev["replenished"]) >= 1
    assert got.timings["promoted"] == sum(k for _, k in got_ev["promoted"]) >= 1
    assert got.timings["refreshed"] == sum(k for _, k in got_ev["refreshed"]) >= 1
    assert got.timings["ba_refined"] and got.timings["ba_windows"] == 5


def _jax_state(rec, kind):
    return next((s, out) for k, s, out in rec["nray"] if k == kind)


def test_first_refresh_matches_jax_on_equal_inputs(jax_run):
    """The port's refresh at JAX's first refreshing boundary, on JAX's
    state there: the same lanes refreshed, their structure within 1e-9."""
    _, _, rec = jax_run
    s, (p3_tri, okt) = _jax_state(rec, "refresh")
    runner = LongVideoRunner(_cfg(**TRACKER), device="cpu")
    got, k = runner._refresh(_intr_np(), s["track_px"], s["B"], s["valid_hist"], s["p3h"],
                             s["vp_np"], s["i"], WINDOW)
    want = s["vp_np"] & okt
    want[:4] = False
    assert k == int(want.sum()) > 0
    np.testing.assert_allclose(got[want], p3_tri[want], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got[~want], s["p3h"][~want])


def test_first_promotion_matches_jax_on_equal_inputs(jax_run):
    """The port's promotion at JAX's first promoting boundary, on JAX's
    state there: the same lanes join the solve, their structure within
    1e-9, the rest stay pending."""
    _, _, rec = jax_run
    s, (p3_tri, okt) = _jax_state(rec, "promote")
    runner = LongVideoRunner(_cfg(**TRACKER), device="cpu")
    p3, vp, pending, k = runner._promote(_intr_np(), s["track_px"], s["B"], s["valid_hist"],
                                         s["pending"], s["p3h"], s["vp_np"], s["i"], WINDOW)
    promote = s["pending"] & okt
    assert k == int(promote.sum()) > 0
    np.testing.assert_allclose(p3[promote], p3_tri[promote], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(vp, s["vp_np"] | promote)
    np.testing.assert_array_equal(pending, s["pending"] & ~promote)


def _intr():
    """The clip's f32 intrinsics at the run's scale, as the runner holds them."""
    info = render_clip(n_frames=2, width=480, height=270, seed=0).reader.info
    return info.intrinsics(scale=SCALE).to(dtype=torch.float32)


def _intr_np():
    return tuple(float(v) for v in _intr()[:4])


def test_first_replenish_matches_jax_on_equal_inputs(jax_run):
    """The port's replenishment on JAX's inputs at its first replenishing
    boundary: the same lanes re-seeded, their points within 1e-3 px (the
    port's own Harris and subpixel refinement) and their plane structure
    within 1e-3 relative; the live lanes unchanged."""
    _, _, rec = jax_run
    args, want = next((a, out) for a, out in rec["replenish"] if out[3] > 0)
    gray, q, pts, vg, p3, t_abs, intr_np = args
    runner = LongVideoRunner(_cfg(**TRACKER), device="cpu")
    got = runner._replenish(gray, q, pts, vg, p3, t_abs, intr_np)
    assert got[3] == want[3] > 0
    np.testing.assert_array_equal(got[1], want[1])
    new = want[1] & ~vg
    np.testing.assert_allclose(got[0][new], want[0][new], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[2][new], want[2][new], rtol=1e-3,
                               atol=1e-3 * np.abs(want[2][new]).max())
    np.testing.assert_array_equal(got[0][vg], pts[vg])


def test_ba_refine_matches_jax_on_equal_inputs(jax_run):
    """The port's BA refinement (windowed_ba over a 1 x 1 mesh, f32, the
    acceptance guard and the chain stitch) on JAX's inputs: the same
    windows accepted and the stitched trajectory within 1e-4 relative of
    JAX's (f32 solves, sums in another order)."""
    _, _, rec = jax_run
    (track_px, valid_hist, B, ba_meta, overlap), want_B = rec["ba"][0]
    runner = LongVideoRunner(_cfg(**TRACKER), device="cpu")
    intr = _intr()
    got_B = B.copy()
    out = runner._ba_refine(track_px, valid_hist, got_B, ba_meta, intr, None, False,
                            overlap=overlap)
    assert out["ba_windows"] == len(ba_meta)
    scale = np.abs(want_B[:, 0:3]).max()
    np.testing.assert_allclose(got_B[:, 0:6], want_B[:, 0:6], rtol=0, atol=1e-4 * scale)
    assert not np.array_equal(want_B[:, 3:6], B[:, 3:6])  # the refinement moved the track


def test_resume_matches_uninterrupted(clip, tmp_path):
    """A run cut at 16 frames with a checkpoint (row 15, off the 6-row
    grid), then resumed to 25 frames, follows the uninterrupted run: the
    trajectory within 2.5e-2 m and the speed within 0.3 km/h (JAX's
    tolerances; the boundary state crosses f32 -> f64 -> f32). Without BA
    refinement, as in JAX's test: a resumed run's refinement windows are its
    segments, which the cut splits."""
    full, _ = _port_run(clip, ba_refine=False)
    ck = tmp_path / "state.npz"
    _port_run(clip, n=CUT, checkpoint=ck, ba_refine=False)
    st = load_state(ck)
    assert st.frame_index == CUT - 1 and st.ba_bounds[-1].tolist() == [12, CUT - 1]
    resumed, _ = _port_run(clip, checkpoint=ck, resume=True, ba_refine=False)
    err = np.abs(resumed.B[:, 0:3] - full.B[:, 0:3]).max()
    print(f"resume: max trajectory difference {err:.3e} m, speed "
          f"{resumed.speed_kmh - full.speed_kmh:+.3e} km/h")
    assert err <= 2.5e-2
    assert abs(resumed.speed_kmh - full.speed_kmh) < 0.3
    np.testing.assert_array_equal(resumed.B[:, 12:14], full.B[:, 12:14])


def test_failed_segment_is_retried_once(clip, port_run, monkeypatch):
    """scan_segment raising at the second segment costs nothing: the
    segment is retried from the host copies of the boundary state (and
    draws its rows again), within 2.5e-2 m and 0.3 km/h of the clean run,
    the retry counted. A segment that fails twice raises."""
    clean, _ = port_run
    real = lv.scan_segment
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected transient device failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(lv, "scan_segment", flaky)
    recovered, _ = _port_run(clip)
    assert calls["n"] == 6  # five segments, the second one twice
    err = np.abs(recovered.B[:, 0:3] - clean.B[:, 0:3]).max()
    print(f"retry: max trajectory difference {err:.3e} m, speed "
          f"{recovered.speed_kmh - clean.speed_kmh:+.3e} km/h")
    assert recovered.timings["retries"] == 1 and clean.timings["retries"] == 0
    assert err <= 2.5e-2
    assert abs(recovered.speed_kmh - clean.speed_kmh) < 0.3

    def broken(*args, **kwargs):
        calls["n"] += 1
        raise RuntimeError("persistent device failure")

    monkeypatch.setattr(lv, "scan_segment", broken)
    calls["n"] = 0
    with pytest.raises(RuntimeError, match="persistent"):
        LongVideoRunner(_cfg(**TRACKER), device="cpu").run(
            clip.reader, annotation=clip.annotation, n_frames=8, **RUN_KW)
    assert calls["n"] == 2


def test_runner_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LongVideoRunner()


# ------------------------------------------------------------ decode thread


def test_frame_stream_decodes_ahead(clip):
    """FrameStream hands out every frame of the range in order, on the
    device asked for, with its time and index; the host copies stay."""
    stream = FrameStream(clip.reader, 2, 5, 2, "cpu")
    try:
        got = [stream.wait(i) for i in range(5)]
        stream.join()
    finally:
        stream.close()
    want = list(clip.reader.frames(start=2, count=5, step=2))
    for g, h, w in zip(got, stream.grays, want, strict=True):
        assert g.dtype == torch.uint8 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w.gray)
        np.testing.assert_array_equal(h, w.gray)
    np.testing.assert_array_equal(stream.times, [w.time_s for w in want])
    np.testing.assert_array_equal(stream.indices, [w.index for w in want])
    assert stream.decode_s > 0 and stream.wait_s >= 0


def test_frame_stream_raises_what_decode_raised(clip):
    """A reader that fails mid-clip: frames before the failure are served,
    the failure is raised by wait() and join(); a clip that ends early
    raises for the missing frame."""

    class Failing:
        def frames(self, start, count, step):
            yield from clip.reader.frames(start=start, count=2, step=step)
            raise OSError("corrupt frame")

    stream = FrameStream(Failing(), 0, 4, 1, "cpu")
    with pytest.raises(OSError, match="corrupt"):
        stream.wait(3)
    with pytest.raises(OSError, match="corrupt"):
        stream.join()
    short = FrameStream(clip.reader, N_FRAMES - 2, 4, 1, "cpu")
    short.wait(1)
    with pytest.raises(RuntimeError, match="decode ended before frame 2"):
        short.wait(2)
    short.close()


# --------------------------------------------------------------- checkpoint


def _state():
    rng = np.random.default_rng(0)
    return WindowState(
        frame_index=42, points=rng.random((8, 2)).astype(np.float32),
        valid=np.array([True] * 6 + [False] * 2), valid_pose=np.array([True] * 4 + [False] * 4),
        p3=rng.random((8, 3)), B=rng.random((5, 14)), S=rng.random((5, 9)),
        track_px=rng.random((5, 8, 2)).astype(np.float32), valid_hist=rng.random((5, 8)) > 0.5,
        boxes=np.arange(8).reshape(2, 4), ba_bounds=np.array([[0, 3], [3, 4]]),
        ba_p3=rng.random((2, 8, 3)), ba_repl=rng.random((2, 8)) > 0.5,
        repl_next=rng.random(8) > 0.5, pending=rng.random(8) > 0.5,
        meta={"video": "IMG_4134.MOV", "start": "19"})


def _assert_same_state(a, b):
    assert a.frame_index == b.frame_index and a.meta == b.meta
    for name in ("points", "valid", "valid_pose", "p3", "B", "S", "track_px", "valid_hist",
                 "boxes", "ba_bounds", "ba_p3", "ba_repl", "repl_next", "pending"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_checkpoint_roundtrip(tmp_path):
    """Mirror of ``tests/test_aux.py::TestCheckpoint::test_roundtrip``, with
    every optional field."""
    st = _state()
    save_state(tmp_path / "w.npz", st)
    st2 = load_state(tmp_path / "w.npz")
    assert st2.frame_index == 42 and st2.meta["video"] == "IMG_4134.MOV"
    _assert_same_state(st2, st)
    bare = WindowState(frame_index=1, points=st.points, valid=st.valid,
                       valid_pose=st.valid_pose, p3=st.p3, B=st.B, S=st.S)
    save_state(tmp_path / "bare.npz", bare)
    assert load_state(tmp_path / "bare.npz").track_px is None


def test_checkpoint_files_cross_packages(tmp_path):
    """A checkpoint JAX writes loads in the port, and the reverse."""
    st = _state()
    jst = jax_checkpoint.WindowState(**vars(st))
    jax_checkpoint.save_state(tmp_path / "jax.npz", jst)
    _assert_same_state(load_state(tmp_path / "jax.npz"), st)
    save_state(tmp_path / "port.npz", st)
    _assert_same_state(jax_checkpoint.load_state(tmp_path / "port.npz"), st)


# ---------------------------------------------------------------- stitching


class TestStitchGauge:
    """Mirror of ``tests/test_longvideo.py::TestStitchGauge``."""

    def test_translation_chain(self):
        g = np.stack([np.linspace(0, 10, 11), np.zeros(11), np.zeros(11)], 1)
        w0 = g[:6] - g[0]
        w1 = g[5:11] - g[5]
        out = stitch_windows(np.stack([w0, w1]), overlap=1, gauge="translation")
        np.testing.assert_allclose(out, g - g[0], atol=1e-12)

    def test_similarity_recovers_rotation_and_scale(self):
        rng = np.random.default_rng(0)
        g = np.cumsum(rng.uniform(0.5, 1.0, (13, 3)), axis=0)
        w0 = g[0:8] - g[0]
        th = 0.3
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
        s = 1.7
        w1 = (R.T @ ((g[5:13] - g[5]).T / s)).T  # local = s^-1 R^-1 global
        out = stitch_windows(np.stack([w0, w1]), overlap=3, gauge="similarity")
        np.testing.assert_allclose(out, g - g[0], atol=1e-9)

    def test_align_overlap_recovers_similarity(self):
        rng = np.random.default_rng(1)
        g = np.cumsum(rng.uniform(0.3, 1.0, (6, 3)), axis=0)
        th = -0.2
        R = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0], [np.sin(th), 0, np.cos(th)]])
        s = 0.8
        local = (R.T @ (g.T / s)).T
        Rf, sf, tf = align_overlap(local[:4], g[:4])
        np.testing.assert_allclose(sf * (Rf @ local.T).T + tf, g, atol=1e-9)
        # a collinear overlap falls back to translation
        line = np.stack([np.arange(4.0), np.zeros(4), np.zeros(4)], 1)
        Rf2, sf2, _ = align_overlap(line, line + [0, 1, 0])
        np.testing.assert_allclose(Rf2, np.eye(3), atol=1e-12)
        assert sf2 == 1.0

    def test_split_windows_cover(self):
        w = split_windows(201, 24, 3)
        assert w[0][0] == 0 and w[-1][1] == 201
        for (s0, e0), (s1, e1) in zip(w, w[1:]):
            assert s1 == e0 - 3


# ------------------------------------------------- gated (reference data)

HAVE_DATA = (Path(jax_datasets.DATA) / "IMG_4119.MOV").exists()
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def _known_run():
    return jax_datasets.known_run("IMG_4119")


@pytest.mark.slow
@pytest.mark.skipif(not HAVE_DATA, reason="reference dataset not mounted")
class TestLongVideoResume:
    """Mirror of ``tests/test_longvideo.py::TestLongVideoResume``."""

    def test_resume_matches_uninterrupted(self, tmp_path):
        from velocity_tpu_torch.config import PipelineConfig, SolverConfig

        run = _known_run()
        cfg = PipelineConfig(solver=SolverConfig(dtype="float32"))
        kw = dict(annotation=run.annotation, start_frame=run.start_frame, window=6,
                  overlap=2, ba_refine=False, verbose=False)
        ck = tmp_path / "state.npz"
        full = LongVideoRunner(cfg, DEVICE).run(run.video, n_frames=14, **kw)
        LongVideoRunner(cfg, DEVICE).run(run.video, n_frames=10, checkpoint=ck, **kw)
        assert ck.exists()
        resumed = LongVideoRunner(cfg, DEVICE).run(run.video, n_frames=14, checkpoint=ck,
                                                   resume=True, **kw)
        np.testing.assert_allclose(resumed.B[:, 0:3], full.B[:, 0:3], atol=2.5e-2)
        assert abs(resumed.speed_kmh - full.speed_kmh) < 0.3


@pytest.mark.slow
@pytest.mark.skipif(not HAVE_DATA, reason="reference dataset not mounted")
class TestLongVideoFullLength:
    """Mirror of ``tests/test_longvideo.py::TestLongVideoFullLength``."""

    def test_full_4119(self):
        from velocity_tpu_torch.config import PipelineConfig, SolverConfig

        run = _known_run()
        res = LongVideoRunner(PipelineConfig(solver=SolverConfig(dtype="float32")),
                              DEVICE).run(run.video, annotation=run.annotation,
                                          start_frame=run.start_frame, n_frames=None,
                                          window=24, overlap=3, ba_refine=True, verbose=False)
        assert res.S.shape[0] == 160
        assert 17.0 < res.speed_kmh < 24.0, res.speed_kmh
        assert abs(float(res.S[1:20, 8].mean()) - 18.74) < 1.0
        assert np.isfinite(res.S[1:, 8]).all()


@pytest.mark.slow
@pytest.mark.skipif(not HAVE_DATA, reason="reference dataset not mounted")
class TestWindowFaultRecovery:
    """Mirror of ``tests/test_longvideo.py::TestWindowFaultRecovery``."""

    def test_transient_segment_failure_recovers_identically(self, monkeypatch):
        from velocity_tpu_torch.config import PipelineConfig, SolverConfig

        run = _known_run()
        cfg = PipelineConfig(solver=SolverConfig(dtype="float32"))
        kw = dict(annotation=run.annotation, start_frame=run.start_frame, n_frames=14,
                  window=6, overlap=2, ba_refine=False, verbose=False)
        clean = LongVideoRunner(cfg, DEVICE).run(run.video, **kw)
        real, calls = lv.scan_segment, {"n": 0}

        def flaky(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected transient device failure")
            return real(*args, **kwargs)

        monkeypatch.setattr(lv, "scan_segment", flaky)
        recovered = LongVideoRunner(cfg, DEVICE).run(run.video, **kw)
        assert calls["n"] >= 3
        np.testing.assert_allclose(recovered.B[:, 0:3], clean.B[:, 0:3], atol=2.5e-2)
        assert abs(recovered.speed_kmh - clean.speed_kmh) < 0.3

