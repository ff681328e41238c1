"""The port's stills burst driver against the JAX package (CPU), with the
car-anchored affine prior (``TrackerConfig.car_affine``) it forces.

First ``car_affine=True`` on the video clip of ``test_torch_slice.py`` (one
driver step, then ``SpeedEstimator.run``), then ``StillsSpeedEstimator.run``
on a sparse burst: the same synthetic scene seen through the stills camera
(stills focal, ``native_scale=1.0``), 8 stills, one every third instant of a
30 fps clip, the car at 40 km/h from 4 m. Every configuration here sets
``harris_quality=0.12``: the scene then has about 46 corners strong enough,
under half the 128 lanes, so ``_replenish`` re-seeds lanes from the MSV
frame on (as the tracks of a real burst decay) and re-seeded lanes are
promoted into the solve. 270x480, msv_frame 3, 64 RANSAC trials, f32
solver; the port is handed JAX's own RANSAC noise in the driver's order.

Steps that re-triangulate amplify 1e-6 differences (``ROADMAP.md`` §3), so
the first replenishment, the first promotion and the georegistration are
held tightly on JAX's own inputs, the runs loosely.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_clip import (HEIGHT, N_FRAMES, SCALE, WIDTH, _cfg, _inject, _jax_gumbel_driver,
                         _jax_info, _jax_reads_clip, _JaxStillsReader, _jcfg, make_clip)

import velocity_tpu.pipeline.datasets as jax_datasets
import velocity_tpu.pipeline.stills as jax_stills
from velocity_tpu.camera.annotations import Annotation as JaxAnnotation
from velocity_tpu.pipeline.roi import inside_bbox
from velocity_tpu.pipeline.speedest import SpeedEstimator as JaxSpeedEstimator
from velocity_tpu.pipeline.tracker import frame_pyramids_jit as jax_frame_pyramids
from velocity_tpu_torch.convert import state_from_numpy
from velocity_tpu_torch.ingest.stills import StillsReader
from velocity_tpu_torch.pipeline import SpeedEstimator, speedest
from velocity_tpu_torch.pipeline import stills as port_stills
from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator, open_stills
from velocity_tpu_torch.solvers.triangulate import nray_intercept_masked_np
from velocity_tpu_torch.testing.synthetic_clip import render_clip

torch.set_num_threads(1)

N_STILLS = 8
BURST = dict(speed_kmh=40.0, depth0_m=4.0, stride=3, filename="synthetic.JPG", native_scale=1.0)
TRACKER = dict(car_affine=True, harris_quality=0.12)


def _stills_cfg(jax=False):
    cfg = (_jcfg if jax else _cfg)(**TRACKER)
    return dataclasses.replace(cfg, native_scale=BURST["native_scale"])


@pytest.fixture(scope="module")
def clip():
    return make_clip()


@pytest.fixture(scope="module")
def burst():
    return render_clip(n_frames=N_STILLS, width=WIDTH, height=HEIGHT, seed=0, **BURST)


def _copy(a):
    return a.copy() if isinstance(a, np.ndarray) else a


def _record(mp, owner, name, calls, method=False):
    """Wrap ``owner.name`` to keep each call's (arguments, keywords, result),
    arrays copied at the call: the drivers write into theirs later."""
    real = getattr(owner, name)

    def wrapper(*args, **kwargs):
        kept = tuple(_copy(a) for a in args[1 if method else 0:])
        out = real(*args, **kwargs)
        calls.append((kept, kwargs, tuple(_copy(o) for o in out) if isinstance(out, tuple)
                      else out))
        return out

    mp.setattr(owner, name, wrapper)


@pytest.fixture(scope="module")
def jax_run(burst):
    """JAX's StillsSpeedEstimator.run on the burst (a twin of the synthetic
    reader in place of its StillsReader), with its replenishments (and the
    Harris output each one used), N-ray promotions and the B it
    georegistered recorded."""
    rec = {"replenish": [], "harris": [], "nray": [], "georegister": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_stills, "StillsReader", lambda *a, **k: _JaxStillsReader(burst.stills()))
        _record(mp, jax_stills.StillsSpeedEstimator, "_init_features", rec["harris"],
                method=True)
        real_replenish = jax_stills.StillsSpeedEstimator._replenish

        def replenish(self, *args, **kwargs):
            # the Harris pass a call made, if any: rec["harris"][first:]
            first = len(rec["harris"])
            kept = tuple(_copy(a) for a in args)
            out = real_replenish(self, *args, **kwargs)
            rec["replenish"].append((kept, kwargs, out, rec["harris"][first:]))
            return out

        mp.setattr(jax_stills.StillsSpeedEstimator, "_replenish", replenish)
        _record(mp, jax_stills, "nray_intercept_masked_np", rec["nray"])
        _record(mp, jax_stills, "georegister_track", rec["georegister"])
        a = burst.annotation
        res = jax_stills.StillsSpeedEstimator(_stills_cfg(jax=True)).run(
            ["synthetic_0000.JPG"], annotation=JaxAnnotation(a.q, a.fname, a.start_frame),
            verbose=False)
    return res, rec


@pytest.fixture(scope="module")
def port_run(burst):
    """The port's run on the same burst with JAX's noise, recorded alike."""
    rec = {"replenish": [], "promote": [], "nray": []}
    with pytest.MonkeyPatch.context() as mp:
        _, draws = _jax_gumbel_driver(N_STILLS)
        _inject(mp, draws)
        _record(mp, StillsSpeedEstimator, "_replenish", rec["replenish"], method=True)
        _record(mp, StillsSpeedEstimator, "_promote_pending", rec["promote"], method=True)
        _record(mp, port_stills, "nray_intercept_masked_np", rec["nray"])
        res = StillsSpeedEstimator(_stills_cfg(), device="cpu").run(
            burst.stills(), annotation=burst.annotation, verbose=False)
        assert not draws
    return res, rec


def test_car_affine_step_matches_jax(clip, monkeypatch):
    """One driver step (``_frame_step_with_fallback``) with car_affine=True
    from JAX's frame-0 state on the video clip: tracked points within 1e-3
    px where both are valid, >= 99% equal validity, the stage-3 affine
    within 1e-3 px over the valid points, the translation within 1e-3
    relative, the residual within 0.05 px."""
    cfg, jcfg = _cfg(**TRACKER), _jcfg(**TRACKER)
    g0, g1 = clip.reader.grays[0], clip.reader.grays[1]
    q = clip.annotation.q * SCALE
    est = JaxSpeedEstimator(jcfg)
    p, valid, boxa, _ = est._init_features(g0, q)
    t0, p3, _ = est._init_geometry(_jax_info(clip), q, p, valid, SCALE)
    vp = valid & inside_bbox(p, boxa)
    intr = _jax_info(clip).intrinsics(scale=SCALE).astype(jnp.float32)
    pyr, spyr = jax_frame_pyramids(jnp.asarray(g0), jcfg.tracker)
    keys, draws = _jax_gumbel_driver(2)
    _inject(monkeypatch, draws)
    want = est._frame_step_with_fallback(
        pyr, spyr, jnp.asarray(g1), jnp.asarray(p), jnp.asarray(valid), jnp.asarray(vp),
        jnp.asarray(p3, jnp.float32), intr, keys[1], jnp.float32, g0, g1,
        jnp.asarray(t0, jnp.float32))
    st = state_from_numpy(pyr=pyr, spyr=spyr, pts=p, vg=valid, vp=vp, t=t0, p3=p3,
                          intr=intr, device="cpu")
    got = SpeedEstimator(cfg, device="cpu")._frame_step_with_fallback(
        st["pyr"], st["spyr"], torch.as_tensor(g1), st["pts"], st["vg"], st["vp"], st["p3"],
        st["intr"], None, torch.float32, g0, g1, st["t"])
    assert not draws
    (_, _, jpts, jvg, _jvp, jt, jres, _jproj, jn2, jT) = want[:10]
    (_, _, pts, vg, _vp, t, res, _proj, n2, T) = got
    jvg = np.asarray(jvg)
    assert (vg.numpy() == jvg).mean() >= 0.99
    both = vg.numpy() & jvg
    assert both.sum() > 20
    np.testing.assert_allclose(pts.numpy()[both], np.asarray(jpts)[both], rtol=0, atol=1e-3)
    assert abs(int(n2) - int(jn2)) <= 1
    src = p[valid].astype(np.float64)

    def mapped(M):
        M = np.asarray(M, np.float64)
        return src @ M[:, :2].T + M[:, 2]

    np.testing.assert_allclose(mapped(T.numpy()), mapped(jT), rtol=0, atol=1e-3)
    assert np.linalg.norm(t.numpy() - np.asarray(jt)) <= 1e-3 * np.linalg.norm(np.asarray(jt))
    assert abs(float(res) - float(jres)) < 0.05


def test_car_affine_driver_run_matches_jax(clip, monkeypatch):
    """SpeedEstimator.run with car_affine=True against JAX's: speed within
    0.5%, per-frame translations within 1e-3 relative, mean residual within
    0.05 px, >= 99% equal validity, within 15% of the truth."""
    want = JaxSpeedEstimator(_jcfg(**TRACKER)).run(
        "synthetic.MOV", annotation=_jax_reads_clip(monkeypatch, clip),
        n_frames=N_FRAMES, verbose=False)
    _, draws = _jax_gumbel_driver(N_FRAMES)
    _inject(monkeypatch, draws)
    got = SpeedEstimator(_cfg(**TRACKER), device="cpu").run(
        clip.reader, annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    assert not draws
    assert abs(got.speed_kmh - want.speed_kmh) <= 0.005 * want.speed_kmh
    dt = np.linalg.norm(got.B[1:, 3:6] - want.B[1:, 3:6], axis=1)
    assert (dt <= 1e-3 * np.linalg.norm(want.B[1:, 3:6], axis=1)).all(), dt
    assert abs(got.residual_px - want.residual_px) <= 0.05
    assert (got.valid == want.valid).mean() >= 0.99
    assert abs(got.speed_kmh - clip.speed_kmh) <= 0.15 * clip.speed_kmh


def _reseeds(replenish_calls):
    return [call[2][3] for call in replenish_calls]


def test_stills_run_matches_jax(burst, jax_run, port_run):
    """The whole burst: both packages re-seed lanes (on the same frames) and
    promote some; the same live-lane counts; translations within 1e-3
    relative through the MSV frame; speed within 2% of JAX's and within 15%
    of the truth; capture times and GPS columns as the reader gave them."""
    (want, jrec), (got, rec) = jax_run, port_run
    msv = _stills_cfg().msv_frame
    assert _reseeds(rec["replenish"]) == _reseeds(jrec["replenish"])
    assert sum(_reseeds(rec["replenish"])) > 0
    promoted = sum(out[3] for _, _, out in rec["promote"])
    assert promoted > 0 and len(rec["nray"]) == len(jrec["nray"]) > 0
    np.testing.assert_array_equal(got.S[:, 2], want.S[:, 2])
    t, jt = got.B[1 : msv + 1, 3:6], want.B[1 : msv + 1, 3:6]
    assert (np.linalg.norm(t - jt, axis=1) <= 1e-3 * np.linalg.norm(jt, axis=1)).all()
    assert abs(got.speed_kmh - want.speed_kmh) <= 0.02 * want.speed_kmh
    assert abs(got.speed_kmh - burst.speed_kmh) <= 0.15 * burst.speed_kmh
    np.testing.assert_array_equal(got.B[:, 12:14], want.B[:, 12:14])
    np.testing.assert_allclose(np.diff(got.B[:, 12]), BURST["stride"] / 30.0, rtol=1e-9)
    assert got.first_gray is not None and got.last_gray is not None


def test_first_replenish_matches_jax_on_equal_inputs(jax_run, monkeypatch):
    """The first in-loop _replenish that re-seeded lanes, the port's on
    JAX's inputs and JAX's Harris output: the same lanes, points and
    structure (host f64, 1e-9). The port's own Harris on that still finds
    the same corners within 1e-3 px."""
    _, jrec = jax_run
    args, kwargs, want, harris = next(c for c in jrec["replenish"] if c[2][3] > 0)
    ((gray, q_now), _, detected), = harris
    monkeypatch.setattr(speedest, "_init_features", lambda cfg, g, q: detected)
    got = SpeedEstimator(_stills_cfg(), device="cpu")._replenish(*args, **kwargs)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert got[3] == want[3] > 0
    monkeypatch.undo()
    p, valid, _, _ = speedest._init_features(_stills_cfg(), torch.as_tensor(gray), q_now)
    a, b = p[valid], detected[0][detected[1]]
    assert len(a) == len(b)
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=2)
    assert d.min(axis=1).max() < 1e-3 and d.min(axis=0).max() < 1e-3


def test_first_promotion_matches_jax_on_equal_inputs(jax_run, port_run):
    """The first promotion's N-ray triangulation, the port's on JAX's inputs
    and depth band: the same accepted lanes and points (host f64, 1e-9);
    the port's own first promotion used a depth band within 1e-3 of JAX's."""
    (_, jrec), (_, rec) = jax_run, port_run
    args, kwargs, (jp3, jok) = jrec["nray"][0]
    p3, ok = nray_intercept_masked_np(*args, **kwargs)
    np.testing.assert_array_equal(ok, jok)
    assert (ok & args[3].any(axis=0)).any()
    np.testing.assert_allclose(p3[ok], jp3[jok], rtol=0, atol=1e-9)
    band, jband = rec["nray"][0][1]["depth_range"], kwargs["depth_range"]
    np.testing.assert_allclose(band, jband, rtol=1e-3)


def test_georegister_matches_jax_on_the_run(jax_run):
    """georegister_track on the B JAX's run georegistered: equal ECEF and
    LLA columns, equal returned tracks; the columns were filled."""
    want, jrec = jax_run
    ((B_in,), kwargs, (jcam, jcar)), = jrec["georegister"]
    B = B_in.copy()
    cam, car = port_stills.georegister_track(B, **kwargs)
    np.testing.assert_allclose(B, want.B, rtol=0, atol=1e-9)
    np.testing.assert_allclose(cam, jcam, rtol=0, atol=1e-9)
    np.testing.assert_allclose(car, jcar, rtol=0, atol=1e-9)
    assert np.all(B[:, 6:9] != 0) and kwargs["yaw_deg"] == pytest.approx(32.56)


def test_run_takes_still_paths(tmp_path, burst):
    """A list of paths opens the PIL/cv2 StillsReader, as JAX's run does;
    any object with the reader interface is used as it is."""
    from PIL import Image

    paths = [tmp_path / f"IMG_{i}.JPG" for i in range(2)]
    for p, g in zip(paths, burst.reader.grays):
        Image.fromarray(g).save(p, quality=95)
    reader = open_stills([str(p) for p in paths], "iPhone 6s")
    assert isinstance(reader, StillsReader) and reader.paths == [str(p) for p in paths]
    assert (reader.info.width, reader.info.height, reader.info.is_video) == (WIDTH, HEIGHT, False)
    (i, gray, llat), _ = list(reader.frames())
    assert i == 0 and gray.shape == (HEIGHT, WIDTH) and llat is None  # no EXIF written
    stills = burst.stills()
    assert open_stills(stills, "iPhone 6s") is stills


DATA = Path(jax_datasets.DATA)  # the reference dataset (not in the repository)
STILLS = sorted(DATA.glob("IMG_41[2-3][0-9].JPG"))
HAVE_DATA = len(STILLS) >= 6


@pytest.mark.slow
@pytest.mark.skipif(not HAVE_DATA, reason="reference stills not mounted")
class TestStillsEndToEnd:
    """Mirror of ``tests/test_stills_e2e.py::TestStillsEndToEnd``."""

    def test_burst_speed(self):
        from velocity_tpu_torch.config import PipelineConfig, SolverConfig

        cfg = PipelineConfig(native_scale=1.0, solver=SolverConfig(dtype="float32"))
        est = StillsSpeedEstimator(cfg, device="cuda" if torch.cuda.is_available() else "cpu")
        ann = Path(jax_datasets.MATLAB) / "IMG_4122.JPG.mat"
        res = est.run([str(p) for p in STILLS], annotation=str(ann), verbose=False)
        # GT ~= 40 km/h (vidExample.py:26); +/-10% band
        assert 36.0 < res.speed_kmh < 44.0, res.speed_kmh
        # the post-MSV pose solve runs from a populated car structure
        assert res.S[6:, 2].min() >= 50, res.S[:, 2]
        # georegistration filled the earth-frame columns
        assert np.any(res.B[:, 6:9] != 0)
