"""The port's scan path against the JAX package on one small synthetic clip
(CPU): the frame-0 init, one fused frame step from the same state, and the
whole ``ScanSpeedRunner.run``.

The clip is 270x480, 8 frames; the runs use msv_frame=3, 128 features and
64 RANSAC trials. The frame step and the run are compared with each of the
two LK backends that track this clip end to end, "lanes" (the default) and
"fast". RANSAC noise: the port is handed JAX's own Gumbel draws, so both
sample the same hypotheses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_clip import (N_FRAMES, SCALE, _cfg, _inject, _jax_gumbel, _jax_info,
                         _jax_reads_clip, _jcfg, make_clip)

from velocity_tpu.pipeline.roi import inside_bbox
from velocity_tpu.pipeline.scan import ScanSpeedRunner as JaxScanSpeedRunner
from velocity_tpu.pipeline.speedest import SpeedEstimator as JaxSpeedEstimator
from velocity_tpu.pipeline.tracker import frame_pyramids_jit as jax_frame_pyramids
from velocity_tpu.pipeline.tracker import fused_frame_step_pyr as jax_step
from velocity_tpu_torch.convert import state_from_numpy
from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
from velocity_tpu_torch.pipeline.speedest import _init_frame0, _init_geometry
from velocity_tpu_torch.pipeline.tracker import frame_pyramids, fused_frame_step_pyr

torch.set_num_threads(1)

BACKENDS = ["lanes", "fast"]


CFG, JCFG = _cfg(), _jcfg()


@pytest.fixture(scope="module")
def clip():
    return make_clip()


def test_frame0_init_matches_jax(clip):
    """The frame-0 state (``_init_frame0``): Harris + subpixel corners, the
    same set on valid lanes (order may differ on equal responses) within
    1e-3 px, and the solve's lanes those inside the plate box; plate solve
    and plane backprojection (host f64) within 1e-9 m, on the port's points
    and on JAX's; the pyramids those of the frame."""
    gray = clip.reader.grays[0]
    q = clip.annotation.q * SCALE
    est = JaxSpeedEstimator(JCFG)
    jp, jvalid, jboxa, jboxb = est._init_features(gray, q)
    f0, f0_pyr, f0_spyr = _init_frame0(CFG, clip.reader.info, torch.as_tensor(gray), q, SCALE)
    p, valid, boxa, boxb = f0.p, f0.valid, f0.boxa, f0.boxb
    assert (boxa, boxb) == (jboxa, jboxb)
    np.testing.assert_array_equal(f0.vp, valid & inside_bbox(p, boxa))
    np.testing.assert_array_equal(p[:4], jp[:4])
    assert valid.sum() == jvalid.sum() and valid.sum() > 40
    a, b = p[valid], jp[jvalid]
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=2)
    # each set lies within 1e-3 px of the other (refined corners may coincide)
    assert d.min(axis=1).max() < 1e-3 and d.min(axis=0).max() < 1e-3

    jt0, jp3, jres0 = est._init_geometry(_jax_info(clip), q, p, valid, SCALE)
    np.testing.assert_allclose(f0.t0, jt0, rtol=0, atol=1e-9)
    np.testing.assert_allclose(f0.p3, jp3, rtol=0, atol=1e-9)
    assert abs(f0.res0 - jres0) < 1e-6
    jt0, jp3, jres0 = est._init_geometry(_jax_info(clip), q, jp, jvalid, SCALE)
    t0, p3, res0 = _init_geometry(CFG, clip.reader.info, q, jp, jvalid, SCALE)
    np.testing.assert_allclose(t0, jt0, rtol=0, atol=1e-9)
    np.testing.assert_allclose(p3, jp3, rtol=0, atol=1e-9)
    assert abs(res0 - jres0) < 1e-6
    pyr, spyr = frame_pyramids(torch.as_tensor(gray), CFG.tracker)
    for a, b in zip((*f0_pyr, *f0_spyr), (*pyr, *spyr)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lk_backend", BACKENDS)
def test_frame_step_matches_jax(clip, monkeypatch, lk_backend):
    """One fused_frame_step_pyr from the JAX step's own inputs (carried over
    by state_from_numpy): tracked points within 1e-3 px where both are
    valid, >= 99% equal validity, the stage-3 affine within 1e-3 px where it
    maps the valid points (its translation column alone extrapolates to the
    image origin), the translation within 1e-3 relative and the residual
    within 0.05 px."""
    cfg, jcfg = _cfg(lk_backend), _jcfg(lk_backend)
    g0, g1 = clip.reader.grays[0], clip.reader.grays[1]
    q = clip.annotation.q * SCALE
    est = JaxSpeedEstimator(jcfg)
    p, valid, boxa, _ = est._init_features(g0, q)
    t0, p3, _ = est._init_geometry(_jax_info(clip), q, p, valid, SCALE)
    vp = valid & inside_bbox(p, boxa)
    intr = _jax_info(clip).intrinsics(scale=SCALE).astype(jnp.float32)
    pyr, spyr = jax_frame_pyramids(jnp.asarray(g0), jcfg.tracker)
    keys, draws = _jax_gumbel(2)
    _inject(monkeypatch, draws)

    want = jax_step(pyr, spyr, jnp.asarray(g1), jnp.asarray(p), jnp.asarray(valid),
                    jnp.asarray(vp), jnp.asarray(p3, jnp.float32), intr, keys[1],
                    jcfg.tracker, jcfg.solver, jnp.float32, jnp.asarray(t0, jnp.float32))
    st = state_from_numpy(pyr=pyr, spyr=spyr, pts=p, vg=valid, vp=vp, t=t0, p3=p3,
                          intr=intr, device="cpu")
    got = fused_frame_step_pyr(st["pyr"], st["spyr"], torch.as_tensor(g1), st["pts"],
                               st["vg"], st["vp"], st["p3"], st["intr"], None,
                               cfg.tracker, cfg.solver, torch.float32, st["t"])
    assert not draws
    (_, _, jpts, jvg, jvp, jt, jres, jproj, jn2, jT) = want[:10]
    (_, _, pts, vg, vp2, t, res, proj, n2, T) = got
    jvg = np.asarray(jvg)
    assert (vg.numpy() == jvg).mean() >= 0.99
    both = vg.numpy() & jvg
    np.testing.assert_allclose(pts.numpy()[both], np.asarray(jpts)[both], rtol=0, atol=1e-3)
    assert abs(int(n2) - int(jn2)) <= 1
    src = p[valid].astype(np.float64)

    def mapped(M):
        M = np.asarray(M, np.float64)
        return src @ M[:, :2].T + M[:, 2]

    np.testing.assert_allclose(mapped(T.numpy()), mapped(jT), rtol=0, atol=1e-3)
    assert np.linalg.norm(t.numpy() - np.asarray(jt)) <= 1e-3 * np.linalg.norm(np.asarray(jt))
    assert abs(float(res) - float(jres)) < 0.05


@pytest.mark.parametrize("lk_backend", BACKENDS)
def test_scan_run_matches_jax(clip, monkeypatch, lk_backend):
    """The whole ScanSpeedRunner.run, JAX on its own frames through a
    patched VideoReader, the port on the same clip with JAX's RANSAC noise:
    speed within 0.5%, per-frame translations within 1e-3 relative, mean
    residual within 0.05 px."""
    ann = clip.annotation
    want = JaxScanSpeedRunner(_jcfg(lk_backend)).run(
        "synthetic.MOV", annotation=_jax_reads_clip(monkeypatch, clip),
        n_frames=N_FRAMES, verbose=False)

    _, draws = _jax_gumbel(N_FRAMES)
    _inject(monkeypatch, draws)
    got = ScanSpeedRunner(_cfg(lk_backend), device="cpu").run(clip.reader, annotation=ann,
                                                  n_frames=N_FRAMES, verbose=False)
    assert not draws
    assert abs(got.speed_kmh - want.speed_kmh) <= 0.005 * want.speed_kmh
    dt = np.linalg.norm(got.B[1:, 3:6] - want.B[1:, 3:6], axis=1)
    assert (dt <= 1e-3 * np.linalg.norm(want.B[1:, 3:6], axis=1)).all(), dt
    assert abs(got.residual_px - want.residual_px) <= 0.05
    assert abs(got.speed_kmh - clip.speed_kmh) <= 0.15 * clip.speed_kmh
