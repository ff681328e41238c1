"""The port's scan runner on the two paths that leave its batch loop,
against the JAX package on the small synthetic clip (CPU): the feature-match
rescue (``lk_backend="reference"``, whose stage 2 collapses on this clip, so
both packages run the clip again through their per-frame drivers) and the
bundle-adjustment re-anchor (``anchor="ba"``).

Clip, sizes and configuration as in ``test_torch_slice.py``; the port is
handed JAX's own RANSAC noise, in the scan runner's order and then, for the
re-run, in the driver's.
"""

import numpy as np
import pytest
import torch
from _torch_clip import (MSV, N_FRAMES, SCALE, _cfg, _inject, _jax_gumbel, _jax_gumbel_driver,
                         _jax_reads_clip, _jcfg, make_clip)

import velocity_tpu.ops.match as jax_match
import velocity_tpu.pipeline.anchor as jax_anchor
from velocity_tpu.pipeline.scan import ScanSpeedRunner as JaxScanSpeedRunner
from velocity_tpu_torch.ops import match as port_match
from velocity_tpu_torch.pipeline import anchor as port_anchor
from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clip():
    return make_clip()


def _record(monkeypatch, module, name):
    """Wrap ``module.name`` to keep each call's (arguments, keywords, result);
    arrays are copied at the call, since the runners write into theirs later."""
    real = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        kept = tuple(a.copy() if isinstance(a, np.ndarray) else a for a in args)
        out = real(*args, **kwargs)
        calls.append((kept, kwargs, out))
        return out

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_scan_reference_backend_runs_through_the_rescue(clip, monkeypatch):
    """ScanSpeedRunner.run with the gather LK engine: stage 2 collapses at
    one frame in both packages, both run the clip again through the driver,
    whose rescue calls the cv2 matcher once, on the same frame pair, and gets
    the same affine. Up to the re-anchor frame the translations agree within
    1e-3 relative. The MSV re-anchor then amplifies the 1e-4 px differences
    of the tracks (all 128 lanes survive with this engine, poorly tracked
    background lanes included) into decimetres of structure: the port's
    re-anchor is held to JAX's on JAX's own inputs (1e-6), and the runs from
    there on to 5% in each frame's distance and 2% in the final distance and
    the run's speed."""
    jcalls = _record(monkeypatch, jax_match, "affine_from_feature_match")
    janchor = _record(monkeypatch, jax_anchor, "reanchor")
    want = JaxScanSpeedRunner(_jcfg("reference")).run(
        "synthetic.MOV", annotation=_jax_reads_clip(monkeypatch, clip), n_frames=N_FRAMES,
        verbose=False)
    draws = _jax_gumbel(N_FRAMES)[1] + _jax_gumbel_driver(N_FRAMES)[1]
    _inject(monkeypatch, draws)
    calls = _record(monkeypatch, port_match, "affine_from_feature_match")
    got = ScanSpeedRunner(_cfg("reference"), device="cpu").run(
        clip.reader, annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    assert not draws  # the scan pass and the driver's re-run both drew
    assert len(calls) == len(jcalls) == 1
    (jim1, jim2, *_), _, jM = jcalls[0]
    (im1, im2, *_), _, M = calls[0]
    np.testing.assert_array_equal(im1, jim1)
    np.testing.assert_array_equal(im2, jim2)
    np.testing.assert_array_equal(M, jM)
    assert got.first_gray is None and got.last_gray is None  # the driver's result

    jt, t = want.B[1:, 3:6], got.B[1:, 3:6]
    rel = np.linalg.norm(t - jt, axis=1) / np.linalg.norm(jt, axis=1)
    assert (rel[:MSV] <= 1e-3).all(), rel
    (_c, _cam, scale, track_px, vg, B, t_cur, p3), kwargs, (jp3, jt_abs, jres) = janchor[-1]
    p3_new, t_abs, res_new = port_anchor.reanchor(
        _cfg("reference"), clip.reader.info, scale, track_px, vg, B, t_cur,
        np.array(p3), q=kwargs["q"])
    np.testing.assert_allclose(p3_new, jp3, rtol=0, atol=1e-6 * np.abs(jp3).max())
    np.testing.assert_allclose(t_abs, jt_abs, rtol=0, atol=1e-6 * np.abs(jt_abs).max())
    np.testing.assert_allclose(res_new, jres, rtol=0, atol=1e-6)
    dist, jdist = got.S[1:, 7], want.S[1:, 7]
    assert (np.abs(dist - jdist) <= 0.05 * jdist).all()
    assert abs(dist[-1] - jdist[-1]) <= 0.02 * jdist[-1]
    assert abs(got.speed_kmh - want.speed_kmh) <= 0.02 * want.speed_kmh
    assert abs(got.speed_kmh - clip.speed_kmh) <= 0.15 * clip.speed_kmh


def test_scan_anchor_ba_matches_jax(clip, monkeypatch):
    """ScanSpeedRunner.run with anchor="ba": the port's re-anchor on the JAX
    run's own inputs gives the structure and the camera track within 1e-6
    relative (host f64 on both sides, translation-only cameras: the rpy
    columns stay exactly zero); the whole run's speed within 0.5%,
    translations within 1e-3 relative, mean residual within 0.05 px."""
    jcalls = _record(monkeypatch, jax_anchor, "reanchor")
    want = JaxScanSpeedRunner(_jcfg(anchor="ba")).run(
        "synthetic.MOV", annotation=_jax_reads_clip(monkeypatch, clip), n_frames=N_FRAMES,
        verbose=False)
    _, draws = _jax_gumbel(N_FRAMES)
    _inject(monkeypatch, draws)
    got = ScanSpeedRunner(_cfg(anchor="ba"), device="cpu").run(
        clip.reader, annotation=clip.annotation, n_frames=N_FRAMES, verbose=False)
    assert not draws
    assert abs(got.speed_kmh - want.speed_kmh) <= 0.005 * want.speed_kmh
    dt = np.linalg.norm(got.B[1:, 3:6] - want.B[1:, 3:6], axis=1)
    assert (dt <= 1e-3 * np.linalg.norm(want.B[1:, 3:6], axis=1)).all(), dt
    assert abs(got.residual_px - want.residual_px) <= 0.05
    assert abs(got.speed_kmh - clip.speed_kmh) <= 0.15 * clip.speed_kmh

    (_jcfg_, _cam, scale, track_px, vg, B, t_cur, p3), kwargs, (jp3, jt_abs, jres) = jcalls[0]
    assert scale == SCALE and jres is None
    p3_new, t_abs, res_new = port_anchor.reanchor(
        _cfg(anchor="ba"), clip.reader.info, scale, track_px, vg, B, t_cur,
        np.array(p3), q=kwargs["q"])
    assert res_new is None
    np.testing.assert_allclose(p3_new, jp3, rtol=1e-6, atol=1e-6 * np.abs(jp3).max())
    np.testing.assert_allclose(t_abs, jt_abs, rtol=1e-6, atol=1e-6 * np.abs(jt_abs).max())
    # the re-anchor moved the structure: this compares a solve, not its input
    assert np.abs(jp3[vg] - np.asarray(p3)[vg]).max() > 1e-4
