"""The port's bench entry on the CPU: the transfer-lean runs against JAX's
and against their own full runs, ``bench_torch.py``, ``bench_ba_torch.py``
and ``parallel/launch.py:make_global``.

The clip is the small one of ``tests/_torch_clip.py`` (270x480, 8 frames,
msv_frame 3, 128 features, 64 RANSAC trials, f32 solver). JAX's
``ScanSpeedRunner.run(lean=True)`` runs once per module; the port's scan
runs draw JAX's RANSAC noise (``_inject``), so the lean run is held to JAX's
at the run-level tolerances of ``test_torch_slice.py`` (speed within 0.5%,
per-frame translations within 1e-3 relative). A lean run of the port only
fetches less: its trajectory and ``S[:, 2:]`` equal its full run's bit for
bit (f32 solver; ``S[:, 1]`` is per-frame wall time). The bench scripts run
at that size through their functions, with the small configuration in place
of the bench's.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_clip import (MSV, N_FRAMES, _cfg, _inject, _jax_camera, _jax_gumbel,
                         _jax_reads_clip, _jcfg, make_clip)

import bench_ba_torch
import bench_torch
from velocity_tpu.geometry.projection import pixel_to_unit_ray as jax_pixel_to_unit_ray
from velocity_tpu.pipeline.scan import ScanSpeedRunner as JaxScanSpeedRunner
from velocity_tpu.solvers.triangulate import nray_intercept as jax_nray_intercept
from velocity_tpu_torch.config import PipelineConfig
from velocity_tpu_torch.parallel.launch import make_global
from velocity_tpu_torch.parallel.mesh import make_mesh
from velocity_tpu_torch.pipeline import datasets
from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
from velocity_tpu_torch.pipeline.speedest import SpeedEstimator

torch.set_num_threads(1)

BENCH_FRAMES = 4
BENCH_FIELDS = {"metric", "value", "unit", "mode", "frames", "speed_kmh", "speed_std",
                "reference_speed_kmh", "speed_err_kmh", "residual_px", "walls_s", "device"}


@pytest.fixture(scope="module")
def clip():
    return make_clip()


@pytest.fixture(scope="module")
def jax_lean(clip):
    with pytest.MonkeyPatch.context() as mp:
        ann = _jax_reads_clip(mp, clip)
        return JaxScanSpeedRunner(_jcfg()).run("synthetic.MOV", annotation=ann,
                                              n_frames=N_FRAMES, verbose=False, lean=True)


def _port_run(clip, runner, lean):
    """``runner.run`` on the clip with JAX's scan-runner noise."""
    _, draws = _jax_gumbel(N_FRAMES)
    with pytest.MonkeyPatch.context() as mp:
        _inject(mp, draws)
        res = runner.run(clip.reader, annotation=clip.annotation, n_frames=N_FRAMES,
                         verbose=False, lean=lean)
    assert not draws
    return res


@pytest.fixture(scope="module")
def port_scan(clip):
    """The port's scan runner on the clip, lean and full: {lean: RunResult}."""
    runner = ScanSpeedRunner(_cfg(), device="cpu")
    return {lean: _port_run(clip, runner, lean) for lean in (True, False)}


def _assert_lean_equals_full(lean, full):
    np.testing.assert_array_equal(lean.B[:, 0:6], full.B[:, 0:6])
    np.testing.assert_array_equal(lean.S[:, 2:], full.S[:, 2:])
    assert np.isnan(lean.track_px[MSV + 1 :]).all() and not lean.valid[MSV + 1 :].any()
    assert np.isnan(lean.proj_px[MSV + 1 :]).all()
    np.testing.assert_array_equal(lean.track_px[: MSV + 1], full.track_px[: MSV + 1])
    assert full.valid[MSV + 1 :].any()


def test_lean_scan_run_matches_jax(clip, jax_lean, port_scan):
    """The port's lean scan run against JAX's: speed within 0.5%,
    translations within 1e-3 relative, both with no history after the MSV
    frame and the same live lanes in S[:, 2]."""
    got, want = port_scan[True], jax_lean
    assert abs(got.speed_kmh - want.speed_kmh) <= 0.005 * want.speed_kmh
    dt = np.linalg.norm(got.B[1:, 3:6] - want.B[1:, 3:6], axis=1)
    assert (dt <= 1e-3 * np.linalg.norm(want.B[1:, 3:6], axis=1)).all(), dt
    for res in (got, want):
        assert np.isnan(res.track_px[MSV + 1 :]).all() and not res.valid[MSV + 1 :].any()
    np.testing.assert_array_equal(got.S[:, 2], want.S[:, 2])
    assert abs(got.speed_kmh - clip.speed_kmh) <= 0.15 * clip.speed_kmh


def test_lean_scan_run_equals_full_run(port_scan):
    _assert_lean_equals_full(port_scan[True], port_scan[False])


def test_lean_driver_run_equals_full_run(clip):
    """The per-frame driver, lean and full, on its own generator: the same
    bits in the trajectory and S[:, 2:]."""
    est = SpeedEstimator(_cfg(), device="cpu")
    runs = [est.run(clip.reader, annotation=clip.annotation, n_frames=N_FRAMES,
                    verbose=False, collect_images=False, lean=lean) for lean in (True, False)]
    _assert_lean_equals_full(*runs)


def _bench_cfg():
    """The small configuration at the bench's own msv_frame: a run of
    BENCH_FRAMES frames ends before it (the host MSV costs ~15 s of CPU)."""
    return dataclasses.replace(_cfg(), msv_frame=PipelineConfig().msv_frame)


@pytest.fixture
def small_bench(monkeypatch, clip):
    """bench_torch with the small configuration and clip, BENCH_FRAMES
    frames and one timed run."""
    monkeypatch.setattr(bench_torch, "bench_config", _bench_cfg)
    monkeypatch.setattr(bench_torch, "load_clip",
                        lambda name: (clip.reader, clip.annotation, None, clip.speed_kmh))
    monkeypatch.setattr(bench_torch, "N_FRAMES", BENCH_FRAMES)
    monkeypatch.setattr(bench_torch, "REPS", 1)


def test_run_bench_fields_and_speed(clip, small_bench):
    """run_bench at BENCH_FRAMES frames, one timed run: the JSON fields, a
    line json can write, and the speed of a direct lean run."""
    out, res = bench_torch.run_bench(clip.reader, clip.annotation, n_frames=BENCH_FRAMES,
                                     reps=1, mode="scan", device="cpu",
                                     reference_kmh=clip.speed_kmh)
    assert set(out) == BENCH_FIELDS and "vs_baseline" not in out
    assert out["mode"] == "scan" and out["frames"] == BENCH_FRAMES
    assert out["device"] == {"type": "cpu"} and "synthetic" in out["metric"]
    assert out["value"] == BENCH_FRAMES / out["walls_s"][0] > 0
    json.dumps(out)
    direct = ScanSpeedRunner(_bench_cfg(), device="cpu").run(
        clip.reader, annotation=clip.annotation, n_frames=BENCH_FRAMES, verbose=False,
        lean=True)
    assert out["speed_kmh"] == direct.speed_kmh == res.speed_kmh
    assert out["speed_err_kmh"] == abs(direct.speed_kmh - clip.speed_kmh)


def _recording(calls, name, result=None, error=None):
    def run(self, *args, **kwargs):
        calls.append((name, kwargs.get("lean")))
        if error is not None:
            raise error
        return result

    return run


@pytest.mark.parametrize("fails", [False, True])
def test_bench_mode_is_not_switched(small_bench, port_scan, monkeypatch, capsys, fails):
    """``--mode frames`` runs the driver alone, lean; ``--mode scan`` with a
    failing runner raises (a non-zero exit) without trying the driver."""
    calls = []
    err = RuntimeError("scan path failed") if fails else None
    monkeypatch.setattr(ScanSpeedRunner, "run", _recording(calls, "scan", port_scan[True], err))
    monkeypatch.setattr(SpeedEstimator, "run", _recording(calls, "frames", port_scan[True]))
    if fails:
        with pytest.raises(RuntimeError, match="scan path failed"):
            bench_torch.main(["--mode", "scan", "--device", "cpu"])
        assert calls == [("scan", True)]
    else:
        assert bench_torch.main(["--mode", "frames", "--device", "cpu"]) == 0
        assert calls == [("frames", True)] * 2  # warm-up and the one timed run
        assert json.loads(capsys.readouterr().out.strip())["mode"] == "frames"


def test_bench_img_4119_raises_without_the_video(monkeypatch, tmp_path):
    real = datasets.known_run("IMG_4119")
    absent = dataclasses.replace(real, video=str(tmp_path / "IMG_4119.MOV"))
    monkeypatch.setattr(datasets, "known_run", lambda name: absent)
    with pytest.raises(FileNotFoundError, match="IMG_4119"):
        bench_torch.main(["--clip", "IMG_4119", "--device", "cpu"])


@pytest.mark.parametrize("main", [bench_torch.main, bench_ba_torch.main])
def test_bench_scripts_refuse_cuda_without_a_card(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main([])


def test_ba_problem_from_run_matches_jax_steps(port_scan):
    """bench_ba.py:80-107 written out with JAX's pixel_to_unit_ray and
    nray_intercept on the same run's arrays: pixels, mask and cameras
    equal; each starting point within 1e-5 relative, plus what f32 normal
    equations allow: 2 eps x the condition number of the lane's 3x3
    system (in f64), which reaches 4e4 over this clip's short baseline, so
    that either package's f32 intercept may stand 1e-3 from the other."""
    res, cfg, cap = port_scan[False], _cfg(), 2 * _cfg().tracker.max_features
    prob, n_real = bench_ba_torch.ba_problem_from_run(res, cfg, capacity=cap)

    nc = res.B.shape[0]
    sel = np.where(res.valid.all(axis=0))[0]
    assert n_real == len(sel) > 40
    intr = _jax_camera(res.camera).intrinsics(scale=cfg.native_scale).astype(jnp.float32)
    pix = np.zeros((nc, cap, 2), np.float32)
    mask = np.zeros((nc, cap), bool)
    pix[:, : len(sel)] = res.track_px[:, sel]
    mask[:, : len(sel)] = True
    cams = np.zeros((nc, 6), np.float32)
    cams[:, 0:3] = res.B[:, 0:3] - res.B[0, 0:3]
    rays = np.asarray(jax_pixel_to_unit_ray(intr, jnp.asarray(pix.reshape(-1, 2))))
    pts0 = np.asarray(jax_nray_intercept(jnp.asarray(-cams[:, 0:3]),
                                         jnp.asarray(rays.reshape(nc, cap, 3))))
    lane_real = (np.arange(cap) < len(sel))[:, None]
    pts0 = np.where(np.isfinite(pts0) & (np.abs(pts0) < 1e4).all(axis=1, keepdims=True)
                    & lane_real, pts0, np.array([0.0, 0.0, 8.0])).astype(np.float32)

    np.testing.assert_array_equal(prob.pixels.numpy(), pix)
    np.testing.assert_array_equal(prob.mask.numpy(), mask)
    np.testing.assert_array_equal(prob.cams0.numpy(), cams)
    u = rays.reshape(nc, cap, 3)[:, : len(sel)].astype(np.float64)
    u /= np.linalg.norm(u, axis=2, keepdims=True)
    kappa = np.linalg.cond((np.eye(3) - u[..., :, None] * u[..., None, :]).sum(axis=0))
    rel = np.linalg.norm(prob.points0.numpy() - pts0, axis=1) / np.linalg.norm(pts0, axis=1)
    limit = np.full(cap, 1e-5)
    limit[: len(sel)] += 2 * np.finfo(np.float32).eps * kappa
    assert (rel <= limit).all(), (rel / limit).max()
    np.testing.assert_array_equal(prob.points0.numpy()[len(sel) :], pts0[len(sel) :])
    assert float(prob.intr.fx) == float(intr.fx)


def test_bench_ba_rows_are_finite():
    """The BA and batched rows at nc 4 x nt 32 on the CPU: finite times,
    iterations that moved between the low and the high run, and no share of
    the card's peak."""
    dev = torch.device("cpu")
    prob = bench_ba_torch.ba_scene(4, 32, torch.float32, dev)
    rows = bench_ba_torch.bench_ba_rows(prob, 32, dev, "scene")
    rows += bench_ba_torch.bench_batched_schur_rows(prob, dev)
    assert [r["unit"] for r in rows] == ["ms/iter", "ms/iter", "ms/iter (all windows)"]
    assert not any("pct" in key for r in rows for key in r)  # no device metric off the card
    for r in rows:
        assert r["value"] is not None and np.isfinite(r["value"]), r
    for r in rows[:2]:
        assert r["iterations_hi"] > r["iterations_lo"] and r["t_hi_s"] > 0 < r["t_lo_s"]
    json.dumps(rows)


def test_make_global_gives_each_shard_its_slice():
    mesh = make_mesh({"point": 2}, devices=["cpu"] * 2)
    value = np.arange(24, dtype=np.float32).reshape(4, 6)
    for dim in (0, 1):
        parts = make_global(mesh, "point", value, dim=dim)
        assert len(parts) == 2
        for s, part in enumerate(parts):
            want = np.split(value, 2, axis=dim)[s]
            np.testing.assert_array_equal(part.numpy(), want)
            assert part.device == mesh.device(point=s) and part.is_contiguous()
    with pytest.raises(ValueError, match="divisible"):
        make_global(make_mesh({"point": 4}, devices=["cpu"] * 4), "point", value, dim=1)

