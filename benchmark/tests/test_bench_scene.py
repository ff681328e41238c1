"""The scene generator's truth at a small size, and the reference judging
the scene's own answers as exact and the control's as not."""

import copy
import json

import numpy as np
import pytest
import torch

from benchmark import harness, scene
from benchmark.reference import control, geo, judge
from benchmark.tests.small import shrink

CPU = torch.device("cpu")


def _config(workload="phone1080p30-lanes-ba.scan20"):
    _wl, config, traffic, _spec = harness.cell(workload)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    shrink()(config, traffic)
    return config, traffic


def test_truth_geometry():
    config, _ = _config()
    sc = config["scene"]
    tr = scene.truth(sc, 6)
    # the plate's corners map through frame 0's homography to corners_px
    corners = scene.plate_corners(*sc["plate_m"])[:, :2]
    q = np.c_[corners, np.ones(4)] @ tr.plane_to_image[0].T
    np.testing.assert_allclose(q[:, :2] / q[:, 2:], tr.corners_px, atol=1e-9)
    # constant velocity at the configured speed, from the configured depth
    steps = np.diff(tr.t_cam, axis=0)
    np.testing.assert_allclose(steps - steps[0], 0.0, atol=1e-12)
    assert tr.speed_kmh == pytest.approx(sc["speed_kmh"])
    assert tr.t_cam[0, 2] == sc["depth0_m"]
    assert tr.times_s[1] == pytest.approx(sc["stride"] / sc["fps"])


def test_render_shows_the_plate_where_the_truth_puts_it():
    config, _ = _config()
    clip = scene.render(config["scene"], 2, 11, 12, CPU)
    assert clip.grays.shape == (2, config["scene"]["height"], config["scene"]["width"])
    assert clip.grays.dtype == np.uint8
    # the plate is light (235) with dark characters; its holder dark (35)
    c = clip.truth.corners_px.mean(axis=0)
    x, y = int(round(c[0] - 0.3 * (c[0] - clip.truth.corners_px[2, 0]))), int(round(c[1]))
    top = clip.truth.corners_px[[0, 3]].mean(axis=0)
    assert clip.grays[0, int(round(top[1])) + 1, int(round(top[0]))] > 150
    assert clip.grays[0, y, x] < 255


def test_render_depends_on_its_seeds_only():
    config, _ = _config()
    a = scene.render(config["scene"], 2, 5, 6, CPU).grays
    b = scene.render(config["scene"], 2, 5, 6, CPU).grays
    c = scene.render(config["scene"], 2, 5, 7, CPU).grays  # other noise
    d = scene.render(config["scene"], 2, 8, 6, CPU).grays  # other paint
    assert np.array_equal(a, b)
    assert 0 < np.abs(a.astype(int) - c).max() <= 10
    assert (a != d).mean() > 0.05


def test_pool_is_one_set_in_the_seeds_order():
    config, _ = _config()
    p1 = scene.pool(config["scene"], 2, 3, CPU)
    p2 = scene.pool(config["scene"], 2, 3, CPU)
    assert all(np.array_equal(a.grays, b.grays) for a, b in zip(p1, p2))
    assert sorted(scene.order(2**31 + 12345, 4)) == [0, 1, 2, 3]
    assert scene.order(7, 4) == scene.order(7, 4)
    assert len({tuple(scene.order(s, 4)) for s in range(20)}) > 1


def test_judge_reads_the_truth_as_exact():
    config, _ = _config()
    n, msv = 6, 3
    tr = scene.truth(config["scene"], n)
    rng = np.random.default_rng(0)
    p0 = tr.corners_px.mean(axis=0) + rng.uniform(-20, 20, (50, 2))
    track = judge.true_tracks(tr, p0, range(n)).astype(np.float32)
    B = np.zeros((n, 14))
    B[:, 0:3] = tr.t_cam
    B[:, 13] = np.arange(n)
    S = np.zeros((n, 9))
    S[1:, 8] = np.linalg.norm(np.diff(tr.t_cam, axis=0), axis=1) / np.diff(tr.times_s) * 3.6
    ans = {"B": B, "S": S, "track_px": track, "valid": np.ones((n, 50), bool), "timings": {}}
    r = judge.readings(ans, tr, n, msv)
    assert r["missing"] == 0 and r["track_err_max_px"] < 1e-3
    assert r["traj_err_pct"] < 1e-9 and r["frame_speed_err_pct"] < 1e-9
    # the control: the same answers worked out in bfloat16
    rc = judge.readings(control.answers(ans, tr), tr, n, msv)
    assert rc["track_err_px"] > 0.1 and rc["frame_speed_err_pct"] > 0.5
    # too few frames is an answer missing
    short = dict(ans, B=B[:3], S=S[:3])
    assert judge.readings(short, tr, n, msv)["missing"] == 1
    unprocessed = B.copy()
    unprocessed[4:, 13] = 0
    assert judge.readings(dict(ans, B=unprocessed), tr, n, msv)["missing"] == 1


def test_georegistration_reference():
    fix = np.array([-33.45, -70.66, 520.0])
    e0 = geo.lla_to_ecef(fix)
    assert np.linalg.norm(e0) == pytest.approx(6.37e6, rel=0.01)
    # one metre north, east and down are orthonormal steps in ECEF
    steps = geo.ned_to_ecef(np.eye(3), fix) - e0
    np.testing.assert_allclose(steps @ steps.T, np.eye(3), atol=1e-9)
    # down points toward the Earth's centre, roughly
    assert np.dot(steps[2], e0) < 0


def test_configs_state_what_they_run():
    for c in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["configs"]:
        config = json.loads((harness.ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"]
        assert config["pipeline"]["solver"]["dtype"] == "float32"
        assert "float32" in config["precision"]
