"""The control: the reference put in the program's place, computed in
bfloat16, the nearest precision below the float32 that the configurations
state for the tracker and the solver.

It answers the clip the program answered, on the same frame-0 points and
the same validity: the tracks are the frame-0 points carried into every
frame by the plane's homographies, the car's positions and speeds follow
the true motion, the residual compares each track with the projection of
its plane point through the true pose, and a burst's positions are
georegistered. Every operation runs in bfloat16 (torch on the host). The
judge (``judge.py``) then reads it as it reads the program; a comparison
that passes it could not tell a bfloat16 pipeline from the float32 one.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import geo

BF16 = torch.bfloat16


def _b(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64)).to(BF16)


def answers(ans: dict, truth, gps=None) -> dict:
    """The control's answers in the shape of the program's ``ans``."""
    track, valid = ans["track_px"], ans["valid"]
    n = len(ans["B"])
    out = {"B": ans["B"].copy(), "S": ans["S"].copy(), "track_px": track.copy(),
           "valid": valid.copy(), "timings": ans["timings"]}
    v0 = valid[0]
    p0 = _b(track[0][v0])
    H = _b(truth.plane_to_image[:n])
    Hinv0 = _b(np.linalg.inv(truth.plane_to_image[0]))
    ones = torch.ones((len(p0), 1), dtype=BF16)
    plane = torch.cat([p0, ones], 1) @ Hinv0.T
    plane = plane[:, :2] / plane[:, 2:3]
    K, R = _b(truth.K), _b(truth.R)
    t = _b(truth.t_cam[0])[None] + (_b(truth.t_cam[1] - truth.t_cam[0])[None]
                                    * _b(np.arange(n) * 1.0)[:, None])
    res = torch.zeros(n, dtype=BF16)
    for i in range(n):
        q = torch.cat([plane, torch.ones((len(plane), 1), dtype=BF16)], 1) @ H[i].T
        tr = q[:, :2] / q[:, 2:3]
        cam = plane[:, 0:1] * R[0] + plane[:, 1:2] * R[1] + t[i]
        pr = cam @ K.T
        pr = pr[:, :2] / pr[:, 2:3]
        res[i] = ((tr - pr) ** 2).sum(1).mean().sqrt()
        rows = valid[i] & v0
        out["track_px"][i][rows] = tr[rows[v0]].float().numpy()
    out["B"][:, 0:3] = t.double().numpy()
    dt = _b(truth.times_s[1] - truth.times_s[0])
    dr = torch.linalg.vector_norm((t[1:] - t[:-1]).float(), dim=1).to(BF16)
    out["S"][1:, 8] = (dr / dt * _b(3.6)).double().numpy()
    out["S"][:, 3] = res.double().numpy()
    if gps is not None:
        fix, yaw = gps
        psi = np.radians(yaw)
        c, s = np.cos(psi), np.sin(psi)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]) @ np.array(
            [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        ned = t @ _b(rot).T
        fix = np.asarray(fix, np.float64)
        ecef = ned @ _b(geo.ecef_from_ned(fix[0], fix[1])).T + _b(geo.lla_to_ecef(fix))
        out["B"][:, 6:9] = ecef.double().numpy()
    return out
