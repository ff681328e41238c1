"""A plain reference of the MSV re-anchor's solve: upstream's ``fcnMSV1_t``
(``utils/MSV.py:8``, the video pipeline's re-anchor at frame 5,
``vidExample.py:155-160``), stated from its description and minimised by
another route. Plain torch in float64; it imports nothing of the program.

The objective, as upstream states it. Every valid track has a unit ray in
each frame 0..msv through its pixel, (u - cx, v - cy, fx) normalised. The
cameras do not rotate; camera f sits at ``origins[0] - origins[f]`` in
camera 0's frame (``origins`` are the pipeline's per-frame translations,
p_cam = p + t_f), except the newest, which sits at -x. A track's point is
the mean, over every pair of frames j < k, of the midpoint of the shortest
segment between its two rays (the pairwise ray intercept,
``fcn2vintercept``, ``MSV.py:98``). Moved into the newest camera's frame
(+ x) and projected through the pinhole, it is compared with the track's
pixel in the newest frame. The solve finds the x that minimises the sum of
squares of those differences, starting where upstream starts, x0 =
(0, 0, 1) - (origins[0] - origins[msv - 1]), or where the program's
"tracked" solve starts, at the newest camera's tracked translation.

The route is not upstream's. Upstream (and the program) iterates damped
Gauss-Newton steps. Here:

- each iteration takes the undamped Gauss-Newton direction from a Jacobian
  by central differences (upstream: forward differences, ``MSV.py:30-33``);
- a backtracking line search halves the step until the cost falls by the
  Armijo fraction of the slope (upstream takes every step whole);
- it stops when the gradient is orthogonal to the residual to ``GTOL``
  (|J^T r| <= GTOL |J| |r|), when a step moves x by less than ``XTOL``,
  or when the line search cannot lower the cost by any step (the minimum
  in this precision); upstream stops on the step's rms below 1e-8.

How the program's answer is held to this one (``compare``). The cost is
computed with cancellations (1 - d^2 of nearly parallel rays, for tracks
near the point the car recedes from) that put rounding noise of a few
1e-12 of itself on it, so along the objective's flattest direction (the
newest camera's depth) a minimum is fixed only to where the cost rises by
that much, a micrometre or more where the tracks leave a residual of
pixels. So the translation is judged in the objective's own measure: the
cost at the program's translation may differ from the cost at this minimum
by ``COST_TOL`` of it. The cloud is the intercept at the translation: the
program's must be this module's cloud at the program's translation, to
``CLOUD_TOL`` of the cloud's extent. Over the 60 clips of the video cell's
15 calibration banks the tracked solve in float64 reads at most 1.3e-12 and
9.8e-12; in float32 it reads at least 1.7e-3 and 2.5e-3, more than 1e6x
over (``tests/test_torch_msv_accept.py`` holds the same on seeded scenes).

Other departures from the description, none of which moves the minimum:
tracks outside the mask take no part (upstream indexes the valid tracks,
``P[:, vg]``); the residual is divided by fx (a constant factor of the
cost); skew is taken as 0 (every configuration has none).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F64 = torch.float64
GTOL = 1e-12  # |J^T r| / (|J| |r|): the first-order condition, near rounding
XTOL = 1e-14  # m, relative to max(1, |x|): a step below it changes nothing more
MAX_ITERS = 200
MAX_HALVINGS = 60
ARMIJO = 1e-4
COST_TOL = 1e-9  # of the minimum's cost: the program's cost above it
CLOUD_TOL = 1e-10  # of the cloud's extent: the program's cloud against the intercept


class Solution(NamedTuple):
    t: torch.Tensor  # (3,) the newest camera's translation x
    points: torch.Tensor  # (N, 3) the cloud in the newest camera's frame (masked rows 0)
    rms_px: float  # rms of the valid tracks' x and y differences, pixels
    iterations: int
    cost: float  # the sum of squares at t, in units of fx^2


def rays(pixels, fx, cx, cy):
    """Unit rays (nf, N, 3) of pixels (nf, N, 2), as upstream's
    ``pixel2uvec``: (u - cx, v - cy, fx) normalised."""
    d = torch.stack([pixels[..., 0] - cx, pixels[..., 1] - cy,
                     torch.full_like(pixels[..., 0], fx)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def pairwise_intercept(centres, dirs):
    """(N, 3): for each track, the mean over frame pairs j < k of the
    midpoint of the shortest segment between the ray from ``centres[j]``
    along ``dirs[j]`` and the ray from ``centres[k]`` along ``dirs[k]``."""
    nf = dirs.shape[0]
    total = torch.zeros_like(dirs[0])
    pairs = 0
    for j in range(nf):
        for k in range(j + 1, nf):
            a, b = centres[j], centres[k]
            u, v = dirs[j], dirs[k]
            w = (a - b)[None, :]
            d = (u * v).sum(-1)
            e = (u * w).sum(-1)
            f = (v * w).sum(-1)
            den = 1.0 - d * d
            s = (d * f - e) / den  # along u, from a
            t = (f - d * e) / den  # along v, from b
            total = total + 0.5 * ((a + s[:, None] * u) + (b + t[:, None] * v))
            pairs += 1
    return total / pairs


def residuals(x, dirs, centres0, z, fx, fy, cx, cy):
    """The valid tracks' reprojection differences in the newest frame,
    (2M,), in units of fx, and the cloud (M, 3) in the newest camera's
    frame."""
    centres = torch.cat([centres0, -x[None, :]], dim=0)
    cloud = pairwise_intercept(centres, dirs) + x
    u = fx * cloud[:, 0] / cloud[:, 2] + cx
    v = fy * cloud[:, 1] / cloud[:, 2] + cy
    return torch.cat([z[:, 0] - u, z[:, 1] - v]) / fx, cloud


def _problem(intr, pixels, mask, origins):
    fx, fy, cx, cy = (float(v) for v in intr)
    pixels = torch.as_tensor(pixels, dtype=F64)
    mask = torch.as_tensor(mask, dtype=torch.bool)
    origins = torch.as_tensor(origins, dtype=F64)
    nf = pixels.shape[0]
    dirs = rays(pixels[:, mask], fx, cx, cy)
    centres0 = (origins[0][None, :] - origins)[:-1]
    z = pixels[nf - 1, mask]
    return mask, centres0, lambda x: residuals(x, dirs, centres0, z, fx, fy, cx, cy)


def objective(intr, pixels, mask, origins, t):
    """(the cost at the translation ``t``, the cloud (N, 3) there, masked
    rows 0)."""
    mask, _c, res = _problem(intr, pixels, mask, origins)
    r, cloud_valid = res(torch.as_tensor(t, dtype=F64))
    cloud = torch.zeros((mask.shape[0], 3), dtype=F64)
    cloud[mask] = cloud_valid
    return float(r @ r), cloud


def _minimise(res, x):
    """The minimiser of ||res(x)||^2 from x: (x, its cost, iterations)."""

    def cost(x):
        r, _ = res(x)
        return float(r @ r), r

    def jacobian(x):
        cols = []
        for i in range(3):
            h = 1e-6 * max(1.0, abs(float(x[i])))
            e = torch.zeros(3, dtype=F64)
            e[i] = h
            cols.append((res(x + e)[0] - res(x - e)[0]) / (2.0 * h))
        return torch.stack(cols, dim=1)

    c, r = cost(x)
    it = 0
    for it in range(1, MAX_ITERS + 1):
        J = jacobian(x)
        grad = J.T @ r  # half the cost's gradient
        if float(torch.linalg.vector_norm(grad)) <= GTOL * float(
                torch.linalg.matrix_norm(J) * torch.linalg.vector_norm(r)):
            break
        step = torch.linalg.lstsq(J, -r[:, None]).solution[:, 0]
        slope = float(grad @ step)  # half the cost's directional derivative
        if slope >= 0:  # the Jacobian's direction does not descend: go down the gradient
            step, slope = -grad, -float(grad @ grad)
        alpha = 1.0
        for _ in range(MAX_HALVINGS):
            c_try, r_try = cost(x + alpha * step)
            if c_try < c + 2.0 * ARMIJO * alpha * slope:
                break
            alpha *= 0.5
        else:
            break  # no step lowers the cost: the minimum, to rounding
        x = x + alpha * step
        c, r = c_try, r_try
        if float((alpha * step).abs().max()) <= XTOL * max(1.0, float(x.abs().max())):
            break
    return x, c, it


def solve(intr, pixels, mask, origins, start="upstream") -> Solution:
    """The minimiser of the MSV objective in the newest camera's translation.

    ``intr`` (fx, fy, cx, cy) floats; ``pixels`` (nf, N, 2) tracks over
    frames 0..msv; ``mask`` (N,) the tracks valid in all of them;
    ``origins`` (nf, 3) the frames' translations. ``start``: "upstream",
    (0, 0, 1) beyond the previous camera, or "tracked", the newest camera's
    tracked translation ``origins[-1] - origins[0]`` (the program's
    ``SolverConfig.msv_solve``); the objective is not convex, and the two
    can reach different minima.
    """
    _m, centres0, res = _problem(intr, pixels, mask, origins)
    if start == "tracked":
        x = -(torch.as_tensor(origins, dtype=F64)[0] - torch.as_tensor(origins, dtype=F64)[-1])
    elif start == "upstream":
        x = torch.tensor([0.0, 0.0, 1.0], dtype=F64) - centres0[-1]
    else:
        raise ValueError(f"start is 'upstream' or 'tracked', not {start!r}")
    x, c, iterations = _minimise(res, x)
    _c, cloud = objective(intr, pixels, mask, origins, x)
    fx = float(intr[0])
    rms_px = fx * (c / max(2 * int(torch.as_tensor(mask).sum()), 1)) ** 0.5
    return Solution(t=x, points=cloud, rms_px=rms_px, iterations=iterations, cost=c)


def compare(intr, pixels, mask, origins, t, points, sol: Solution) -> dict:
    """The program's answer (``t``, ``points`` (N, 3)) on an MSV problem
    against this module's ``sol``: ``cost_excess``, the cost at ``t`` less
    the minimum's, over the minimum's (below the minimum, by more than its
    rounding, is another minimum: as far off); ``cloud_err``, the largest
    distance of a valid track's point from the intercept at ``t``, over the
    cloud's extent; ``t_err_m``, the largest coordinate of ``t`` minus the
    minimiser; ``ok`` where the first two are within ``COST_TOL`` and
    ``CLOUD_TOL``."""
    valid = torch.as_tensor(mask, dtype=torch.bool)
    t = torch.as_tensor(t, dtype=F64)
    cost, cloud = objective(intr, pixels, valid, origins, t)
    points = torch.as_tensor(points, dtype=F64)
    extent = float(cloud[valid].abs().max())
    out = {"cost_excess": (cost - sol.cost) / sol.cost,
           "cloud_err": float((points[valid] - cloud[valid]).abs().max()) / extent,
           "t_err_m": float((t - sol.t).abs().max()),
           "reference_rms_px": sol.rms_px, "reference_iterations": sol.iterations}
    out["ok"] = bool(abs(out["cost_excess"]) <= COST_TOL and out["cloud_err"] <= CLOUD_TOL)
    return out
