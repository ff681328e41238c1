"""Schur-complement bundle adjustment with the tracks sharded over a mesh
axis (torch twin of ``velocity_tpu/parallel/ba_dist.py``).

The point/track axis shards (tracks are independent given the cameras, the
classic BA structure). Per Gauss-Newton iteration each shard

  1. computes residual + Jacobian blocks for its tracks (``compute_blocks``),
  2. inverts its 3x3 point blocks and forms its point-summed contributions
     to the camera system (``schur_camera_partials``),
  3. sums them over the axis (``all_reduce_sum``, the only communication:
     O((6 nc)^2) floats),
  4. solves the small camera system, the same on every shard, and
  5. back-substitutes its point updates;

a second sum over the axis gives the global step size of the convergence
test. Iterates are those of ``ba_schur`` up to the order of the sums.
``sharded_schur`` runs this loop over a batch of windows at once, which is
also ``parallel/windows.py:windowed_ba``'s inner solve.
"""

from __future__ import annotations

import torch

from velocity_tpu_torch.config import BAConfig
from velocity_tpu_torch.parallel.mesh import Mesh
from velocity_tpu_torch.solvers.ba import BAProblem, BAResult, ba_residual_rms, step_tolerance
from velocity_tpu_torch.solvers.schur import (
    compute_blocks, schur_assemble_solve, schur_backsub, schur_camera_partials,
    schur_point_blocks)


def _intr_on(intr, dev):
    return type(intr)(*(v.to(dev) for v in intr))


def sharded_schur(pixels, mask, points0, cams0, intr, comm, device_of, config: BAConfig,
                  fix_rotations: bool = False, pin_tracks: int = 0):
    """Schur BA of a batch of independent windows (a leading dimension:
    pixels (nw, nc, nt, 2), mask (nw, nc, nt), points0 (nw, nt, 3), cams0
    (nw, nc, 6)) with the tracks sharded over the collective ``comm``,
    shard s on ``device_of(s)``. The track count must divide by the axis.

    A window stops moving and stops counting once its own step rms falls
    below the tolerance or it reaches ``config.max_iters``, while the others
    run on (JAX's ``vmap`` of a ``while_loop``); the host reads whether any
    window is still running once per iteration. ``pin_tracks`` zeroes the
    point Jacobians of the tracks whose global index is below it.

    Returns (points (nw, nt, 3) whole on every process, cams (nw, nc, 6),
    iterations (nw,) int32) on the first shard's device.
    """
    dtype = points0.dtype
    nwl, nc, nt = pixels.shape[0], pixels.shape[1], pixels.shape[2]
    if nt % comm.size != 0:
        raise ValueError(f"track capacity {nt} not divisible by mesh axis {comm.size}")
    per = nt // comm.size
    inv_f = 1.0 / intr.fx
    lam = config.damping * inv_f * inv_f
    tol = step_tolerance(config, dtype)
    cg_iters = config.cg_max_iters if config.camera_solver == "cg" else 0

    shards = []
    for s in comm.indices:
        dev = device_of(s)
        sl = slice(s * per, (s + 1) * per)
        prob = BAProblem(intr=_intr_on(intr, dev), pixels=pixels[:, :, sl].to(dev),
                         mask=mask[:, :, sl].to(dev), points0=points0[:, sl].to(dev),
                         cams0=cams0.to(dev))
        # the pinned lanes by global index: they may live on any shard
        lane = torch.arange(s * per, (s + 1) * per, device=dev)
        shards.append((prob, (lane < pin_tracks)[:, None, None]))
    points = [prob.points0 for prob, _ in shards]
    cams = shards[0][0].cams0
    dev0 = cams.device
    iters = torch.zeros(nwl, dtype=torch.int32, device=dev0)
    d = torch.full((nwl,), float("inf"), dtype=dtype, device=dev0)
    running = (iters < config.max_iters) & (d >= tol)
    nx = nt * 3 + (nc - 1) * 6  # the global step count of the convergence test
    while bool(running.any()):
        local = []
        for (prob, pinned), p in zip(shards, points):
            blocks = compute_blocks(prob.intr, prob, p, cams.to(p.device), fix_rotations)
            if pin_tracks > 0:
                # the pinned lanes' point Jacobians zero -> gp = 0 there ->
                # their structure (the metric scale anchor) never moves
                blocks = blocks._replace(A=torch.where(pinned, 0.0, blocks.A))
            Vinv, gp, W = schur_point_blocks(blocks, lam.to(p.device), dtype)
            local.append((Vinv, gp, W, schur_camera_partials(blocks, Vinv, gp, W)))
        # the only communication: reduce the camera system over the axis
        U, SW, gc, rhs_red = comm.all_reduce_sum([part for *_, part in local])
        dc_raw = schur_assemble_solve(U, SW, gc, rhs_red, lam.to(U.device), dtype,
                                      cg_tol=config.cg_tol, cg_max_iters=cg_iters)
        dps = [schur_backsub(Vinv, gp, W, dc_raw.to(gp.device)) * config.step_scale
               for Vinv, gp, W, _ in local]
        dcams = dc_raw.reshape(nwl, nc, 6).to(dev0) * config.step_scale
        (sum_dp,) = comm.all_reduce_sum([(torch.sum(dp * dp, dim=(-2, -1)),) for dp in dps])
        drms = torch.sqrt((sum_dp.to(dev0) + torch.sum(dcams[:, 1:] ** 2, dim=(-2, -1))) / nx)
        # a window whose test failed keeps its carry and its count
        points = [torch.where(running.to(p.device)[:, None, None], p + dp, p)
                  for p, dp in zip(points, dps)]
        cams = torch.where(running[:, None, None], cams + dcams, cams)
        iters = iters + running.to(torch.int32)
        d = torch.where(running, drms, d)
        running = running & (iters < config.max_iters) & (d >= tol)
    return comm.gather(points, dim=1).to(dev0), cams, iters


def ba_schur_sharded(
    problem: BAProblem,
    mesh: Mesh,
    axis: str = "point",
    config: BAConfig = BAConfig(),
) -> BAResult:
    """Run Schur BA with the tracks sharded over ``mesh`` axis ``axis``.

    The track capacity must be divisible by the axis size (pad with masked
    lanes: masked tracks are inert by construction). Shard s runs on
    ``mesh.device(axis=s)``; the result is whole on every process, on the
    device of ``problem``.
    """
    points, cams, iters = sharded_schur(
        problem.pixels[None], problem.mask[None], problem.points0[None], problem.cams0[None],
        problem.intr, mesh.axis(axis), lambda s: mesh.device(**{axis: s}), config)
    dev = problem.points0.device
    points, cams = points[0].to(dev), cams[0].to(dev)
    return BAResult(points=points, cams=cams, iterations=int(iters[0]),
                    residual_rms=ba_residual_rms(problem, points, cams))
