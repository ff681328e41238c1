"""Entry points of the PyTorch port, twins of ``__graft_entry__.py``.

- ``entry(device="cuda")``: ``(fn, example_args)``, one fused frame step of
  the speed pipeline (lanes LK through an affine prior, masked 3-parameter
  pose solve) at the production track capacity, on ``device``.
- ``dryrun_multichip(n, device="cuda")``: one windowed Schur BA step over an
  n-shard mesh with the framework's axes (window x point). Shards run on
  the process's GPUs; where there are fewer than n, all n run in process on
  the first one. Neither falls back to the CPU: "cpu" must be asked for.

    python graft_entry_torch.py
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch


def _synthetic_frame_pair(h=256, w=512, n_pts=64, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h // 8, w // 8))
    im = np.kron(base, np.ones((8, 8)))[:h, :w].astype(np.float32)
    im2 = np.roll(im, (2, 3), axis=(0, 1))
    pts = np.stack(
        [rng.uniform(60, w - 60, n_pts), rng.uniform(60, h - 60, n_pts)], axis=1
    ).astype(np.float32)
    return im, im2, pts


def entry(device="cuda"):
    """Return (fn, example_args): the product fused frame step.

    This is ``pipeline.tracker.fused_frame_step`` as the drivers run it: the
    lanes-last LK backend (``TrackerConfig()``), the full 3-stage track,
    RANSAC affine and the masked 3-parameter pose solve in f32, at 1024
    lanes, on a 512x1024 frame pair (every kernel, backend and config is
    the product path; only the image is smaller than 1080p). The tensors
    and the RANSAC generator are on ``device``.
    """
    from velocity_tpu_torch.config import SolverConfig, TrackerConfig
    from velocity_tpu_torch.geometry.projection import Intrinsics
    from velocity_tpu_torch.pipeline.speedest import require_device
    from velocity_tpu_torch.pipeline.tracker import fused_frame_step

    dev = require_device(device, "entry")
    cfg = TrackerConfig()
    h, w = 512, 1024
    n_pts = cfg.max_features
    im, im2, pts = _synthetic_frame_pair(h, w, n_pts)
    small = im[::4, ::4].copy()
    intr = Intrinsics(*(torch.tensor(v, dtype=torch.float32, device=dev)
                        for v in (1000.0, 1000.0, w / 2, h / 2, 0.0)))
    rng = np.random.default_rng(1)
    p3 = np.concatenate(
        [rng.uniform(-1, 1, (n_pts, 2)), rng.uniform(4, 6, (n_pts, 1))], axis=1
    ).astype(np.float32)
    valid = torch.ones(n_pts, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def on(x):
        return torch.as_tensor(x, device=dev)

    fn = partial(fused_frame_step, cfg=cfg, solver_cfg=SolverConfig(dtype="float32"),
                 solver_dtype=torch.float32)
    example_args = (on(im), on(im2), on(small), on(pts), valid, valid.clone(), on(p3), intr,
                    gen)
    return fn, example_args


def multichip_problem(n_devices: int, device="cuda"):
    """(mesh, args) of ``dryrun_multichip``: the mesh with JAX's axes
    (window 2 x point n/2 where n >= 4 is even, else window 1 x point n)
    and ``windowed_ba``'s arguments (pixels, mask, points0, cams0, intr):
    8 cameras and 1024 tracks rounded up to the shard size per window,
    made from seed 0 as ``__graft_entry__.py`` makes them."""
    from velocity_tpu_torch.geometry.projection import Intrinsics
    from velocity_tpu_torch.parallel import make_mesh
    from velocity_tpu_torch.pipeline.speedest import require_device

    dev = require_device(device, "dryrun_multichip")
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh({"window": 2, "point": n_devices // 2}, devices=devices)
    else:
        mesh = make_mesh({"window": 1, "point": n_devices}, devices=devices)
    nw, npt = mesh.shape["window"], mesh.shape["point"]

    nc = 8
    nt = npt * (-(-1024 // npt))
    rng = np.random.default_rng(0)
    intr = Intrinsics(*(torch.tensor(v, dtype=torch.float32, device=dev)
                        for v in (500.0, 500.0, 200.0, 150.0, 0.0)))
    pts = np.concatenate(
        [rng.uniform(-1, 1, (nw, nt, 2)), rng.uniform(4, 6, (nw, nt, 1))], axis=2
    ).astype(np.float32)
    cams = np.zeros((nw, nc, 6), np.float32)
    cams[:, :, 0] = np.linspace(0, 0.4, nc)
    pix = np.zeros((nw, nc, nt, 2), np.float32)
    for wi in range(nw):
        for c in range(nc):
            pc = pts[wi] + cams[wi, c, 0:3]
            pix[wi, c, :, 0] = 500 * pc[:, 0] / pc[:, 2] + 200
            pix[wi, c, :, 1] = 500 * pc[:, 1] / pc[:, 2] + 150
    mask = np.ones((nw, nc, nt), bool)
    points0 = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
    args = tuple(torch.as_tensor(a, device=dev) for a in (pix, mask, points0, cams)) + (intr,)
    return mesh, args


def dryrun_multichip(n_devices: int, device="cuda"):
    """One ``windowed_ba`` step (``BAConfig(max_iters=3)``) over the mesh
    of ``multichip_problem``; checks that points and cameras are finite and
    returns (points, cams, iterations)."""
    from velocity_tpu_torch.config import BAConfig
    from velocity_tpu_torch.parallel import windowed_ba

    mesh, args = multichip_problem(n_devices, device)
    points, cams, iters = windowed_ba(*args, mesh, config=BAConfig(max_iters=3))
    if not (torch.isfinite(points).all() and torch.isfinite(cams).all()):
        raise RuntimeError(f"dryrun_multichip: non-finite result on mesh {mesh.shape}")
    print(f"dryrun_multichip OK: mesh={mesh.shape} devices="
          f"{sorted({str(d) for d in mesh.devices.flat})} iters={iters.tolist()}")
    return points, cams, iters


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(min(8, max(torch.cuda.device_count(), 4)))
