"""Carry the JAX package's state into the port.

There are no learned weights: what crosses is state, the intrinsics, the
scan carry (points, validity masks, translation, structure) and the
per-frame pyramids. ``state_from_numpy`` takes those arrays as numpy (from
``np.asarray`` of the JAX arrays) and returns the port's tensors on a
device (the card unless the caller asks for the CPU), so a test can start
the port's frame step from exactly the JAX step's inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from velocity_tpu_torch.geometry.projection import Intrinsics


def state_from_numpy(*, pyr=None, spyr=None, pts=None, vg=None, vp=None, t=None,
                     p3=None, intr=None, device="cuda",
                     solver_dtype=torch.float32) -> dict:
    """Port tensors for the given JAX-side arrays (omitted ones are skipped).

    ``pyr``/``spyr``: sequences of 2-D levels -> tuples of f32 tensors;
    ``pts`` (N, 2) -> f32; ``vg``/``vp`` (N,) -> bool; ``t`` (3,) and ``p3``
    (N, 3) -> ``solver_dtype``; ``intr``: five scalars (fx, fy, cx, cy,
    skew), such as a JAX ``Intrinsics`` -> ``Intrinsics`` of
    ``solver_dtype``.
    """
    dev = torch.device(device)

    def tensor(a, dtype):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    out = {}
    if pyr is not None:
        out["pyr"] = tuple(tensor(level, torch.float32) for level in pyr)
    if spyr is not None:
        out["spyr"] = tuple(tensor(level, torch.float32) for level in spyr)
    if pts is not None:
        out["pts"] = tensor(pts, torch.float32)
    for name, v in (("vg", vg), ("vp", vp)):
        if v is not None:
            out[name] = tensor(v, torch.bool)
    for name, v in (("t", t), ("p3", p3)):
        if v is not None:
            out[name] = tensor(v, solver_dtype)
    if intr is not None:
        out["intr"] = Intrinsics(*(tensor(v, solver_dtype) for v in intr))
    return out
