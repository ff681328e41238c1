"""Checkpoint/resume at window granularity (a copy of
``velocity_tpu/parallel/checkpoint.py``: the same ``.npz`` layout, so a
checkpoint written by either package loads in the other).

The reference is stateless end-to-end (SURVEY.md §5); for long videos this
persists the per-window pipeline state (tracks, validity, poses, structure,
stats) so processing resumes at the last completed window boundary.
Plain .npz — the state is small (a few MB) and host-resident between windows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class WindowState:
    """Everything needed to resume tracking at a window boundary."""

    frame_index: int  # absolute frame index of the boundary frame
    points: np.ndarray  # (N, 2) current track positions
    valid: np.ndarray  # (N,) global validity
    valid_pose: np.ndarray  # (N,) pose-solve subset
    p3: np.ndarray  # (N, 3) structure
    B: np.ndarray  # (n_so_far, 14) car info rows
    S: np.ndarray  # (n_so_far, 9) stats rows
    track_px: np.ndarray | None = None  # (n_so_far, N, 2) track history
    valid_hist: np.ndarray | None = None  # (n_so_far, N) per-frame validity
    boxes: np.ndarray | None = None  # (2, 4) plate/ROI boxes (resume keeps overlays)
    ba_bounds: np.ndarray | None = None  # (nw, 2) completed BA segment bounds
    ba_p3: np.ndarray | None = None  # (nw, N, 3) per-segment structure snapshots
    ba_repl: np.ndarray | None = None  # (nw, N) lanes replenished at segment start
    repl_next: np.ndarray | None = None  # (N,) lanes replenished at this boundary
    pending: np.ndarray | None = None  # (N,) lanes awaiting triangulation promote
    meta: dict = field(default_factory=dict)


def save_state(path: str | Path, state: WindowState) -> None:
    meta_keys = np.array(sorted(state.meta.keys()), dtype=np.str_)
    meta_vals = np.array([str(state.meta[k]) for k in sorted(state.meta)], dtype=np.str_)
    extra = {}
    if state.track_px is not None:
        extra["track_px"] = state.track_px
    if state.valid_hist is not None:
        extra["valid_hist"] = state.valid_hist
    if state.boxes is not None:
        extra["boxes"] = np.asarray(state.boxes, np.int64)
    if state.ba_bounds is not None:
        extra["ba_bounds"] = np.asarray(state.ba_bounds, np.int64)
    if state.ba_p3 is not None:
        extra["ba_p3"] = state.ba_p3
    if state.ba_repl is not None:
        extra["ba_repl"] = state.ba_repl
    if state.repl_next is not None:
        extra["repl_next"] = state.repl_next
    if state.pending is not None:
        extra["pending"] = state.pending
    np.savez_compressed(
        str(path),
        frame_index=np.int64(state.frame_index),
        points=state.points,
        valid=state.valid,
        valid_pose=state.valid_pose,
        p3=state.p3,
        B=state.B,
        S=state.S,
        meta_keys=meta_keys,
        meta_vals=meta_vals,
        **extra,
    )


def load_state(path: str | Path) -> WindowState:
    z = np.load(str(path), allow_pickle=False)
    meta = dict(zip(z["meta_keys"].tolist(), z["meta_vals"].tolist()))
    return WindowState(
        frame_index=int(z["frame_index"]),
        points=z["points"],
        valid=z["valid"],
        valid_pose=z["valid_pose"],
        p3=z["p3"],
        B=z["B"],
        S=z["S"],
        track_px=z["track_px"] if "track_px" in z else None,
        valid_hist=z["valid_hist"] if "valid_hist" in z else None,
        boxes=z["boxes"] if "boxes" in z else None,
        ba_bounds=z["ba_bounds"] if "ba_bounds" in z else None,
        ba_p3=z["ba_p3"] if "ba_p3" in z else None,
        ba_repl=z["ba_repl"] if "ba_repl" in z else None,
        repl_next=z["repl_next"] if "repl_next" in z else None,
        pending=z["pending"] if "pending" in z else None,
        meta=meta,
    )
