"""Known dataset runs: the reference's hardcoded driver configurations.

A copy of ``velocity_tpu/pipeline/datasets.py``. The reference driver pins
start frames inconsistently with the .mat metadata (IMG_4119: .mat stores 42
(1-indexed) and the driver uses 41; IMG_4134: .mat stores 19 and the driver
uses 19, see BASELINE.md "Note on frame indexing"). These entries reproduce
the exact golden-trajectory configurations. The reference videos and .mat
annotations live under ``DATA`` and ``MATLAB``, as in the JAX package; the
IMG_4238 annotation is the one in this repository's ``data/``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class KnownRun:
    name: str
    video: str
    annotation: str | None
    start_frame: int
    n_frames: int
    gt_speed_kmh: float
    golden_speed_kmh: float | None  # measured reference output (BASELINE.md)
    golden_residual_px: float | None


REFERENCE = "/root/reference"  # where the reference dataset is mounted, as in the JAX package
DATA = f"{REFERENCE}/data"
MATLAB = f"{REFERENCE}/matlab"
REPO_DATA = Path(__file__).resolve().parents[2] / "data"

KNOWN_RUNS = {
    "IMG_4134": KnownRun(
        name="IMG_4134",
        video=f"{DATA}/IMG_4134.MOV",
        annotation=f"{MATLAB}/IMG_4134.MOV.mat",
        start_frame=19,  # vidExample.py:20
        n_frames=20,
        gt_speed_kmh=40.0,
        golden_speed_kmh=39.89,
        golden_residual_px=0.876,
    ),
    "IMG_4119": KnownRun(
        name="IMG_4119",
        video=f"{DATA}/IMG_4119.MOV",
        annotation=f"{MATLAB}/IMG_4119.MOV.mat",
        start_frame=41,  # vidExample.py:19
        n_frames=20,
        gt_speed_kmh=20.0,
        golden_speed_kmh=18.74,
        golden_residual_px=0.970,
    ),
    "IMG_4238": KnownRun(
        name="IMG_4238",
        video=f"{DATA}/IMG_4238.MOV",
        # the reference's .mat is missing (vidExample.py:21); this annotation
        # was made with velocity_tpu (plate-quad corner pick on frame 8,
        # stored native-4K like the .mat files)
        annotation=str(REPO_DATA / "IMG_4238.MOV.npz"),
        start_frame=8,
        n_frames=20,
        gt_speed_kmh=60.0,
        golden_speed_kmh=None,
        golden_residual_px=None,
    ),
}


def known_run(name: str) -> KnownRun:
    key = name.upper().replace(".MOV", "").replace("DATA/", "")
    for k, v in KNOWN_RUNS.items():
        if k in key or key in k:
            return v
    raise KeyError(f"unknown run {name!r}; known: {list(KNOWN_RUNS)}")
