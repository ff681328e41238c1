"""License-plate annotation files (.mat compatibility + native .npz format).

The reference stores hand-clicked plate corners in MATLAB .mat files with keys
``q`` (4x2 clockwise corners in native-resolution pixels), ``fname``, and for
videos ``startFrame`` (1-indexed; the Python reference driver uses 0-indexed
frame numbers — see BASELINE.md note). We read .mat via scipy and also support
writing/reading a plain .npz with the same fields so new annotations (e.g.
IMG_4238.MOV) don't need MATLAB.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class Annotation:
    """Plate-corner annotation for one media file."""

    q: np.ndarray  # (4, 2) float32 plate corners, clockwise from top-right
    fname: str
    start_frame: int | None = None  # 0-indexed first frame to process

    def scaled(self, factor: float) -> "Annotation":
        return Annotation(self.q * factor, self.fname, self.start_frame)


def load_annotation(path: str | Path) -> Annotation:
    """Load a .mat (reference format) or .npz (native format) annotation."""
    path = Path(path)
    if path.suffix == ".npz":
        data = np.load(path, allow_pickle=False)
        sf = int(data["start_frame"]) if "start_frame" in data else None
        return Annotation(
            q=data["q"].astype(np.float32),
            fname=str(data["fname"]) if "fname" in data else path.stem,
            start_frame=sf,
        )
    import scipy.io

    mat = scipy.io.loadmat(str(path))
    q = mat["q"].astype(np.float32)
    fname = str(mat["fname"][0]) if "fname" in mat else path.stem
    start = None
    if "startFrame" in mat:
        # MATLAB is 1-indexed; the Python driver's 0-indexed equivalent is -1.
        start = int(np.asarray(mat["startFrame"]).ravel()[0]) - 1
    return Annotation(q=q, fname=fname, start_frame=start)


def save_annotation(path: str | Path, ann: Annotation) -> None:
    """Persist an annotation in the native .npz format."""
    payload = {"q": ann.q.astype(np.float32), "fname": np.str_(ann.fname)}
    if ann.start_frame is not None:
        payload["start_frame"] = np.int64(ann.start_frame)
    np.savez(str(path), **payload)


def find_annotation(media_path: str | Path, search_dirs: list[str | Path]) -> Path:
    """Locate ``<name>.mat`` / ``<name>.npz`` for a media file in search dirs."""
    name = Path(media_path).name
    for d in search_dirs:
        for suffix in (".mat", ".npz"):
            cand = Path(d) / f"{name}{suffix}"
            if cand.exists():
                return cand
    raise FileNotFoundError(
        f"no annotation ({name}.mat/.npz) found in {[str(d) for d in search_dirs]}"
    )
