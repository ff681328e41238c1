"""Host-side video decode feeding the device pipeline.

Decode stays on the host CPU (ffmpeg via OpenCV, the same native path the
reference uses at vidExample.py:88-91); frames are converted to grayscale and
prefetched on a background thread so device compute overlaps decode — the
host->HBM pipeline from SURVEY.md §7.3 item 6.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from velocity_tpu_torch.camera.database import CameraInfo, camera_info


@dataclass
class Frame:
    """One decoded grayscale frame plus its capture metadata."""

    index: int  # 0-based frame number within the video
    time_s: float  # capture timestamp (POS_MSEC/1000, probed before read)
    gray: np.ndarray  # (H, W) uint8


class VideoReader:
    """Sequential grayscale frame reader with optional background prefetch.

    Mirrors the reference's decode semantics: CAP_PROP_POS_MSEC/POS_FRAMES are
    read *before* ``cap.read()`` (vidExample.py:88-90), frame skipping reads and
    discards (vidExample.py:83-87), and seeking to the start frame uses
    ``cap.set(1, start)`` (vidExample.py:80-81).
    """

    def __init__(self, path: str | Path, platform: str = "iPhone 6s"):
        import cv2

        self._cv2 = cv2
        self.path = str(path)
        self.cap = cv2.VideoCapture(self.path)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video {self.path}")
        self.info: CameraInfo = camera_info(
            path,
            platform,
            width=self.cap.get(cv2.CAP_PROP_FRAME_WIDTH),
            height=self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT),
            fps=self.cap.get(cv2.CAP_PROP_FPS),
            frame_count=self.cap.get(cv2.CAP_PROP_FRAME_COUNT),
        )

    def seek(self, frame_index: int) -> None:
        if frame_index != 0:
            self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, frame_index)

    def read(self) -> Frame | None:
        cv2 = self._cv2
        time_s = self.cap.get(cv2.CAP_PROP_POS_MSEC) / 1000.0
        index = int(self.cap.get(cv2.CAP_PROP_POS_FRAMES))
        ok, bgr = self.cap.read()
        if not ok:
            return None
        gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        return Frame(index=index, time_s=time_s, gray=gray)

    def skip(self, n: int) -> None:
        for _ in range(n):
            self.cap.read()

    def frames(
        self, start: int = 0, count: int | None = None, step: int = 1
    ) -> Iterator[Frame]:
        """Yield ``count`` frames from ``start``, reading every ``step`` th."""
        self.seek(start)
        i = 0
        while count is None or i < count:
            if i > 0 and step > 1:
                self.skip(step - 1)
            fr = self.read()
            if fr is None:
                return
            yield fr
            i += 1

    def prefetch(
        self, start: int = 0, count: int | None = None, step: int = 1, depth: int = 4
    ) -> Iterator[Frame]:
        """Like ``frames`` but decoded on a background thread (depth-bounded)."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        SENTINEL = object()

        def worker():
            try:
                for fr in self.frames(start, count, step):
                    q.put(fr)
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            yield item
        t.join()

    def release(self) -> None:
        self.cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def open_video(path: str | Path, platform: str = "iPhone 6s") -> VideoReader:
    return VideoReader(path, platform)


def dump_frames(
    video_path: str | Path,
    out_dir: str | Path | None = None,
    step: int = 10,
    limit: int = 2000,
) -> list[str]:
    """Dump every ``step`` th frame of a video to JPGs (reference vid2images.py,
    with its broken ``filenamesplit`` import fixed by construction)."""
    import cv2

    video_path = Path(video_path)
    out = Path(out_dir) if out_dir else video_path.with_suffix("")
    out.mkdir(parents=True, exist_ok=True)
    cap = cv2.VideoCapture(str(video_path))
    written = []
    for i in range(0, limit, step):
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, im = cap.read()
        if not ok:
            break
        dest = str(out / f"{i}.jpg")
        cv2.imwrite(dest, im)
        written.append(dest)
    cap.release()
    return written
