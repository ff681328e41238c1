"""The speed-estimation pipeline: tracker, frame-0 init, the MSV and BA
re-anchors, the per-frame driver ``SpeedEstimator``, the batch runner
``ScanSpeedRunner`` and the 9-column report."""

from velocity_tpu_torch.pipeline.speedest import RunResult, SpeedEstimator
from velocity_tpu_torch.pipeline.tracker import ThreeStageTracker, TrackOutput

__all__ = ["RunResult", "SpeedEstimator", "ThreeStageTracker", "TrackOutput"]
