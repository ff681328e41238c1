"""The scan speed-estimation pipeline: tracker, frame-0 init, MSV re-anchor,
``ScanSpeedRunner`` and the 9-column report."""
