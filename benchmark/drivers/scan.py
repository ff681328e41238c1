"""Drives ``ScanSpeedRunner.run``: the scan runner, the main path (decode into
one pinned stack, frame-0 init, two captured segments around the host
re-anchor)."""

from __future__ import annotations

from benchmark.drivers import _port


class Driver(_port.VideoDriver):
    @staticmethod
    def make_runner(pcfg, device):
        from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

        return ScanSpeedRunner(pcfg, device=device)
