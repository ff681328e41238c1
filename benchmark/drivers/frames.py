"""Drives ``SpeedEstimator.run``: the per-frame driver behind the ``speed``
command (one upload, one replay of the captured step and one stage-2 read
per frame)."""

from __future__ import annotations

from benchmark.drivers import _port


class Driver(_port.VideoDriver):
    @staticmethod
    def make_runner(pcfg, device):
        from velocity_tpu_torch.pipeline.speedest import SpeedEstimator

        return SpeedEstimator(pcfg, device=device)
