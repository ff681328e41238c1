"""Drives ``StillsSpeedEstimator.run``: the stills driver (``car_affine``
forced, replenishment and promotion from the MSV frame on, georegistration
from the burst's GPS fix and heading)."""

from __future__ import annotations

from benchmark.drivers import _port


class Driver(_port.VideoDriver):
    @staticmethod
    def make_runner(pcfg, device):
        from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator

        return StillsSpeedEstimator(pcfg, device=device)

    def prepare(self, clip):
        sc = self.config["scene"]
        info = _port.camera(self.config, self.pcfg, len(clip.grays))
        reader = _port.BurstReader(clip.grays, info, sc["fps"] / sc["stride"],
                                   self.config["gps_fix"], self.config["yaw_deg"])
        return reader, _port.annotation(self.config, self.pcfg, clip.truth.corners_px)

    def __call__(self, item) -> dict:
        reader, ann = item
        res = self.runner.run(reader, annotation=ann, verbose=False, **self.traffic["call"])
        return _port.answers(res)
