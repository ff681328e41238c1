"""Image ops of the speed pipeline: pyramids, sampling (``interp``, ``warp``),
Harris corners, RANSAC, masked sigma clipping, the feature-match rescue
(``match``, host side) and three LK engines: the lanes engine with its slab
extraction (K2) and fused iteration block (K1), the fast engine with its
patch extraction (K3), and the gather engine (``lk``)."""

from velocity_tpu_torch.ops.robust import sigma_rejection

__all__ = ["sigma_rejection"]
