"""Image ops of the scan path: pyramids, sampling (``interp``, ``warp``),
Harris corners, RANSAC and three LK engines: the lanes engine with its slab
extraction (K2) and fused iteration block (K1), the fast engine with its
patch extraction (K3), and the gather engine (``lk``)."""
