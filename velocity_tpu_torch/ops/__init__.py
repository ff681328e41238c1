"""Image ops of the scan path: pyramids, slab extraction (K2), the lanes LK
engine with its fused iteration block (K1), Harris corners and RANSAC."""
