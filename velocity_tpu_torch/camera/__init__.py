"""Camera intrinsics database and plate-corner annotations."""
