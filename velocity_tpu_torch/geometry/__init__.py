"""Geometry core: rotations, pinhole projection, spherical coordinates, plate geometry.

Torch twins of ``velocity_tpu.geometry`` with the same conventions: row-vector
points rotate as ``x @ C``; pinhole ``u = (fx*X + skew*Y)/Z + cx``.
"""
