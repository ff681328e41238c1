"""Mesh parallelism: sharded bundle adjustment, frame-window data
parallelism, feature-sharded tracking, pose-graph stitching for long
sequences and window checkpoints (torch twin of ``velocity_tpu/parallel``)."""

from velocity_tpu_torch.parallel.mesh import make_mesh, device_counts  # noqa: F401
from velocity_tpu_torch.parallel.ba_dist import ba_schur_sharded  # noqa: F401
from velocity_tpu_torch.parallel.windows import (  # noqa: F401
    windowed_ba,
    stitch_windows,
    split_windows,
)
