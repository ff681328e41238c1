"""velocity_tpu_torch — the PyTorch/CUDA port of velocity_tpu.

Speed estimation runs end to end on an NVIDIA Hopper GPU, as a batch over a
clip (``pipeline.scan.ScanSpeedRunner``), one frame at a time with the
feature-match rescue (``SpeedEstimator``), over a stills burst with EXIF
timing and GPS georegistration (``pipeline.stills.StillsSpeedEstimator``),
over several clips at once (``pipeline.multivideo.run_batch``) or over a
whole video in windows with replenishment, checkpoints, resume, segment
retry and windowed BA refinement (``pipeline.longvideo.LongVideoRunner``),
with any of the three LK engines (``TrackerConfig(lk_backend=...)``) and
with the MSV or the bundle-adjustment re-anchor
(``PipelineConfig(anchor=...)``; ``solvers.schur.ba_schur``,
``solvers.ba``). ``parallel/`` holds the sharded paths: point-sharded and
windowed Schur BA, feature-sharded LK (``TrackerConfig(shard_features=n)``),
meshes with an in-process and a ``torch.distributed`` back end, the
multi-process launch and the window checkpoints. Plain tensor code is
PyTorch; the three TPU kernels of those paths are CUDA C++ under ``csrc/``
(built with nvcc for sm_90a at first use, loaded with ctypes, see
``cuda_build``):

- K2, slab extraction (``ops/slab_pallas.py``), replacing
  ``velocity_tpu/ops/slab_pallas.py:extract_slabs_dma``;
- K1, the fused LK iteration block (``ops/lk_block_pallas.py``), replacing
  ``velocity_tpu/ops/lk_block_pallas.py:lk_block``;
- K3, patch extraction for the fast LK engine (``ops/patch_pallas.py``),
  replacing ``velocity_tpu/ops/patch_pallas.py:extract_patches_pallas``.

Module names follow ``velocity_tpu`` one to one. This package never imports
jax or velocity_tpu; the tests import both and compare them.
"""

__version__ = "0.1.0"

import torch as _torch

# SfM correctness requires true-f32 arithmetic: reduced-precision matmuls or
# convolutions inject ~5 px projection error on distant points (the same
# reason velocity_tpu sets jax_default_matmul_precision="highest").
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from velocity_tpu_torch.pipeline import RunResult, SpeedEstimator  # noqa: E402

__all__ = ["RunResult", "SpeedEstimator"]
