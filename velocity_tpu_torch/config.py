"""Typed configuration for the whole pipeline.

The reference hardcodes every constant (driver toggles are code edits, KLT
params are dicts in code, LM constants inline — see SURVEY.md §5 "Config").
Here they are first-class dataclasses with the reference values as defaults,
wired to the CLI in ``velocity_tpu_torch.cli``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class LKConfig:
    """One Lucas-Kanade pass configuration.

    Defaults mirror the reference's ``lk_coarse``/``lk_fine`` dicts
    (reference utils/KLT.py:106-107).
    """

    window: int = 15  # odd window side
    max_level: int = 4  # pyramid levels above full-res
    max_iters: int = 10
    eps: float = 0.1  # termination: |delta| < eps (pixels at that level)
    min_eig_threshold: float = 1e-4  # OpenCV minEigThreshold semantics


@dataclass(frozen=True)
class TrackerConfig:
    """Three-stage KLT tracker configuration (reference KLTmain, KLT.py:99-134)."""

    coarse_scale: float = 0.25  # stage-1 image downscale
    # "lanes" (lanes-last stencil, fastest on TPU) | "fast" (matmul-formulated)
    # | "reference" (gather)
    lk_backend: str = "lanes"
    lk_coarse: LKConfig = field(default_factory=lambda: LKConfig(15, 4, 10, 0.1))
    lk_fine: LKConfig = field(default_factory=lambda: LKConfig(51, 0, 30, 0.001))
    fb_threshold_coarse: float = 1.0  # stage-2 forward-backward gate (px)
    fb_threshold_fine: float = 0.3  # stage-3 forward-backward gate (px)
    min_affine_inliers: int = 10  # below this, fall back to feature matching
    # Fixed hypothesis batch (cv2 adapts up to 2000 trials at confidence .99;
    # a fixed batch must cover the worst case it will meet: the stills burst
    # has ~15% affine-consistent inliers, where 256 trials miss a pure triple
    # ~40% of the time and 1024 miss ~3%).
    ransac_trials: int = 1024
    ransac_threshold: float = 3.0  # px, cv2.estimateAffine2D default
    max_features: int = 1024  # static feature capacity (incl. 4 plate corners)
    harris_block: int = 5
    harris_quality: float = 0.01
    harris_k: float = 0.04
    subpix_window: int = 5  # cornerSubPix half-window
    subpix_iters: int = 100
    subpix_eps: float = 0.001
    roi_border: tuple[int, int] = (700, 500)  # Harris ROI around plate
    regional_border: int = 50  # KLT regional bbox border
    # Feature-axis sharding (the TP analog, SURVEY §2.4): > 1 shards the
    # track/lane axis of the stage-2/3 forward-backward LK over a
    # ``feature`` mesh axis of this many devices (parallel/track_shard.py).
    # Results are bit-identical to single-device tracking; use for high
    # track capacity or to split the fb legs across a window group's chips.
    shard_features: int = 0
    # Car-anchored affine prior: estimate the stage affines (and the match
    # fallback) from lanes within ``car_margin`` plate diagonals of the
    # tracked plate corners instead of global max-consensus RANSAC. The
    # scene has two motion groups (car vs static background); when the
    # background dominates the detections (sharp wide-baseline stills), the
    # global consensus locks onto it and the fine stage then kills every car
    # track. Default off: the reference's videos are background-blurred
    # single-motion scenes and use the global fit (KLT.py:116-117).
    car_affine: bool = False
    car_margin: float = 4.0  # car-box half-extent, in plate diagonals


@dataclass(frozen=True)
class SolverConfig:
    """LM/GN solver constants (reference NLS.py:102-183, MSV.py:8-49)."""

    max_iters_pose: int = 30
    max_iters_msv: int = 1000
    damping: float = 1.0  # Marquardt damping (identity scale)
    tol: float = 1e-8  # rms(delta) convergence
    ramp_rate: float = 0.2  # step scale = min(((i+1)*ramp_rate)^2, 1)
    dtype: str = "float64"  # solver island dtype ("float32" on TPU-only paths)
    # robust second pass of the translation solve: when the first pass ends
    # with rms residual above `pose_reject_above_px`, points whose residual
    # exceeds `pose_reject_sigma * rms` are masked and the solve repeats from
    # the first solution. Below the gate the second pass re-solves with the
    # full mask from the optimum — a numerical no-op — so well-conditioned
    # clips (the goldens) are untouched. 0 disables.
    pose_reject_sigma: float = 3.0
    pose_reject_above_px: float = 2.0
    # the MSV's start and steps (solvers/triangulate.py:msv_refine_translation):
    # "upstream" starts 1 m beyond the previous camera and takes every damped
    # step (MSV.py:8-42); "tracked" starts at the newest camera's tracked
    # translation and keeps a step only where the cost fell (solvers/lm.py).
    # From upstream's start the solve settles on some clips far from the
    # minimum that fits every track, or cycles to max_iters_msv.
    msv_solve: str = "upstream"


@dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment configuration (reference NLS.py:186-328 + Schur rebuild)."""

    max_iters: int = 10
    damping: float = 1.0
    tol: float = 1e-7
    step_scale: float = 0.9
    schur: bool = True  # use block-sparse Schur complement reduction
    # reduced-camera-system solver: "dense" (factorize) or "cg"
    # (Jacobi-preconditioned conjugate gradients, for long windows where the
    # O((6nc)^3) dense solve overtakes O(iters (6nc)^2) matvecs)
    camera_solver: str = "dense"
    cg_tol: float = 1e-10
    cg_max_iters: int = 100


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout for the sharded paths."""

    points_axis: int = 0  # devices along the track/point-block axis (0 = all)
    windows_axis: int = 1  # devices along the frame-window axis


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end speed-estimation run configuration (reference vidExample.py)."""

    platform: str = "iPhone 6s"
    plate_country: str = "Chile"
    n_frames: int = 20
    read_speed: int = 1  # read every Nth frame
    start_frame: int | None = None  # None -> from annotation
    native_scale: float = 0.5  # 4K annotation -> 2K video (vidExample.py:35-39)
    msv_frame: int = 5  # frame index for the scale transfer
    anchor: str = "msv"  # "msv" (reference active path) | "ba" (windowed BA)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
