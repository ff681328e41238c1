"""What the port's run-level tests share: the small synthetic clip's size and
the configurations of both packages, JAX's RANSAC noise in the order each JAX
runner draws it, and the clip behind the JAX package's reader interface."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import velocity_tpu.ingest.native_loader as jax_native_loader
import velocity_tpu.ingest.video as jax_video
import velocity_tpu.pipeline.speedest as jax_speedest
from velocity_tpu.camera.annotations import Annotation as JaxAnnotation
from velocity_tpu.camera.database import camera_info as jax_camera_info
from velocity_tpu.config import PipelineConfig as JaxPipelineConfig
from velocity_tpu.config import SolverConfig as JaxSolverConfig
from velocity_tpu.config import TrackerConfig as JaxTrackerConfig
from velocity_tpu_torch.config import PipelineConfig, SolverConfig, TrackerConfig
from velocity_tpu_torch.pipeline import tracker as port_tracker
from velocity_tpu_torch.testing.synthetic_clip import render_clip

N_FRAMES, WIDTH, HEIGHT = 8, 480, 270
MSV, FEATURES, TRIALS = 3, 128, 64
SCALE = 0.5


def make_clip():
    return render_clip(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, seed=0)


def _cfg(lk_backend="lanes", anchor="msv", **tracker):
    return PipelineConfig(solver=SolverConfig(dtype="float32"), msv_frame=MSV, anchor=anchor,
                          tracker=TrackerConfig(max_features=FEATURES, ransac_trials=TRIALS,
                                                lk_backend=lk_backend, **tracker))


def _jcfg(lk_backend="lanes", anchor="msv", **tracker):
    return JaxPipelineConfig(solver=JaxSolverConfig(dtype="float32"), msv_frame=MSV,
                             anchor=anchor,
                             tracker=JaxTrackerConfig(max_features=FEATURES,
                                                      ransac_trials=TRIALS,
                                                      lk_backend=lk_backend, **tracker))


def _jax_info(clip):
    """The clip's CameraInfo as the JAX package's type (its intrinsics are JAX)."""
    info = jax_camera_info("synthetic.MOV", "iPhone 6s", width=WIDTH, height=HEIGHT,
                           fps=30.0, frame_count=N_FRAMES)
    return dataclasses.replace(info, focal_pix=np.asarray(clip.reader.info.focal_pix))


def _frame_draws(frame_key):
    """The two Gumbel draws of one frame step: stage 1 and stage 2 each
    split the frame's key once."""
    key, k1 = jax.random.split(frame_key)
    key, k2 = jax.random.split(key)
    return [torch.as_tensor(np.array(jax.random.gumbel(k, (TRIALS, FEATURES),
                                                       dtype=jnp.float32)))
            for k in (k1, k2)]


def _jax_gumbel(n_frames):
    """JAX's RANSAC noise in the order the scan runner draws it: the key of
    frame j is split(PRNGKey(0), n)[j]."""
    keys = jax.random.split(jax.random.PRNGKey(0), n_frames)
    return keys, [g for j in range(1, n_frames) for g in _frame_draws(keys[j])]


def _jax_gumbel_driver(n_frames):
    """JAX's RANSAC noise in the order the per-frame driver draws it: the
    run's key is split once per frame, key, key_j = split(key)."""
    key = jax.random.PRNGKey(0)
    keys, draws = [None], []
    for _ in range(1, n_frames):
        key, kf = jax.random.split(key)
        keys.append(kf)
        draws += _frame_draws(kf)
    return keys, draws


def _inject(monkeypatch, draws):
    """Hand the port's RANSAC the given noise, one draw per call, in order."""
    real_ransac = port_tracker.estimate_affine_ransac

    def ransac_with_jax_noise(*args, **kwargs):
        kwargs["gumbel"] = draws.pop(0)
        return real_ransac(*args, **kwargs)

    monkeypatch.setattr(port_tracker, "estimate_affine_ransac", ransac_with_jax_noise)


class _JaxReader:
    """The synthetic clip behind the JAX package's VideoReader interface."""

    def __init__(self, clip):
        self.info = _jax_info(clip)
        self._clip = clip

    def frames(self, *args, **kwargs):
        return self._clip.reader.frames(*args, **kwargs)

    prefetch = frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _no_native_loader(*args, **kwargs):
    raise OSError("frames come from the synthetic clip")


def _jax_reads_clip(monkeypatch, clip):
    """Make the JAX runners decode ``clip``: returns the annotation to pass."""
    for module in (jax_video, jax_speedest):  # the driver binds the name at import
        monkeypatch.setattr(module, "VideoReader", lambda *a, **k: _JaxReader(clip))
    monkeypatch.setattr(jax_native_loader, "NativeVideoStream", _no_native_loader)
    ann = clip.annotation
    return JaxAnnotation(ann.q, ann.fname, ann.start_frame)
