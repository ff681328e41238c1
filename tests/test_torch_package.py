"""Package rules of the PyTorch port: it never imports JAX, and a CUDA tensor
never silently takes a kernel's plain version."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from velocity_tpu_torch import cuda_build
from velocity_tpu_torch.ops import lk_block_pallas, patch_pallas, slab_pallas

ROOT = Path(__file__).resolve().parent.parent

MODULES = [
    "bench_ba_torch",
    "bench_torch",
    "graft_entry_torch",
    "velocity_tpu_torch",
    "velocity_tpu_torch.camera.exif",
    "velocity_tpu_torch.cli",
    "velocity_tpu_torch.convert",
    "velocity_tpu_torch.cuda_build",
    "velocity_tpu_torch.geometry.geodesy",
    "velocity_tpu_torch.geometry.norms",
    "velocity_tpu_torch.ingest.native_loader",
    "velocity_tpu_torch.ingest.stills",
    "velocity_tpu_torch.ops.harris",
    "velocity_tpu_torch.ops.interp",
    "velocity_tpu_torch.ops.lk",
    "velocity_tpu_torch.ops.lk_fast",
    "velocity_tpu_torch.ops.lk_lanes",
    "velocity_tpu_torch.ops.match",
    "velocity_tpu_torch.ops.patch_pallas",
    "velocity_tpu_torch.ops.ransac",
    "velocity_tpu_torch.ops.robust",
    "velocity_tpu_torch.ops.slab_pallas",
    "velocity_tpu_torch.ops.warp",
    "velocity_tpu_torch.ops.window",
    "velocity_tpu_torch.parallel",
    "velocity_tpu_torch.parallel.ba_dist",
    "velocity_tpu_torch.parallel.checkpoint",
    "velocity_tpu_torch.parallel.launch",
    "velocity_tpu_torch.parallel.mesh",
    "velocity_tpu_torch.parallel.track_shard",
    "velocity_tpu_torch.parallel.windows",
    "velocity_tpu_torch.pipeline.anchor",
    "velocity_tpu_torch.pipeline.datasets",
    "velocity_tpu_torch.pipeline.longvideo",
    "velocity_tpu_torch.pipeline.multivideo",
    "velocity_tpu_torch.pipeline.scan",
    "velocity_tpu_torch.pipeline.speedest",
    "velocity_tpu_torch.pipeline.stills",
    "velocity_tpu_torch.pipeline.step_graph",
    "velocity_tpu_torch.pipeline.tracker",
    "velocity_tpu_torch.solvers.ba",
    "velocity_tpu_torch.solvers.linear_init",
    "velocity_tpu_torch.solvers.pose",
    "velocity_tpu_torch.solvers.schur",
    "velocity_tpu_torch.solvers.triangulate",
    "velocity_tpu_torch.testing.synthetic_clip",
    "velocity_tpu_torch.utils",
    "velocity_tpu_torch.utils.profiling",
    "velocity_tpu_torch.utils.strings",
    "velocity_tpu_torch.viz",
    "velocity_tpu_torch.viz.plots",
]


def test_import_pulls_in_no_jax():
    """A fresh interpreter that imports every port module (and the root
    ``graft_entry_torch.py``, ``bench_torch.py`` and ``bench_ba_torch.py``)
    has no jax, jaxlib or velocity_tpu module loaded."""
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'velocity_tpu'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout


def test_import_sets_true_f32():
    import velocity_tpu_torch  # noqa: F401

    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


class _OnCuda:
    """Stands in for a CUDA tensor on a machine with no card and no nvcc."""

    device = torch.device("cuda")
    dtype = torch.float32
    shape = (4, 24, 24)


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA tensor must not take the plain version")


def _no_nvcc():
    raise RuntimeError("nvcc not found")


def test_cuda_tensor_without_kernel_library_raises(monkeypatch, tmp_path):
    """Where the kernels cannot be built, a CUDA tensor handed to a wrapper
    raises; no wrapper falls back to its plain version."""
    monkeypatch.setattr(slab_pallas, "extract_slabs_ref", _no_plain)
    monkeypatch.setattr(lk_block_pallas, "block_iters_ref", _no_plain)
    monkeypatch.setattr(patch_pallas, "extract_patches_ref", _no_plain)
    monkeypatch.setattr(cuda_build, "_lib", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", _no_nvcc)
    x = _OnCuda()
    with pytest.raises(RuntimeError, match="nvcc"):
        slab_pallas.extract_slabs(x, x, 24)
    with pytest.raises(RuntimeError, match="nvcc"):
        lk_block_pallas.lk_block(*([x] * 14), 0, win=15, n_taps=8, cubic=False,
                                 eps=0.1, Wd=64, Hd=64)
    with pytest.raises(RuntimeError, match="nvcc"):
        patch_pallas.extract_patches(x, x, 24)


def test_other_devices_are_refused():
    meta = torch.empty((30, 30), device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        slab_pallas.extract_slabs(meta, idx.reshape(1, 2), 24)
    with pytest.raises(ValueError, match="unsupported device"):
        patch_pallas.extract_patches(meta, idx.reshape(1, 2), 24)


def test_runner_refuses_cuda_without_a_card():
    from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ScanSpeedRunner(device="cuda")


@pytest.mark.parametrize("entry", ["StillsSpeedEstimator", "run_batch"])
def test_stills_and_batch_refuse_cuda_without_a_card(entry):
    """The stills driver and the batch runner default to the card and raise
    without one, before they open any input."""
    from velocity_tpu_torch.pipeline.multivideo import run_batch
    from velocity_tpu_torch.pipeline.stills import StillsSpeedEstimator

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    call = {"StillsSpeedEstimator": StillsSpeedEstimator,
            "run_batch": lambda: run_batch(["a.MOV", "b.MOV"])}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_unported_options_raise():
    """No option is left unported: ``shard_features=2`` with the lanes
    engine selects the feature-sharded forward-backward LK (a hook over a
    two-shard ``feature`` mesh on the points' device), where it used to
    raise; without sharding the plain lanes forward-backward stays."""
    from velocity_tpu_torch.config import TrackerConfig
    from velocity_tpu_torch.ops import lk_lanes
    from velocity_tpu_torch.parallel import track_shard
    from velocity_tpu_torch.pipeline import tracker

    seen = []

    def recording(src, dst, pts, mesh, axis, **kw):
        seen.append((mesh.shape, [mesh.device(feature=s) for s in range(2)], axis, sorted(kw)))
        return "sharded"

    real = track_shard.lk_forward_backward_sharded
    track_shard.lk_forward_backward_sharded = recording
    try:
        pyr, fb = tracker._lk_impls(TrackerConfig(shard_features=2))
        out = fb("src", "dst", torch.zeros(4, 2), src_pyr="a", dst_pyr="b", win=15)
    finally:
        track_shard.lk_forward_backward_sharded = real
    cpu = torch.device("cpu")
    assert pyr is lk_lanes.lk_pyramidal_lanes
    assert out == "sharded" and seen == [({"feature": 2}, [cpu, cpu], "feature", ["win"])]
    assert tracker._lk_impls(TrackerConfig(shard_features=1))[1] is \
        lk_lanes.lk_forward_backward_lanes


def test_lk_backends_select_their_engine():
    """``lk_backend`` picks the LK engine as in JAX: "lanes" (on the carried
    pyramids), "fast", and any other value the gather engine."""
    from velocity_tpu_torch.config import TrackerConfig
    from velocity_tpu_torch.ops import lk, lk_fast, lk_lanes
    from velocity_tpu_torch.pipeline.tracker import _lk_impls, _pyr_kw

    want = {
        "lanes": (lk_lanes.lk_pyramidal_lanes, lk_lanes.lk_forward_backward_lanes),
        "fast": (lk_fast.lk_pyramidal_fast, lk_fast.lk_forward_backward_fast),
        "reference": (lk.lk_pyramidal, lk.lk_forward_backward),
    }
    for backend, fns in want.items():
        cfg = TrackerConfig(lk_backend=backend)
        assert _lk_impls(cfg) == fns
        assert _pyr_kw(cfg, "a", "b") == ({"src_pyr": "a", "dst_pyr": "b"}
                                          if backend == "lanes" else {})
    # feature sharding exists only for the lanes engine; the others ignore it
    assert _lk_impls(TrackerConfig(lk_backend="fast", shard_features=2)) == want["fast"]


def test_library_name_follows_the_sources():
    """The kernel library is keyed by a hash of csrc/*.cu, csrc/*.cuh and
    the flags; an edited header renames it."""
    p = cuda_build.library_path()
    assert p.parent == cuda_build.BUILD_DIR and p.name.startswith("libvt_kernels_")
    assert sorted(s.name for s in cuda_build._sources()) == ["lk_block.cu", "patch.cu",
                                                             "slab.cu", "source_window.cu",
                                                             "subpix.cu", "warp_window.cu"]
    assert [s.name for s in cuda_build._headers()] == ["window.cuh"]


def test_library_name_hashes_headers(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "h.cuh"\n')
    (src / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "SRC_DIR", src)
    before = cuda_build.library_path()
    (src / "h.cuh").write_text("// two\n")
    assert cuda_build.library_path() != before
