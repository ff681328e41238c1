"""The port's host modules against the JAX package's (CPU): the native
loader and the scan runner's choice of decoder for a path, the report
plots, the known dataset runs, and mirrors of the JAX oracle tests of the
report table and the ROI helpers (``tests/test_aux.py``: ``TestReport``,
``TestROI``, and the data-gated ``TestNativeLoader`` with its gate).

Decoding reads the small clip of ``tests/_torch_clip.py`` written to a
lossless FFV1 ``.avi`` (``write_clip_file``), which cv2 and the native
loader (``native/libvelocity_host.so``, OpenCV) both decode here."""

import dataclasses
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_clip import _cfg, make_clip, write_clip_file

import velocity_tpu.ingest.native_loader as jax_native_loader
import velocity_tpu.pipeline.datasets as jax_datasets
from velocity_tpu.pipeline.scan import _decode_stack as jax_decode_stack
from velocity_tpu.viz import plots as jax_plots
from velocity_tpu_torch.camera.database import camera_info
from velocity_tpu_torch.ingest import native_loader
from velocity_tpu_torch.ingest.video import VideoReader
from velocity_tpu_torch.pipeline import datasets, report
from velocity_tpu_torch.pipeline import scan as port_scan
from velocity_tpu_torch.pipeline.roi import bounding_rect, inside_bbox
from velocity_tpu_torch.pipeline.scan import ScanSpeedRunner
from velocity_tpu_torch.pipeline.speedest import RunResult
from velocity_tpu_torch.viz import plots

torch.set_num_threads(1)

IMG_4134 = f"{datasets.DATA}/IMG_4134.MOV"
HAVE_DATA = Path(IMG_4134).exists()
N_FRAMES = 8


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    return write_clip_file(make_clip(), tmp_path_factory.mktemp("clip"))


@pytest.fixture
def needs_native():
    if not jax_native_loader.available():
        pytest.skip("the JAX package's native loader does not load here")


# ------------------------------------------------------------- native loader


def test_native_stream_matches_jax(clip_file, needs_native):
    """Frames, 1/4-scale frames, times and indices equal JAX's binding's."""
    video = str(clip_file[0])
    kw = dict(start=2, count=5, step=2)
    with native_loader.NativeVideoStream(video, **kw) as s:
        port = list(s)
        dims = (s.width, s.height, s.fps, s.frame_count, s.small_size)
    with jax_native_loader.NativeVideoStream(video, **kw) as s:
        jax = list(s)
        assert dims == (s.width, s.height, s.fps, s.frame_count, s.small_size)
    assert [f[3] for f in port] == [f[3] for f in jax] == [2, 4, 6, 8]
    for a, b in zip(port, jax):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]


def test_native_loader_builds_outside_native(monkeypatch, tmp_path, needs_native):
    """Without ``native/libvelocity_host.so`` the library is built with
    make into ``BUILD_DIR``; ``native/`` is not written."""
    before = sorted(p.name for p in native_loader._NATIVE_DIR.iterdir())
    monkeypatch.setattr(native_loader, "_SO", tmp_path / "absent" / "libvelocity_host.so")
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    assert native_loader.available()
    assert (tmp_path / "build" / "libvelocity_host.so").exists()
    assert sorted(p.name for p in native_loader._NATIVE_DIR.iterdir()) == before


def test_native_loader_unbuildable_is_unavailable(monkeypatch, tmp_path):
    """A library that cannot be built or loaded makes ``available()`` False
    and the stream raise OSError (the decoders then use the Python reader)."""
    monkeypatch.setattr(native_loader, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native_loader, "_SO", tmp_path / "libvelocity_host.so")
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    assert not native_loader.available()
    with pytest.raises(OSError):
        native_loader.NativeVideoStream("clip.avi")


# ------------------------------------------------------------ decoder choice


def test_scan_runner_decodes_a_path_natively(clip_file, needs_native):
    """Given a path, the scan runner decodes through the native loader, as
    JAX's does: its time column is the one JAX's ``_decode_stack`` returns
    for the file (index / fps; cv2's reader is one frame behind)."""
    video, annotation, scale = clip_file
    cfg = dataclasses.replace(_cfg(), native_scale=scale)
    res = ScanSpeedRunner(cfg, device="cpu").run(str(video), annotation=str(annotation),
                                                 n_frames=N_FRAMES, verbose=False)
    _grays, times, indices, _ = jax_decode_stack(str(video), None, 1, N_FRAMES, 1)
    assert res.timings["decoder"] == "native"
    np.testing.assert_array_equal(res.B[:, 12], times)
    np.testing.assert_array_equal(res.B[:, 13], indices)
    assert np.isfinite(res.S[1:, 8]).all()


@pytest.mark.parametrize("decoder", ["python", "reader"])
def test_decode_falls_back_to_the_reader(clip_file, monkeypatch, decoder):
    """Where the native loader does not load, a path decodes through the
    cv2 reader ("python"); a reader object always does ("reader"). Frames,
    times and indices are the reader's."""

    def unavailable(*args, **kwargs):
        raise OSError("no native loader")

    monkeypatch.setattr(native_loader, "NativeVideoStream", unavailable)
    video = str(clip_file[0])
    with VideoReader(video) as vr:
        stack, times, indices, got = port_scan._decode(
            vr, 1, N_FRAMES, 1, pin=False, path=video if decoder == "python" else None)
    with VideoReader(video) as vr:
        want = list(vr.frames(start=1, count=N_FRAMES))
    assert got == decoder
    np.testing.assert_array_equal(stack.numpy(), np.stack([f.gray for f in want]))
    np.testing.assert_array_equal(times, [f.time_s for f in want])
    np.testing.assert_array_equal(indices, [f.index for f in want])


# --------------------------------------------------------------------- plots


def _run_result(n=6, N=40, seed=0):
    """A RunResult of numpy arrays (no run): a car receding at ~40 km/h."""
    rng = np.random.default_rng(seed)
    S = np.zeros((n, 9))
    S[:, 0] = np.arange(n)
    S[:, 3] = rng.uniform(0.05, 0.2, n)
    S[:, 5] = np.arange(n) / 30
    S[:, 7] = np.cumsum(np.r_[0, rng.uniform(0.35, 0.39, n - 1)])
    S[1:, 8] = np.diff(S[:, 7]) * 30 * 3.6
    B = np.zeros((n, 14))
    B[:, 0:3] = np.stack([0.1 * rng.normal(size=n), np.zeros(n), 3 + S[:, 7]], axis=1)
    track = rng.uniform(100, 380, (n, N, 2)).astype(np.float32)
    valid = rng.random((n, N)) > 0.2
    track[~valid] = np.nan
    proj = track + rng.normal(0, 0.3, track.shape).astype(np.float32)
    gray = rng.integers(0, 255, (270, 480), dtype=np.uint8)
    return RunResult(S=S, B=B, track_px=track, proj_px=proj, valid=valid,
                     plate_box=(200, 260, 120, 150), roi_box=(150, 300, 90, 200),
                     camera=camera_info("clip.MOV", width=480, height=270),
                     first_gray=gray, last_gray=gray[::-1].copy())


def _png_pixels(fig):
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=60)
    plt.close(fig)
    return np.asarray(Image.open(io.BytesIO(buf.getvalue())))


def test_plot_results_draws_what_jax_draws():
    pytest.importorskip("matplotlib")
    res = _run_result()
    port, jax = _png_pixels(plots.plot_results(res)), _png_pixels(jax_plots.plot_results(res))
    assert port.shape == jax.shape and port.std() > 0
    np.testing.assert_array_equal(port, jax)


def test_html_report_table_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    res = _run_result()
    tables = []
    for name, module in (("port", plots), ("jax", jax_plots)):
        path = tmp_path / f"{name}.html"
        assert module.save_results_html(res, path) == str(path)
        html = path.read_text()
        assert "data:image/png;base64," in html
        tables.append(re.search(r"<pre>(.*)</pre>", html, re.S).group(1))
    assert tables[0] == tables[1]
    assert report.summary(res.S) in tables[0]


# ------------------------------------------------------------------ datasets


def test_known_runs_match_jax():
    """Every field equal to JAX's; IMG_4238's annotation is this
    repository's data/IMG_4238.MOV.npz in both (JAX's path is absolute)."""
    assert list(datasets.KNOWN_RUNS) == list(jax_datasets.KNOWN_RUNS)
    for name, run in datasets.KNOWN_RUNS.items():
        port, jax = dataclasses.asdict(run), dataclasses.asdict(jax_datasets.KNOWN_RUNS[name])
        if name == "IMG_4238":
            assert Path(port.pop("annotation")) == datasets.REPO_DATA / "IMG_4238.MOV.npz"
            assert jax.pop("annotation").endswith("/data/IMG_4238.MOV.npz")
            assert (datasets.REPO_DATA / "IMG_4238.MOV.npz").exists()
        assert port == jax, name


@pytest.mark.parametrize("name", ["IMG_4134", "img_4119.mov", "data/IMG_4238.MOV", "4134",
                                  "/somewhere/data/IMG_4119.MOV"])
def test_known_run_lookup_matches_jax(name):
    assert datasets.known_run(name).name == jax_datasets.known_run(name).name


def test_known_run_unknown_raises():
    for module in (datasets, jax_datasets):
        with pytest.raises(KeyError, match="unknown run"):
            module.known_run("IMG_9999")


# --------------------------------------- mirrors of tests/test_aux.py:17-83


class TestReport:
    def test_header_matches_reference_layout(self):
        lines = [ln for ln in report.header().split("\n") if ln]
        # two lines of 9 right-aligned 13-wide columns
        assert len(lines) == 2
        assert all(len(ln) == 13 * 9 for ln in lines)
        assert "pointTracks" in lines[0] and "(km/h)" in lines[1]

    def test_row_format(self):
        r = report.row([1, 0.123, 151, 0.876, 0.033, 0.5, 0.37, 3.7, 39.9])
        assert len(r) == 13 * 9
        assert r.endswith("39.9")

    def test_summary(self):
        S = np.zeros((3, 9))
        S[1:, 8] = [40.0, 38.0]
        S[1:, 3] = [0.9, 1.1]
        s = report.summary(S)
        assert "39.00" in s and "1.000" in s

    def test_polyfit_speed_recovers_polynomial_motion(self):
        # distance d(t) = 5t + t^2 -> speed (m/s) = 5 + 2t, exactly recovered
        n = 12
        S = np.zeros((n, 9))
        t = np.arange(n) * 0.1
        S[:, 5] = t
        S[:, 7] = 5 * t + t**2
        S[:, 8] = np.nan  # noisy per-frame speeds the fit should not depend on
        dist_fit, speed_fit = report.polyfit_speed(S, degree=2)
        np.testing.assert_allclose(dist_fit, S[:, 7], atol=1e-9)
        np.testing.assert_allclose(speed_fit, (5 + 2 * t) * 3.6, atol=1e-8)

    def test_polyfit_speed_short_input_passthrough(self):
        S = np.zeros((2, 9))
        S[:, 5] = [0.0, 0.1]
        S[:, 7] = [0.0, 1.0]
        S[:, 8] = [np.nan, 36.0]
        d, v = report.polyfit_speed(S, degree=3)
        np.testing.assert_allclose(d, S[:, 7])
        np.testing.assert_allclose(v, S[:, 8])


class TestROI:
    def test_bounding_rect_matches_cv2(self):
        import cv2

        rng = np.random.default_rng(0)
        for _ in range(20):
            pts = rng.uniform(10, 500, (6, 2)).astype(np.float32)
            x, y, w, h = cv2.boundingRect(pts)
            x0, x1, y0, y1 = bounding_rect(pts, (1080, 1920), border=(0, 0))
            assert (x0, y0) == (x, y)
            assert (x1, y1) == (x + w, y + h)

    def test_clamping(self):
        pts = np.array([[5.0, 3.0], [2000.0, 1100.0]], np.float32)
        x0, x1, y0, y1 = bounding_rect(pts, (1080, 1920), border=(50, 50))
        assert x0 == 1 and y0 == 1 and x1 == 1920 and y1 == 1080

    def test_inside_bbox(self):
        box = (10, 20, 10, 20)
        pts = np.array([[15, 15], [10, 15], [25, 15]])
        np.testing.assert_array_equal(inside_bbox(pts, box), [True, False, False])


@pytest.mark.skipif(not HAVE_DATA, reason="dataset not mounted")
class TestNativeLoader:
    """Mirror of ``tests/test_aux.py::TestNativeLoader`` (data-gated)."""

    def test_decode_matches_python_reader(self):
        if not native_loader.available():
            pytest.skip("native loader unavailable")
        with native_loader.NativeVideoStream(IMG_4134, start=19, count=4) as s:
            nat = list(s)
        assert [f[3] for f in nat] == [19, 20, 21, 22]
        # timestamps: frame/fps
        np.testing.assert_allclose(nat[0][2], 19 / 29.97, atol=1e-3)
        with VideoReader(IMG_4134) as vr:
            ref = list(vr.frames(start=19, count=1))[0]
        d = np.abs(ref.gray.astype(int) - nat[0][0].astype(int))
        assert d.mean() < 2.0  # codec-build rounding only
        # the small image is the 1/4 decimation
        assert nat[0][1].shape == (270, 480)

    def test_throughput(self):
        import time

        if not native_loader.available():
            pytest.skip("native loader unavailable")
        t0 = time.time()
        with native_loader.NativeVideoStream(IMG_4134, start=0, count=40) as s:
            k = sum(1 for _ in s)
        fps = k / (time.time() - t0)
        assert k == 40 and fps > 20, fps
