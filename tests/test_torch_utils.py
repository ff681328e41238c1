"""The port's host-only modules against the JAX package's, and mirrors of the
JAX oracle tests for them (CPU): ``geometry/geodesy.py``
(``tests/test_geometry.py::TestGeodesy``), ``pipeline/stills.py:
georegister_track`` (``tests/test_stills_e2e.py::TestGeoregister``),
``utils/`` (``tests/test_aux.py::TestUtils``, plus ``trace`` writing a file),
and ``camera/exif.py`` with ``ingest/stills.py:StillsReader`` on two small
JPEGs written with PIL, in place of the data-gated EXIF tests of
``tests/test_camera_ingest.py``."""

import numpy as np
import pytest
from PIL import Image
from PIL.TiffImagePlugin import IFDRational

import velocity_tpu.camera.exif as jax_exif
import velocity_tpu.geometry.geodesy as jax_geodesy
from velocity_tpu.ingest.stills import StillsReader as JaxStillsReader
from velocity_tpu.pipeline.stills import georegister_track as jax_georegister_track
from velocity_tpu_torch.camera import exif
from velocity_tpu_torch.geometry.geodesy import ecef_to_lla, ecef_to_ned, lla_to_ecef, ned_to_ecef
from velocity_tpu_torch.ingest.stills import StillsReader
from velocity_tpu_torch.pipeline.stills import georegister_track
from velocity_tpu_torch.utils import StageTimer, filename_split, trace

RNG = np.random.default_rng(0)


class TestGeodesy:
    def test_lla_ecef_roundtrip(self):
        lla = np.stack(
            [RNG.uniform(-80, 80, 10), RNG.uniform(-179, 179, 10), RNG.uniform(0, 4000, 10)],
            axis=1,
        )
        ecef = lla_to_ecef(lla)
        np.testing.assert_allclose(ecef_to_lla(ecef), lla, atol=1e-6)
        np.testing.assert_array_equal(ecef, jax_geodesy.lla_to_ecef(lla))
        np.testing.assert_array_equal(ecef_to_lla(ecef), jax_geodesy.ecef_to_lla(ecef))

    def test_known_point(self):
        # Equator/prime meridian at 0 altitude -> (a, 0, 0)
        np.testing.assert_allclose(lla_to_ecef([0.0, 0.0, 0.0]), [6378137.0, 0, 0], atol=1e-6)
        # North pole -> z = b
        np.testing.assert_allclose(
            lla_to_ecef([90.0, 0.0, 0.0]), [0, 0, 6356752.3142], atol=1e-3
        )

    def test_ned_roundtrip_and_orientation(self):
        origin = np.array([-33.45, -70.66, 520.0])  # Santiago-ish
        pts_ned = RNG.normal(size=(8, 3)) * 100
        ecef = ned_to_ecef(pts_ned, origin)
        np.testing.assert_allclose(ecef_to_ned(ecef, origin), pts_ned, atol=1e-8)
        np.testing.assert_array_equal(ecef, jax_geodesy.ned_to_ecef(pts_ned, origin))
        # a point 100m up should be ~[0,0,-100] in NED
        up = lla_to_ecef([origin[0], origin[1], origin[2] + 100.0])
        np.testing.assert_allclose(ecef_to_ned(up, origin), [0, 0, -100.0], atol=1e-3)


class TestGeoregister:
    def _make_B(self, n=5):
        B = np.zeros((n, 14))
        # synthetic SfM track: car drives +z (camera forward) at 1 m/frame
        B[:, 2] = 8.0 + np.arange(n)
        B[:, 0] = 0.5  # slight right offset
        # GPS fixes: camera walking north-ish in Santiago
        B[:, 9] = -33.45 + 1e-6 * np.arange(n)
        B[:, 10] = -70.66
        B[:, 11] = 520.0
        return B

    def test_zero_yaw_maps_camera_axes_to_ned(self):
        _cam_ned, car_ned = georegister_track(self._make_B(), yaw_deg=0.0)
        # camera z (forward) -> North, x (right) -> East
        np.testing.assert_allclose(car_ned[0], [8.0, 0.5, 0.0], atol=1e-9)

    def test_yaw_rotates_heading(self):
        _, car_n = georegister_track(self._make_B(), yaw_deg=0.0)
        _, car_e = georegister_track(self._make_B(), yaw_deg=90.0)
        # 90 deg heading turns the north component into east
        np.testing.assert_allclose(car_e[0][1], car_n[0][0], atol=1e-9)
        np.testing.assert_allclose(car_e[0][0], -car_n[0][1], atol=1e-9)

    def test_ecef_lla_roundtrip_consistency(self):
        B = self._make_B()
        georegister_track(B, yaw_deg=30.0)
        np.testing.assert_allclose(lla_to_ecef(B[:, 9:12]), B[:, 6:9], atol=1e-3)
        want = self._make_B()
        jax_georegister_track(want, yaw_deg=30.0)
        np.testing.assert_array_equal(B, want)

    def test_cam_ned_returned_and_consistent(self):
        cam_ned, _ = georegister_track(self._make_B(), yaw_deg=None)
        # ~1e-6 deg of latitude is ~0.111 m north per frame
        np.testing.assert_allclose(np.diff(cam_ned[:, 0]), 0.1112, atol=2e-3)


class TestUtils:
    def test_filename_split(self):
        p, stem, ext, name = filename_split("/a/b/IMG_4134.MOV")
        assert (p, stem, ext, name) == ("/a/b/", "IMG_4134", ".MOV", "IMG_4134.MOV")

    def test_stage_timer(self):
        t = StageTimer()
        with t.stage("x"):
            pass
        with t.stage("x", sync=True):  # no CUDA here: nothing to wait for
            pass
        assert t.counts["x"] == 2
        assert "x" in t.report()
        assert t.as_dict()["x"]["calls"] == 2

    def test_trace_writes_a_file(self, tmp_path):
        import torch

        with trace(tmp_path / "tr"):
            torch.ones(8).sum()
        out = tmp_path / "tr" / "trace.json"
        assert out.stat().st_size > 0 and "traceEvents" in out.read_text()
        with trace(None):  # no-op
            pass


def _write_still(path, seconds, subsec, lat_dms, lon_dms, alt, heading):
    """A 48x64 gray JPEG with the EXIF and GPS tags the stills path reads."""
    im = Image.fromarray((np.arange(48 * 64).reshape(48, 64) * 7 % 251).astype(np.uint8))
    ex = Image.Exif()
    ex[0x0112] = 1  # Orientation
    ifd = ex.get_ifd(0x8769)
    h, m, s = seconds // 3600, seconds // 60 % 60, seconds % 60
    ifd[0x9003] = f"2018:03:11 {h:02d}:{m:02d}:{s:02d}"  # DateTimeOriginal
    ifd[0x9291] = subsec  # SubsecTimeOriginal
    ifd[0xA002], ifd[0xA003] = 64, 48  # ExifImageWidth, ExifImageHeight
    gps = ex.get_ifd(0x8825)

    def dms(v):
        return tuple(IFDRational(int(round(x * 100)), 100) for x in v)

    gps[1], gps[2] = "S", dms(lat_dms)
    gps[3], gps[4] = "W", dms(lon_dms)
    gps[6] = IFDRational(int(alt * 10), 10)
    gps[17] = IFDRational(int(heading * 10), 10)  # GPSImgDirection
    im.save(path, exif=ex)


def test_exif_and_stills_reader_match_jax(tmp_path):
    """Two JPEGs through both packages' EXIF readers and StillsReader: equal
    tags, LLAT rows, image size, yaw and frames. A two-digit
    SubsecTimeOriginal is read as milliseconds, as in the JAX package."""
    paths = [tmp_path / "IMG_0001.JPG", tmp_path / "IMG_0002.JPG"]
    _write_still(paths[0], 54245, "25", (33, 2, 30.15), (71, 37, 12.34), 42.5, 181.5)
    _write_still(paths[1], 54246, "5", (33, 2, 30.25), (71, 37, 12.30), 43.0, 182.0)
    for p in paths:
        got, want = exif.read_exif(p), jax_exif.read_exif(p)
        assert got == want
        np.testing.assert_array_equal(exif.exif_to_llat(got), jax_exif.exif_to_llat(want))
        assert exif.exif_image_size(got) == jax_exif.exif_image_size(want) == (64.0, 48.0)
        assert exif.exif_yaw_deg(got) == jax_exif.exif_yaw_deg(want)
    llat = exif.exif_to_llat(exif.read_exif(paths[0]))
    np.testing.assert_allclose(llat, [-(33 + 2 / 60 + 30.15 / 3600), -(71 + 37 / 60 + 12.34 / 3600),
                                      42.5, 54245.025], rtol=0, atol=1e-9)
    assert exif.exif_yaw_deg(exif.read_exif(paths[0])) == pytest.approx(181.5 + 2.56)

    sr, jsr = StillsReader(paths), JaxStillsReader(paths)
    assert (sr.info.width, sr.info.height, sr.info.is_video) == (64.0, 48.0, False)
    np.testing.assert_array_equal(sr.info.focal_pix, jsr.info.focal_pix)
    np.testing.assert_array_equal(sr.info.principal_point, jsr.info.principal_point)
    for (i, g, l), (ji, jg, jl) in zip(sr.frames(), jsr.frames(), strict=True):
        assert i == ji
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(l, jl)
        assert g.shape == (48, 64) and g.dtype == np.uint8
    assert sr.yaw_deg(1) == jsr.yaw_deg(1)
