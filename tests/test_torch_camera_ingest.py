"""Mirrors of the JAX camera-database and annotation oracle tests
(``tests/test_camera_ingest.py``: ``TestCameraDatabase``, ``TestAnnotations``)
against the port's ``camera/`` modules, with the same inputs and
tolerances. The tests that read the reference dataset keep its gate; the
``.npz`` round trip needs no data and runs ungated. Annotations written by
either package (``.npz``, and a ``.mat`` in the reference's layout written
with scipy) load equal in the other."""

import math
from pathlib import Path

import numpy as np
import pytest
import scipy.io

from velocity_tpu.camera.annotations import Annotation as JaxAnnotation
from velocity_tpu.camera.annotations import load_annotation as jax_load_annotation
from velocity_tpu.camera.annotations import save_annotation as jax_save_annotation
from velocity_tpu_torch.camera.annotations import (
    Annotation, find_annotation, load_annotation, save_annotation)
from velocity_tpu_torch.camera.database import camera_info
from velocity_tpu_torch.pipeline.datasets import REFERENCE

REF = Path(REFERENCE)
HAVE_DATA = (REF / "data" / "IMG_4134.MOV").exists()
needs_data = pytest.mark.skipif(not HAVE_DATA, reason="reference dataset not mounted")


class TestCameraDatabase:
    def test_video_focal_diagonal_rule(self):
        info = camera_info("x/IMG_4134.MOV", "iPhone 6s", width=1920, height=1080)
        want = 3486 * math.hypot(4032, 3024) / math.hypot(3840, 2160)
        np.testing.assert_allclose(info.focal_pix, want)
        assert info.is_video

    def test_stills_focal(self):
        info = camera_info("x/IMG_4122.JPG", "iPhone 6s", width=4032, height=3024)
        np.testing.assert_allclose(info.focal_pix, 3486.0)
        assert not info.is_video
        assert info.klt_block == (21, 21)

    def test_principal_point_half_pixel(self):
        info = camera_info("v.MOV", width=1920, height=1080)
        np.testing.assert_allclose(info.principal_point, [960.5, 540.5])

    def test_intrinsic_matrix_rowvec_layout(self):
        K = camera_info("v.MOV", width=1920, height=1080).intrinsic_matrix_rowvec
        assert K.shape == (3, 3)
        assert K[0, 1] == 0 and K[0, 2] == 0 and K[2, 2] == 1
        assert K[2, 0] == 960.5 and K[2, 1] == 540.5

    def test_half_scale_rule(self):
        """4K->2K: focal and q halve, principal point untouched."""
        info = camera_info("v.MOV", width=1920, height=1080)
        intr = info.intrinsics(scale=0.5)
        np.testing.assert_allclose(float(intr.fx), info.focal_pix[0] / 2, rtol=1e-6)
        np.testing.assert_allclose(float(intr.cx), 960.5)

    def test_unknown_platform_raises(self):
        with pytest.raises(ValueError, match="unknown camera platform"):
            camera_info("v.MOV", platform="iPhone x")

    def test_fov(self):
        fw, fh = camera_info("v.MOV", width=1920, height=1080).spec.fov_deg
        assert 55 < fw < 65 and 45 < fh < 50  # iPhone 6s ~60x47 deg


@needs_data
class TestAnnotations:
    def test_load_mat_4134(self):
        ann = load_annotation(REF / "matlab" / "IMG_4134.MOV.mat")
        assert ann.q.shape == (4, 2)
        assert ann.q.dtype == np.float32
        # startFrame 19 (1-indexed) -> 18; the reference driver uses 19 for 4134
        assert ann.start_frame == 18
        np.testing.assert_allclose(ann.q[0], [3761.4, 1503.0], atol=0.1)

    def test_load_mat_4119(self):
        assert load_annotation(REF / "matlab" / "IMG_4119.MOV.mat").start_frame == 41

    def test_find_annotation(self, tmp_path):
        p = find_annotation("data/IMG_4134.MOV", [REF / "matlab", tmp_path])
        assert p.name == "IMG_4134.MOV.mat"
        with pytest.raises(FileNotFoundError):
            find_annotation("nope.MOV", [tmp_path])


def test_npz_roundtrip(tmp_path):
    ann = Annotation(q=np.arange(8, dtype=np.float32).reshape(4, 2), fname="X.MOV",
                     start_frame=7)
    save_annotation(tmp_path / "X.MOV.npz", ann)
    ann2 = load_annotation(tmp_path / "X.MOV.npz")
    np.testing.assert_array_equal(ann2.q, ann.q)
    assert ann2.start_frame == 7


def test_find_annotation_in_search_dirs(tmp_path):
    """The first search directory holding ``<name>.mat`` or ``<name>.npz``
    wins; none raises."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "IMG_1.MOV.npz").write_bytes(b"")
    found = find_annotation("data/IMG_1.MOV", [tmp_path / "a", tmp_path / "b"])
    assert found == tmp_path / "b" / "IMG_1.MOV.npz"
    with pytest.raises(FileNotFoundError):
        find_annotation("nope.MOV", [tmp_path / "a"])


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("start_frame", [7, None])
def test_npz_loads_equal_across_packages(tmp_path, writer, start_frame):
    q = np.random.default_rng(0).uniform(0, 4000, (4, 2)).astype(np.float32)
    path = tmp_path / "X.MOV.npz"
    if writer == "port":
        save_annotation(path, Annotation(q=q, fname="X.MOV", start_frame=start_frame))
    else:
        jax_save_annotation(path, JaxAnnotation(q=q, fname="X.MOV", start_frame=start_frame))
    a, b = load_annotation(path), jax_load_annotation(path)
    np.testing.assert_array_equal(a.q, b.q)
    assert (a.fname, a.start_frame) == (b.fname, b.start_frame) == ("X.MOV", start_frame)


def test_mat_loads_equal_across_packages(tmp_path):
    """A .mat in the reference's layout (q, fname, 1-indexed startFrame)."""
    q = np.random.default_rng(1).uniform(0, 4000, (4, 2))
    path = tmp_path / "IMG_9.MOV.mat"
    scipy.io.savemat(path, {"q": q, "fname": "IMG_9.MOV", "startFrame": 42.0})
    a, b = load_annotation(path), jax_load_annotation(path)
    np.testing.assert_array_equal(a.q, b.q)
    assert a.q.dtype == np.float32 and a.start_frame == b.start_frame == 41
    assert a.fname == b.fname == "IMG_9.MOV"


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
