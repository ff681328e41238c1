"""The port's K3 plain version, gather LK engine (``ops/lk.py``) and fast LK
engine (``ops/lk_fast.py``) against the JAX package, on the CPU at f32;
then the assertions of ``tests/test_lk_fast.py`` (fast against gather, the
forward-backward gate) repeated inside the port.

Tolerances: K3 is a gather, compared bit for bit (patches and clamped
corners). LK points are compared where both packages report a valid status,
within 1e-3 px (f32 sums in another order, iterated), and the statuses agree
on at least 99% of the points.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_tpu.ops import lk as jlk
from velocity_tpu.ops import lk_fast as jlk_fast
from velocity_tpu.ops.patch_pallas import extract_patches_pallas
from velocity_tpu_torch.ops import interp, lk, lk_fast, lk_lanes
from velocity_tpu_torch.ops import patch_pallas as k3

torch.set_num_threads(1)


def _image(H=240, W=320, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (H, W)).astype(np.float32)


def _corners(H, W, size, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, [W - size + 1, H - size + 1], (24, 2)),  # inside
        [[0, 0], [W - size, H - size], [W - size, 0], [0, H - size]],  # on the edge
        [[-7, 3], [W, 5], [4, -30], [9, H + 2], [-size, -size], [W + size, H + size]],
    ]).astype(np.int32)


@pytest.mark.parametrize("size", [1, 16, 27, 34, 70, 82])
def test_plain_k3_matches_pallas_and_jax_extractor(size):
    """The plain K3 equals the Pallas kernel (interpret mode) and JAX's
    ``_extract_axis_aligned`` bit for bit, clamped corners included."""
    img = _image(H=180, W=230, seed=size)
    corners = _corners(*img.shape, size, seed=size + 1)
    want, want_cl = extract_patches_pallas(jnp.asarray(img), jnp.asarray(corners), size,
                                           interpret=True)
    want_x, want_x_cl = jlk_fast._extract_axis_aligned(jnp.asarray(img), jnp.asarray(corners),
                                                       size)
    got, got_cl = k3.extract_patches(torch.as_tensor(img), torch.as_tensor(corners), size)
    assert got_cl.dtype == torch.int32
    for w, wc in ((want, want_cl), (want_x, want_x_cl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got_cl.numpy(), np.asarray(wc))


def test_plain_k3_border_clamping():
    """The case of tests/test_patch_pallas.py: corners past the far and the
    near corner clamp to [[112, 84], [0, 0]]."""
    img = np.arange(100 * 128, dtype=np.float32).reshape(100, 128)
    corners = np.int32([[120, 95], [-5, -5]])
    want, want_cl = extract_patches_pallas(jnp.asarray(img), jnp.asarray(corners), 16,
                                           interpret=True)
    got, cl = k3.extract_patches(torch.as_tensor(img), torch.as_tensor(corners), 16)
    assert cl.tolist() == [[112, 84], [0, 0]] == np.asarray(want_cl).tolist()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), img[:16, :16])


def test_extract_patches_pads_small_images():
    """An image smaller than the patch (a top pyramid level) is edge-padded
    first, as in JAX."""
    img = _image(H=17, W=30)
    corners = np.int32([[0, 0], [5, 3], [-2, 40], [12, -9]])
    want, want_cl = jlk_fast._extract_axis_aligned(jnp.asarray(img), jnp.asarray(corners), 34)
    got, got_cl = interp.extract_patches(torch.as_tensor(img), torch.as_tensor(corners), 34)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_cl.numpy(), np.asarray(want_cl))


def test_k3_wrapper_refuses_bad_inputs():
    """K3 takes an image or a stack (V, H, W) whose count divides the
    points': a stack of two for three points, and a 4-D image, are refused,
    as are wrong dtypes, shapes, sizes, layouts and devices."""
    img = torch.zeros((40, 50))
    c = torch.zeros((3, 2), dtype=torch.int32)
    for bad_img, bad_c, size in ((img.double(), c, 8), (img, c.long(), 8), (img, c[:, :1], 8),
                                 (img.t(), c, 8), (img, c, 41), (torch.zeros((2, 40, 50)), c, 8),
                                 (img[None, None], c, 8),
                                 (img, c.t().contiguous().t(), 8), (img, c.to("meta"), 8)):
        with pytest.raises(ValueError):
            k3.extract_patches(bad_img, bad_c, size)


# ---------------------------------------------------------------- LK engines


def _smooth_image(seed, h=240, w=320, blur=9):
    img = np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)
    return cv2.GaussianBlur(img, (blur, blur), 0)


def _interior_points(h, w, n, seed, margin=50):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, w - margin, n),
                     rng.uniform(margin, h - margin, n)], axis=1).astype(np.float32)


# near-identity affine prior, as a stage-3 RANSAC estimate would be
M = np.float32([[1.02, 0.008, 5.0], [-0.006, 0.985, -3.0]])


@pytest.fixture(scope="module")
def pair():
    """A smooth 240x320 image, its translated copy, its affine-warped copy and
    points spread over the interior."""
    img = _smooth_image(21)
    img_t = cv2.warpAffine(img, np.float32([[1, 0, 3.4], [0, 1, -2.6]]), (320, 240))
    img_w = cv2.warpAffine(img, M, (320, 240))
    return img, img_t, img_w, _interior_points(240, 320, 64, seed=22)


FORMS = {
    # name: (destination, kwargs)
    "plain": ("t", dict(win=15, max_level=3, iters=10, eps=0.1)),
    "warp": ("w", dict(win=21, max_level=0, iters=30, eps=0.001, warp_dst=M)),
    "fb": ("t", dict(win=15, max_level=3, iters=10, eps=0.1, fb_threshold=1.0)),
    "fb_warp": ("w", dict(win=21, max_level=0, iters=30, eps=0.001, warp_dst=M,
                          fb_threshold=0.3)),
}


def _run_both(pair, form, jax_fns, port_fns):
    img, img_t, img_w, pts = pair
    dst, kw = FORMS[form]
    b = img_t if dst == "t" else img_w
    fb = "fb_threshold" in kw
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want = jax_fns[fb](jnp.asarray(img), jnp.asarray(b), jnp.asarray(pts), **jkw)
    got = port_fns[fb](torch.as_tensor(img), torch.as_tensor(b), torch.as_tensor(pts), **tkw)
    return want, got


def _assert_agree(want, got, min_both=20):
    sw, sg = np.asarray(want.status), got.status.numpy()
    assert (sw == sg).mean() >= 0.99
    both = sw & sg
    assert both.sum() >= min_both
    np.testing.assert_allclose(got.points.numpy()[both], np.asarray(want.points)[both],
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("form", list(FORMS))
def test_gather_lk_matches_jax(pair, form):
    want, got = _run_both(pair, form, (jlk.lk_pyramidal, jlk.lk_forward_backward),
                          (lk.lk_pyramidal, lk.lk_forward_backward))
    _assert_agree(want, got)


@pytest.mark.parametrize("form", list(FORMS))
def test_fast_lk_matches_jax(pair, form):
    want, got = _run_both(pair, form,
                          (jlk_fast.lk_pyramidal_fast, jlk_fast.lk_forward_backward_fast),
                          (lk_fast.lk_pyramidal_fast, lk_fast.lk_forward_backward_fast))
    _assert_agree(want, got)


def test_extract_warped_matches_jax(pair):
    """The 12x12-tap warped extraction at fractional centres, some near the
    border (edge padding): within 1e-5 of the largest magnitude."""
    img = pair[0]
    rng = np.random.default_rng(23)
    c = np.stack([rng.uniform(-5, 325, 40), rng.uniform(-5, 245, 40)], 1).astype(np.float32)
    want, want_corner = jlk_fast._extract_warped(jnp.asarray(img), jnp.asarray(c), 34,
                                                 jnp.asarray(M))
    got, corner = lk_fast._extract_warped(torch.as_tensor(img), torch.as_tensor(c), 34,
                                          torch.as_tensor(M))
    np.testing.assert_array_equal(corner.numpy(), np.asarray(want_corner))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-5 * np.max(np.abs(want))


def test_patch_gradients_are_the_lanes_gradients():
    """JAX's ``_patch_gradients`` (fast engine) and ``scharr_derivatives``
    (gather engine) against the port's one Scharr implementation,
    ``lk._grad_xy`` (which ``lk_lanes`` and ``lk_fast`` both use): within
    1e-5 of the largest magnitude."""
    assert lk_lanes._grad_xy is lk._grad_xy is lk_fast._grad_xy
    rng = np.random.default_rng(24)
    patches = rng.uniform(0, 255, (8, 34, 34)).astype(np.float32)
    img = rng.uniform(0, 255, (37, 52)).astype(np.float32)
    for want, got in ((jlk_fast._patch_gradients(jnp.asarray(patches)),
                       lk._grad_xy(torch.as_tensor(patches))),
                      (jlk.scharr_derivatives(jnp.asarray(img)),
                       lk.scharr_derivatives(torch.as_tensor(img)))):
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert np.max(np.abs(g.numpy() - w)) <= 1e-5 * np.max(np.abs(w))


# ------------------------------------- tests/test_lk_fast.py, inside the port


def _t(a):
    return torch.as_tensor(a)


def test_port_fast_matches_gather_plain_translation(pair):
    img, img_t, _, _ = pair
    pts = _interior_points(240, 320, 50, seed=25)
    kw = dict(win=15, max_level=3, iters=10, eps=0.1)
    ref = lk.lk_pyramidal(_t(img), _t(img_t), _t(pts), **kw)
    fast = lk_fast.lk_pyramidal_fast(_t(img), _t(img_t), _t(pts), **kw)
    both = ref.status.numpy() & fast.status.numpy()
    assert both.mean() > 0.9
    d = np.linalg.norm(ref.points.numpy()[both] - fast.points.numpy()[both], axis=1)
    assert np.median(d) < 0.02, np.median(d)
    assert (ref.status.numpy() == fast.status.numpy()).mean() > 0.9


def test_port_fast_matches_gather_affine_warp_prior():
    img = _smooth_image(26)
    Mw = np.float32([[1.03, 0.012, 6.0], [-0.01, 0.97, -4.0]])
    img2 = cv2.warpAffine(img, Mw, (img.shape[1], img.shape[0]))
    pts = _interior_points(*img.shape, 40, seed=27)
    kw = dict(win=21, max_level=0, iters=30, eps=0.001, warp_dst=_t(Mw))
    ref = lk.lk_pyramidal(_t(img), _t(img2), _t(pts), **kw)
    fast = lk_fast.lk_pyramidal_fast(_t(img), _t(img2), _t(pts), **kw)
    both = ref.status.numpy() & fast.status.numpy()
    assert both.mean() > 0.85
    d = np.linalg.norm(ref.points.numpy()[both] - fast.points.numpy()[both], axis=1)
    assert np.median(d) < 0.05, np.median(d)
    # both report ~zero residual motion (solved in source coordinates)
    err = np.linalg.norm(fast.points.numpy()[both] - pts[both], axis=1)
    assert np.median(err) < 0.1


def test_port_forward_backward_gating():
    img = _smooth_image(28)
    img2 = img.copy()
    img2[:, 160:] = np.random.default_rng(29).uniform(0, 255, (img.shape[0], 160))
    pts = _interior_points(*img.shape, 60, seed=30)
    fast = lk_fast.lk_forward_backward_fast(_t(img), _t(img2), _t(pts), fb_threshold=0.3,
                                            win=15, max_level=3, iters=30, eps=0.001)
    st = fast.status.numpy()
    assert st[pts[:, 0] < 120].mean() > 0.75
    assert st[pts[:, 0] > 200].mean() < 0.2


def test_port_fb_with_warp_matches_gather(pair):
    img, _, img_w, _ = pair
    pts = _interior_points(240, 320, 50, seed=31)
    kw = dict(win=21, max_level=0, iters=30, eps=0.001, fb_threshold=0.3, warp_dst=_t(M))
    ref = lk.lk_forward_backward(_t(img), _t(img_w), _t(pts), **kw)
    fast = lk_fast.lk_forward_backward_fast(_t(img), _t(img_w), _t(pts), **kw)
    sref, sfast = ref.status.numpy(), fast.status.numpy()
    assert (sref == sfast).mean() > 0.85, (sref.mean(), sfast.mean())
    both = sref & sfast
    d = np.linalg.norm(ref.points.numpy()[both] - fast.points.numpy()[both], axis=1)
    assert np.median(d) < 0.05
