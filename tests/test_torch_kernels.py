"""Plain versions of the port's kernels K1 (LK block) and K2 (slab
extraction) against the JAX package, on the CPU; the CUDA kernels K1, K2
and K3 (patch extraction) against their plain versions on the card
(``cuda`` marker). K3's CPU parity tests are in ``test_torch_lk_fast.py``.

The JAX package is imported inside the CPU tests only, so that the card
tests run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from velocity_tpu_torch.ops import lk_block_pallas as k1
from velocity_tpu_torch.ops import lk_lanes
from velocity_tpu_torch.ops import patch_pallas as k3
from velocity_tpu_torch.ops.interp import extract_patches
from velocity_tpu_torch.ops import slab_pallas as k2

torch.set_num_threads(1)

# The three main-path configurations (win, P, n_taps, cubic): stages 1-2,
# the stage-3 forward leg (warped, cubic) and the stage-3 backward leg.
CONFIGS = [(15, 24, 8, False), (51, 64, 10, True), (51, 64, 8, False)]


def _case(win, P, n_taps, cubic, N=128, seed=0, it0=0, some_done=False):
    """Random block inputs, as tests/test_lk_block_pallas.py builds them
    (lanes-last numpy, f32). N=128 is one lane block of the Pallas kernel,
    which keeps its interpret mode quick at win 51."""
    rng = np.random.default_rng(seed)
    dpatch = (rng.random((P, P, N)) * 255).astype(np.float32)
    Ip = (rng.random((win, win, N)) * 255).astype(np.float32)
    gxp = rng.normal(0, 20, (win, win, N)).astype(np.float32)
    gyp = rng.normal(0, 20, (win, win, N)).astype(np.float32)
    a11 = np.sum(gxp * gxp, axis=(0, 1), dtype=np.float32)
    a12 = np.sum(gxp * gyp, axis=(0, 1), dtype=np.float32)
    a22 = np.sum(gyp * gyp, axis=(0, 1), dtype=np.float32)
    det = a11 * a22 - a12 * a12
    inv_det = np.where(det != 0, 1.0 / det, 0.0).astype(np.float32)
    pts = rng.uniform(50, 400, (2, N)).astype(np.float32)
    c = (n_taps - 1) / 2 + (win - 1) / 2
    bx = (rng.uniform(-1, 1, N) - pts[0] + c).astype(np.float32)
    by = (rng.uniform(-1, 1, N) - pts[1] + c).astype(np.float32)
    trackable = rng.random(N) > 0.1
    done = rng.random(N) > 0.7 if some_done else np.zeros(N, bool)
    pd = rng.normal(0, 0.2, (2, N)).astype(np.float32)
    kw = dict(win=win, n_taps=n_taps, cubic=cubic, eps=0.01, Wd=480, Hd=270)
    return (dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
            trackable, pts, done, pd, it0), kw


def _to_torch_points_major(args, device="cpu"):
    """Lanes-last numpy -> points-major torch, as the port lays it out."""
    (dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
     trackable, pts, done, pd, it0) = args
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    pm = lambda a: t(np.transpose(a, (2, 0, 1)))  # noqa: E731
    return (pm(dpatch), pm(Ip), pm(gxp), pm(gyp), t(a11), t(a12), t(a22), t(inv_det),
            t(bx), t(by), t(trackable), t(pts), t(done), t(pd), it0)


@pytest.mark.parametrize("win,P,n_taps,cubic", CONFIGS)
@pytest.mark.parametrize("it0", [0, 5])
def test_plain_lk_block_matches_jax(win, P, n_taps, cubic, it0):
    """The port's plain K1 equals JAX block_iters_ref and the Pallas kernel
    in interpret mode. Tolerance rtol 1e-5, atol 1e-4 px (the JAX kernel
    test's): sums over up to 51x51 f32 products run in another order."""
    import jax.numpy as jnp
    from velocity_tpu.ops.lk_block_pallas import lk_block as jax_lk_block
    from velocity_tpu.ops.lk_lanes import block_iters_ref as jax_block_iters_ref

    args, kw = _case(win, P, n_taps, cubic, it0=it0, some_done=it0 > 0)
    jargs = [jnp.asarray(a) for a in args[:-1]] + [it0]
    ref_p, ref_d, ref_pd = jax_block_iters_ref(*jargs, **kw)
    (dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
     trk, pts, done, pd, _) = jargs
    pal_p, pal_d, pal_pd = jax_lk_block(
        dpatch, Ip, gxp, gyp, a11, a12, a22, inv_det, bx, by,
        trk.astype(jnp.float32), pts, done.astype(jnp.float32), pd, it0,
        interpret=True, **kw)
    got_p, got_d, got_pd = k1.lk_block(*_to_torch_points_major(args), **kw)
    for want_p, want_d, want_pd in ((ref_p, ref_d, ref_pd),
                                    (pal_p, np.asarray(pal_d) > 0.5, pal_pd)):
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_allclose(got_pd.numpy(), np.asarray(want_pd), rtol=1e-5, atol=1e-4)


def test_lk_block_is_a_fixed_point_once_all_done():
    """The early exit of the LK loop skips blocks only when no trackable
    point is left undone; such a block changes nothing, so the points are
    the same whether or not the loop exits early."""
    args, kw = _case(15, 24, 8, False, N=64, it0=5)
    targs = list(_to_torch_points_major(args))
    targs[12] = torch.ones_like(targs[12])  # every point done
    p, d, pd = k1.lk_block(*targs, **kw)
    assert torch.equal(p, targs[11]) and torch.equal(pd, targs[13]) and bool(d.all())


def _slab_image(H=90, W=130, seed=3):
    return np.random.default_rng(seed).uniform(0, 255, (H, W)).astype(np.float32)


@pytest.mark.parametrize("S", [24, 56, 64, 72, 27])
def test_plain_slab_extraction_matches_jax(S):
    """The port's slab hook (plain K2 on the CPU) equals JAX _extract_slabs
    exactly (a gather: no arithmetic), with corners inside, on the edge and
    past every side (clamped)."""
    import jax.numpy as jnp
    from velocity_tpu.ops.lk_lanes import _extract_slabs as jax_extract_slabs

    img = _slab_image()
    H, W = img.shape
    rng = np.random.default_rng(S)
    corners = np.concatenate([
        rng.integers(0, [W - S + 1, H - S + 1], (20, 2)),  # inside
        [[0, 0], [W - S, H - S], [W - S, 0], [0, H - S]],  # on the edge
        [[-7, 3], [W, 5], [4, -30], [9, H + 2], [-S, -S], [W + S, H + S]],  # clamped
    ]).astype(np.int32)
    want, want_c = jax_extract_slabs(jnp.asarray(img), jnp.asarray(corners), S)
    got, got_c = lk_lanes._extract_slabs(torch.as_tensor(img), torch.as_tensor(corners), S)
    np.testing.assert_array_equal(got.numpy(), np.transpose(np.asarray(want), (2, 0, 1)))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_plain_slab_extraction_pads_small_images():
    """An image smaller than the slab is edge-padded first, as in JAX."""
    import jax.numpy as jnp
    from velocity_tpu.ops.lk_lanes import _extract_slabs as jax_extract_slabs

    img = _slab_image(H=20, W=30)
    corners = np.array([[0, 0], [5, 3], [-2, 40]], np.int32)
    want, _ = jax_extract_slabs(jnp.asarray(img), jnp.asarray(corners), 24)
    got, _ = lk_lanes._extract_slabs(torch.as_tensor(img), torch.as_tensor(corners), 24)
    np.testing.assert_array_equal(got.numpy(), np.transpose(np.asarray(want), (2, 0, 1)))


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [24, 56, 64, 72, 27])
def test_k2_matches_plain_on_card(cuda_device, S):
    """K2 is a gather: bit-equal to its plain version."""
    img = torch.as_tensor(_slab_image(H=1080 + 2 * 72, W=1920 + 2 * 72), device=cuda_device)
    H, W = img.shape
    g = torch.Generator(device=cuda_device).manual_seed(S)
    cx = torch.randint(0, W - S + 1, (1024,), generator=g, device=cuda_device, dtype=torch.int32)
    cy = torch.randint(0, H - S + 1, (1024,), generator=g, device=cuda_device, dtype=torch.int32)
    got = k2.extract_slabs(img, cx, cy, S)
    torch.cuda.synchronize()
    assert torch.equal(got, k2.extract_slabs_ref(img, cx, cy, S))


@pytest.mark.cuda
@pytest.mark.parametrize("win,P,n_taps,cubic", CONFIGS)
@pytest.mark.parametrize("it0", [0, 5])
def test_k1_matches_plain_on_card(cuda_device, win, P, n_taps, cubic, it0):
    """K1 against its plain version on the same card inputs. Tolerance
    rtol 1e-5, atol 1e-4 px: the kernel hoists c = sum(I * grad) and sums in
    another order (with FMA contraction)."""
    args, kw = _case(win, P, n_taps, cubic, N=1024, it0=it0, some_done=it0 > 0)
    targs = _to_torch_points_major(args, device=cuda_device)
    got_p, got_d, got_pd = k1.lk_block(*targs, **kw)
    torch.cuda.synchronize()
    ref_p, ref_d, ref_pd = k1.block_iters_ref(*targs, **kw)
    torch.testing.assert_close(got_p, ref_p, rtol=1e-5, atol=1e-4)
    assert torch.equal(got_d, ref_d)
    torch.testing.assert_close(got_pd, ref_pd, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("size,H,W", [(34, 1080, 1920), (34, 17, 30), (70, 1080, 1920),
                                      (82, 1080 + 2 * 82, 1920 + 2 * 82)])
def test_k3_matches_plain_on_card(cuda_device, size, H, W):
    """K3 is a gather: bit-equal to its plain version, clamped corners
    included, at the fast engine's shapes (P 34 on a full frame and on a top
    pyramid level padded to the patch, P 70, Q 82 on the padded frame);
    corners inside and past every side."""
    img = torch.as_tensor(_slab_image(H=H, W=W), device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(size)
    corners = torch.stack([
        torch.randint(-size, W + size, (1024,), generator=g, device=cuda_device),
        torch.randint(-size, H + size, (1024,), generator=g, device=cuda_device),
    ], dim=1).to(torch.int32)
    before = k3.extract_patches.launches
    got, got_cl = extract_patches(img, corners, size)
    torch.cuda.synchronize()
    assert k3.extract_patches.launches == before + 1
    if H < size or W < size:
        img = torch.nn.functional.pad(img[None, None], (0, max(0, size - W), 0,
                                                         max(0, size - H)),
                                      mode="replicate")[0, 0]
    want, want_cl = k3.extract_patches_ref(img, corners, size)
    assert torch.equal(got_cl, want_cl)
    assert torch.equal(got, want)
