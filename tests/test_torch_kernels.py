"""Plain versions of the port's kernels K1 (LK block), K2 (slab
extraction, which clamps its corners) and K5 (stage 3's warped windows)
against the JAX package, the sampling K1's CUDA kernel does (only the taps
that weigh), and the input checks of K2's, K3's and K5's wrappers, on the
CPU; the CUDA kernels K1, K2, K3 (patch extraction), K4
(``corner_subpix``'s refinement loop) and K5 against their plain versions
on the card (``cuda`` marker), K2 and K3 also at their edges, K4 also on
the edge cases its CPU test shows the plain loop meets, K5 bit for bit at
its edges and in a captured stage-3 call.
K3's CPU parity tests are in ``test_torch_lk_fast.py``; K4's plain twin is
held to the loop before K4 in ``test_torch_features.py``.

The JAX package is imported inside the CPU tests only, so that the card
tests run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import zlib

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


# The taps K1 evaluates in each pass: K = 2 (linear) or 4 (cubic) from
# floor(o) or floor(o) - 1 of the clamped offset o (csrc/lk_block.cu).
def _tap_window(o, cubic):
    return torch.floor(o).to(torch.int64) - int(cubic), 4 if cubic else 2


@pytest.mark.parametrize("n_taps,cubic", [(8, False), (10, True)])
def test_taps_outside_the_window_weigh_zero(n_taps, cubic):
    """Every tap K1 skips weighs exactly 0, so dropping it removes only
    ``+ 0 * x`` terms: offsets over the whole clamp range, every integer and
    the floats on either side of it, both clamp ends and the float just
    below the upper end. The window's last tap reaches index n_taps, one
    past the stencil, only where its weight is 0."""
    lo, hi = (1.0, n_taps - 2.0) if cubic else (0.0, n_taps - 1.0)
    f32 = np.float32
    ints = np.arange(lo, hi + 1).astype(f32)
    o = np.concatenate([np.linspace(lo, hi, 20001, dtype=f32), ints,
                        np.nextafter(ints, f32(np.inf)), np.nextafter(ints, f32(-np.inf))])
    o = torch.as_tensor(np.unique(np.clip(o, f32(lo), f32(hi))))
    assert float(o[0]) == lo and float(o[-1]) == hi
    assert float(o[-2]) == float(np.nextafter(f32(hi), f32(-np.inf)))
    w_fn = k1._w_cubic if cubic else k1._w_linear
    base, K = _tap_window(o, cubic)
    assert int(base.min()) >= 0 and int((base + K - 1).max()) == n_taps
    for t in range(n_taps + 1):  # the stencil's taps and index n_taps
        w = w_fn(o - t)
        skipped = (t < base) | (t >= base + K)
        assert torch.all(w[skipped] == 0), t
        if t == n_taps:
            assert torch.all(w == 0)
    past = base + K - 1 == n_taps
    assert bool(past.any()) and torch.all(w_fn(o[past] - n_taps) == 0)


def _sample_tap_window(patch, oy, ox, win, n_taps, cubic):
    """K1's sampling written in torch: K taps from the window base in each
    pass, a tap past the taps the slab feeds weighted 0, and every read
    clamped into the slab."""
    N, P, _ = patch.shape
    nt = min(n_taps, P - win + 1)
    lo = 1.0 if cubic else 0.0
    shi = max(float(nt - 2 if cubic else nt - 1), lo)
    ox, oy = torch.clamp(ox, lo, shi), torch.clamp(oy, lo, shi)
    w_fn = k1._w_cubic if cubic else k1._w_linear
    (bx, K), (by, _) = _tap_window(ox, cubic), _tap_window(oy, cubic)
    ar = torch.arange(win)
    H = out = None
    for t in range(K):
        w = torch.where(bx + t < nt, w_fn(ox - (bx + t).to(ox.dtype)), 0.0)[:, None, None]
        cols = torch.clamp(ar[None, :] + bx[:, None] + t, max=P - 1)
        sl = torch.gather(patch, 2, cols[:, None, :].expand(N, P, win))
        H = w * sl if H is None else H + w * sl
    for t in range(K):
        w = torch.where(by + t < nt, w_fn(oy - (by + t).to(oy.dtype)), 0.0)[:, None, None]
        rows = torch.clamp(ar[None, :] + by[:, None] + t, max=P - 1)
        sl = torch.gather(H, 1, rows[:, :, None].expand(N, win, win))
        out = w * sl if out is None else out + w * sl
    return out


@pytest.mark.parametrize("win,P,n_taps,cubic", CONFIGS + [
    (21, 32, 8, False), (21, 32, 10, True),  # a window outside the two kernel shapes
    (15, 20, 8, False), (15, 22, 10, True),  # the slab feeds fewer taps than asked
])
def test_tap_window_sampling_equals_the_full_stencil(win, P, n_taps, cubic):
    """Sampling from the taps that weigh gives the bits of the plain
    version's full stencil, at random offsets, integers, both clamp ends
    and past them, including where the slab feeds fewer taps than asked."""
    rng = np.random.default_rng(win * 100 + P)
    nt = min(n_taps, P - win + 1)
    lo, hi = (1.0, nt - 2.0) if cubic else (0.0, nt - 1.0)
    edges = np.array([lo, hi, lo - 0.5, hi + 0.5, np.nextafter(np.float32(hi), -np.inf)])
    offs = np.concatenate([rng.uniform(lo - 1, hi + 1, 200), np.arange(lo, hi + 1), edges])
    ox = torch.as_tensor(rng.permutation(offs).astype(np.float32))
    oy = torch.as_tensor(offs.astype(np.float32))
    patch = torch.as_tensor(rng.uniform(0, 255, (len(offs), P, P)).astype(np.float32))
    want = k1._sample_taps(patch, oy, ox, win, n_taps, cubic=cubic)
    got = _sample_tap_window(patch, oy, ox, win, n_taps, cubic)
    assert torch.equal(got, want)


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


def _corners_past_every_side(H, W, S, n_inside=20, seed=0):
    """int32 (N, 2) xy corners: inside, on the edges, past every side and
    past every corner of an H x W image, for windows of size S."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, [W - S + 1, H - S + 1], (n_inside, 2)),
        [[0, 0], [W - S, H - S], [W - S, 0], [0, H - S]],
        [[-7, 3], [W, 5], [4, -30], [9, H + 2], [-S, -S], [W + S, H + S],
         [-3 * S, H + 1], [W + 2, -S], [W - S + 1, H - S + 1], [-1, -1]],
    ]).astype(np.int32)


@pytest.mark.parametrize("S", [24, 27, 72])
def test_plain_k2_clamps_as_jax_extract_slabs(S):
    """The plain K2, handed unclamped corners, gives the slabs and clamped
    corners of JAX ``lk_lanes._extract_slabs`` (clip, then vmapped
    ``dynamic_slice`` off the TPU), exactly."""
    import jax.numpy as jnp
    from velocity_tpu.ops.lk_lanes import _extract_slabs as jax_extract_slabs

    img = _slab_image()
    corners = _corners_past_every_side(*img.shape, S, seed=S)
    want, want_c = jax_extract_slabs(jnp.asarray(img), jnp.asarray(corners), S)
    got, got_c = k2.extract_slabs(torch.as_tensor(img), torch.as_tensor(corners), S)
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.transpose(np.asarray(want), (2, 0, 1)))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def _extract_slabs_torch_clamp(img, corners, size: int):
    """``lk_lanes._extract_slabs`` as it was while K2 took pre-clamped
    corners: pad a small image, clamp in torch, gather, stack the corners."""
    H, W = img.shape
    if H < size or W < size:
        img = torch.nn.functional.pad(img[None, None], (0, max(0, size - W), 0,
                                                         max(0, size - H)),
                                      mode="replicate")[0, 0]
        H, W = img.shape
    cy = torch.clamp(corners[:, 1], 0, H - size).to(torch.int32)
    cx = torch.clamp(corners[:, 0], 0, W - size).to(torch.int32)
    ar = torch.arange(size, device=img.device)
    slabs = img[(cy.long()[:, None] + ar)[:, :, None], (cx.long()[:, None] + ar)[:, None, :]]
    return slabs, torch.stack([cx, cy], dim=1)


def _caller_case(caller, device="cpu"):
    """(image, int32 corners, size) as each caller of ``_extract_slabs``
    builds them, from points inside, near and past the edges of a 60 x 90
    level: the block re-anchor (P 24 on the level padded by P), the source
    window (win 51: 56 on the level padded by 56), the warped slab (Q 72 on
    the level padded by Q), ``corner_subpix`` (Q 27 on the unpadded image),
    and a top level smaller than the slab (unpadded, padded inside)."""
    from velocity_tpu_torch.ops.lk import _pad_edge

    lvl = torch.as_tensor(_slab_image(H=60, W=90, seed=5), device=device)
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.uniform(-20, [110, 80], (40, 2)),
                          [[0, 0], [89.5, 59.5], [-60, 30], [150, -40]]]).astype(np.float32)
    ci = torch.floor(torch.as_tensor(pts, device=device)).to(torch.int32)
    if caller == "reanchor":
        size, pad, img, off = 24, 24, _pad_edge(lvl, 24), -7 - 3
    elif caller == "source":
        size, pad, img, off = 56, 56, _pad_edge(lvl, 56), -25 - 2
    elif caller == "warped":
        size, pad, img, off = 72, 72, _pad_edge(lvl, 72), -29 - 3
    elif caller == "subpix":
        size, pad, img, off = 27, 0, lvl, -6 - 6 - 1
    else:  # a top level smaller than the slab
        size, pad, img, off = 24, 0, lvl[:17, :20].contiguous(), -10
    return img, (ci + off + pad).contiguous(), size


@pytest.mark.parametrize("caller", ["reanchor", "source", "warped", "subpix", "small"])
def test_extract_slabs_unchanged_by_the_clamp_in_k2(caller):
    """``lk_lanes._extract_slabs``, now that K2 clamps, gives the slabs and
    clamped corners it gave while it clamped in torch, on each caller's
    padded or unpadded image (plain K2 on the CPU; exact)."""
    img, corners, size = _caller_case(caller)
    got, got_c = lk_lanes._extract_slabs(img, corners, size)
    want, want_c = _extract_slabs_torch_clamp(img, corners, size)
    assert got_c.dtype == torch.int32
    assert torch.equal(got_c, want_c)
    assert torch.equal(got, want)


_GATHERS = {"k2": k2.extract_slabs, "k3": k3.extract_patches}


@pytest.mark.parametrize("kernel", sorted(_GATHERS))
def test_window_wrappers_refuse_bad_inputs(kernel):
    """K2's and K3's wrappers refuse a wrong dtype, shape or size, a
    non-contiguous image or corners, corners on another device, and a
    device that is neither the CPU nor CUDA. Both take a stack of images
    (V, H, W) whose count divides the points': a stack of two for three
    points is refused."""
    fn = _GATHERS[kernel]
    img = torch.zeros((40, 50))
    c = torch.zeros((3, 2), dtype=torch.int32)
    stack = torch.zeros((2, 40, 50))
    bad = ((img.double(), c, 8), (img, c.long(), 8), (img, c[:, :1], 8), (stack, c, 8),
           (img[None, None], c, 8), (img.t(), c, 8), (img, c.t().contiguous().t(), 8),
           (img, c.reshape(-1), 8), (img, c, 41), (img, c, 0), (img, c.to("meta"), 8),
           (img.to("meta"), c, 8))
    for bad_img, bad_c, size in bad:
        with pytest.raises(ValueError):
            fn(bad_img, bad_c, size)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [24, 56, 64, 72, 27])
def test_k2_matches_plain_on_card(cuda_device, S):
    """K2 is a gather: bit-equal to its plain version, clamped corners
    included, with corners inside and past every side."""
    img = torch.as_tensor(_slab_image(H=1080 + 2 * 72, W=1920 + 2 * 72), device=cuda_device)
    H, W = img.shape
    g = torch.Generator(device=cuda_device).manual_seed(S)
    corners = torch.stack([
        torch.randint(-S, W + 1, (1024,), generator=g, device=cuda_device),
        torch.randint(-S, H + 1, (1024,), generator=g, device=cuda_device),
    ], dim=1).to(torch.int32)
    got, got_c = k2.extract_slabs(img, corners, S)
    torch.cuda.synchronize()
    want, want_c = k2.extract_slabs_ref(img, corners, S)
    assert torch.equal(got_c, want_c)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [24, 72])
def test_k2_batched_matches_plain_on_card(cuda_device, S):
    """K2 on a stack of three padded 1080p frames, 1024 points per frame
    (point i from frame i // 1024), corners inside and past every side: one
    launch, bit-equal to its plain version, and each frame's points to a
    2-D launch on that frame."""
    V, n = 3, 1024
    imgs = torch.stack([torch.as_tensor(_slab_image(H=1080 + 2 * 72, W=1920 + 2 * 72, seed=v))
                        for v in range(V)]).to(cuda_device)
    H, W = imgs.shape[1:]
    g = torch.Generator(device=cuda_device).manual_seed(S)
    corners = torch.stack([
        torch.randint(-S, W + 1, (V * n,), generator=g, device=cuda_device),
        torch.randint(-S, H + 1, (V * n,), generator=g, device=cuda_device),
    ], dim=1).to(torch.int32)
    before = k2.extract_slabs.launches
    got, got_c = k2.extract_slabs(imgs, corners, S)
    torch.cuda.synchronize()
    assert k2.extract_slabs.launches == before + 1
    want, want_c = k2.extract_slabs_ref(imgs, corners, S)
    assert torch.equal(got_c, want_c)
    assert torch.equal(got, want)
    for v in range(V):
        one, one_c = k2.extract_slabs(imgs[v], corners[v * n:(v + 1) * n].contiguous(), S)
        assert torch.equal(got[v * n:(v + 1) * n], one)
        assert torch.equal(got_c[v * n:(v + 1) * n], one_c)


# (H, W, size, N) at the gather's edges: one point, a ragged last block
# (N 1020) and none; odd sizes (1, 27), which store 4-byte words; sizes
# whose 4-word steps run into the next row or point (2, 6, 34); a 17 x 30
# top level padded to 34 x 34 (an odd row pitch before the pad); sizes with
# 16-byte rows (24, 72)
WINDOW_EDGES = [(90, 130, 24, 1), (90, 130, 24, 1020), (90, 130, 24, 0),
                (1244, 2084, 72, 1), (1244, 2084, 72, 1020), (1080, 1920, 1, 1024),
                (1080, 1920, 27, 1020), (1080, 1920, 34, 1020), (17, 30, 34, 1024),
                (91, 131, 1, 3), (91, 131, 2, 1020), (91, 131, 6, 1), (91, 131, 6, 1020)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(_GATHERS))
@pytest.mark.parametrize("H,W,size,N", WINDOW_EDGES)
def test_window_gather_edges_on_card(cuda_device, kernel, H, W, size, N):
    """K2 and K3 at their edges, bit-equal to their plain versions (windows
    and clamped corners), with corners inside and past every side; each
    launch counted once (none for N 0)."""
    fn = _GATHERS[kernel]
    img = torch.as_tensor(_slab_image(H=H, W=W, seed=N), device=cuda_device)
    if H < size or W < size:  # as interp.extract_patches pads a top level
        img = torch.nn.functional.pad(img[None, None], (0, max(0, size - W), 0,
                                                         max(0, size - H)),
                                      mode="replicate")[0, 0].contiguous()
    Hp, Wp = img.shape
    g = torch.Generator(device=cuda_device).manual_seed(size)
    corners = torch.stack([
        torch.randint(-size - 5, Wp + 5, (N,), generator=g, device=cuda_device),
        torch.randint(-size - 5, Hp + 5, (N,), generator=g, device=cuda_device),
    ], dim=1).to(torch.int32)
    before = fn.launches
    got, got_c = fn(img, corners, size)
    torch.cuda.synchronize()
    assert fn.launches == before + (N > 0)
    want, want_c = (k2.extract_slabs_ref if kernel == "k2" else k3.extract_patches_ref)(
        img, corners, size)
    assert got.shape == (N, size, size) and got_c.shape == (N, 2)
    assert torch.equal(got_c, want_c)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("caller", ["reanchor", "source", "warped", "subpix", "small"])
def test_extract_slabs_unchanged_on_card(cuda_device, caller):
    """``lk_lanes._extract_slabs`` through K2 gives the slabs and corners
    that the torch clamp and plain gather give, on each caller's image."""
    img, corners, size = _caller_case(caller, device=cuda_device)
    got, got_c = lk_lanes._extract_slabs(img, corners, size)
    torch.cuda.synchronize()
    want, want_c = _extract_slabs_torch_clamp(img, corners, size)
    assert torch.equal(got_c, want_c)
    assert torch.equal(got, want)


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


def _edge_case(kind, win, P, n_taps, cubic, N=1024):
    """K1 inputs at an edge: ``"n"`` (N points, any count), ``"integer"``
    (every first offset an exact integer of the clamp range),
    ``"ends"`` (at both clamp ends, the float below the upper one, and
    past them), ``"all_done"`` (every point done on entry)."""
    args, kw = _case(win, P, n_taps, cubic, N=N, it0=5 if kind == "all_done" else 0,
                     seed=N)
    args = list(args)
    if kind in ("integer", "ends"):
        rng = np.random.default_rng(7)
        lo, hi = (1.0, n_taps - 2.0) if cubic else (0.0, n_taps - 1.0)
        if kind == "integer":
            o = rng.integers(int(lo), int(hi) + 1, (2, N)).astype(np.float32)
        else:
            o = rng.choice(np.array([lo, hi, np.nextafter(np.float32(hi), -np.inf),
                                     lo - 0.25, hi + 0.25], np.float32), (2, N))
        # pts on quarter pixels, so pts - half + b lands exactly on o
        pts = np.round(args[11] * 4) / 4
        half = (win - 1) * 0.5
        args[11] = pts.astype(np.float32)
        args[8] = (o[0] - (pts[0] - half)).astype(np.float32)
        args[9] = (o[1] - (pts[1] - half)).astype(np.float32)
    if kind == "all_done":
        args[12] = np.ones(N, bool)
    return tuple(args), kw


K1_EDGES = [("n", 15, 24, 8, False, 1), ("n", 15, 24, 8, False, 1020),
            ("n", 51, 64, 10, True, 1), ("n", 51, 64, 10, True, 1020),
            ("all_done", 15, 24, 8, False, 1024), ("all_done", 51, 64, 10, True, 1024),
            ("n", 21, 32, 8, False, 1024), ("n", 21, 32, 10, True, 1024),
            ("n", 61, 72, 8, False, 256), ("n", 61, 72, 10, True, 256)]
K1_EDGES += [(kind, *cfg, 1024) for kind in ("integer", "ends") for cfg in CONFIGS]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,win,P,n_taps,cubic,N", K1_EDGES)
def test_k1_edges_match_plain_on_card(cuda_device, kind, win, P, n_taps, cubic, N):
    """K1 at its edges against its plain version: point counts that do not
    fill the warps of a block, offsets on integers and on both clamp ends,
    every point done, windows outside the two kernel shapes (win 21, and
    win 61, whose gradient strips outnumber the block's threads).
    Tolerance rtol 1e-5, atol 1e-4 px, done flags equal."""
    args, kw = _edge_case(kind, win, P, n_taps, cubic, N=N)
    targs = _to_torch_points_major(args, device=cuda_device)
    before = k1.lk_block.launches
    got_p, got_d, got_pd = k1.lk_block(*targs, **kw)
    torch.cuda.synchronize()
    assert k1.lk_block.launches == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("size,H,W", [(34, 1080, 1920), (34, 17, 30),
                                      (82, 1080 + 2 * 82, 1920 + 2 * 82)])
def test_k3_batched_matches_plain_on_card(cuda_device, size, H, W):
    """K3 on a stack of three frames (run_batch's fast engine), 1024 points
    per frame (point i from frame i // 1024), corners inside and past every
    side: one launch, bit-equal to its plain version on the stack (the top
    level padded to the patch frame by frame first), and each frame's
    points to a 2-D launch on that frame."""
    V, n = 3, 1024
    imgs = torch.stack([torch.as_tensor(_slab_image(H=H, W=W, seed=v))
                        for v in range(V)]).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(size)
    corners = torch.stack([
        torch.randint(-size, W + size, (V * n,), generator=g, device=cuda_device),
        torch.randint(-size, H + size, (V * n,), generator=g, device=cuda_device),
    ], dim=1).to(torch.int32)
    before = k3.extract_patches.launches
    got, got_cl = extract_patches(imgs, corners, size)
    torch.cuda.synchronize()
    assert k3.extract_patches.launches == before + 1
    if H < size or W < size:
        imgs = torch.nn.functional.pad(imgs[:, None], (0, max(0, size - W), 0,
                                                       max(0, size - H)),
                                       mode="replicate")[:, 0].contiguous()
    want, want_cl = k3.extract_patches_ref(imgs, corners, size)
    assert torch.equal(got_cl, want_cl)
    assert torch.equal(got, want)
    for v in range(V):
        one, one_cl = k3.extract_patches(imgs[v], corners[v * n:(v + 1) * n].contiguous(), size)
        assert torch.equal(got[v * n:(v + 1) * n], one)
        assert torch.equal(got_cl[v * n:(v + 1) * n], one_cl)


# ------------------------------------------------------------------------ K4


def _subpix_edge_case(h=240, w=320, seed=5):
    """An image whose left half is a smooth random texture and right half
    flat grey, and seeds for ``corner_subpix``: 64 random ones on the
    texture (most drift past half_win + 1 from their seed), 5 at the
    image's border (clamped slabs) and 2 on the flat half (a singular
    system). Returns (image, seeds, the index of the first flat seed)."""
    rng = np.random.default_rng(seed)
    img = torch.as_tensor(rng.uniform(0, 255, (h // 6, w // 6)).astype(np.float32))
    img = torch.nn.functional.interpolate(img[None, None], size=(h, w), mode="bilinear",
                                          align_corners=False)[0, 0].round()
    img[:, w // 2:] = 128.0
    tex = np.stack([rng.uniform(8, w // 2 - 8, 64), rng.uniform(8, h - 8, 64)], 1)
    border = [[0.0, 0.0], [1.5, h / 2], [w - 1.0, h - 1.0], [w / 4, h - 0.5], [w / 4, 2.2]]
    flat = [[w * 0.75, h / 2], [w - 20.3, 30.7]]
    seeds = np.concatenate([tex, border, flat]).astype(np.float32)
    return img.contiguous(), torch.as_tensor(seeds), len(seeds) - len(flat)


def test_plain_subpix_meets_the_edge_cases():
    """On the edge case the plain loop clamps slabs at the border, stops
    at once and leaves the point where it was on a flat window, and lets
    points drift past half_win + 1 and stop there."""
    from velocity_tpu_torch.ops.harris import _subpix_slabs, subpix_loop_ref

    img, seeds, flat = _subpix_edge_case()
    slabs, cl = _subpix_slabs(img, seeds, 5)
    q, iters = subpix_loop_ref(slabs, cl, seeds, 5, 100, 0.001)
    # the slab's corner lies 13 px up and left of the seed's pixel, unless clamped
    assert (cl != torch.floor(seeds).to(torch.int32) - 13).any(dim=1)[64:flat].all()
    assert (iters[flat:] == 1).all() and torch.equal(q[flat:], seeds[flat:])
    drift = (q - seeds).abs().amax(dim=1)
    assert int((drift[:64] > 6).sum()) >= 16
    assert (iters[:64] > 1).all() and (iters < 100).all()


def _scene_seeds(config: str, dev):
    """A frame (or still) of a benchmark configuration's scene (bank 0,
    slot 0) on ``dev``, and the seeds frame-0 init refines on it:
    ``good_features``' max_features - 4 corners (1,020 at the
    configurations' widths) in the plate's ROI, in image coordinates, and
    their validity."""
    import json
    from pathlib import Path

    from benchmark import scene
    from benchmark.drivers._port import pipeline_config
    from velocity_tpu_torch.ops.harris import good_features
    from velocity_tpu_torch.pipeline.roi import bounding_rect

    spec = json.loads((Path(__file__).resolve().parent.parent / "benchmark" / "configs"
                       / f"{config}.json").read_text())
    tc = pipeline_config(spec).tracker
    clip = scene.render(spec["scene"], 2, scene.clip_seed(scene.BANK, 0),
                        scene.clip_seed(scene.BANK, 1), dev)
    gray = torch.as_tensor(clip.grays[0], device=dev)
    x0, x1, y0, y1 = (int(v) for v in bounding_rect(clip.truth.corners_px, tuple(gray.shape),
                                                    border=tc.roi_border))
    corners = good_features(gray[y0:y1, x0:x1], max_corners=tc.max_features - 4,
                            quality_level=tc.harris_quality, block=tc.harris_block,
                            k=tc.harris_k)
    seeds = corners.points + torch.tensor([x0, y0], dtype=torch.float32, device=dev)
    return gray.to(torch.float32), seeds, corners.valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["phone1080p30-lanes-ba", "stills12mp-lanes-ba", "edges"])
def test_k4_matches_plain_on_card(cuda_device, case):
    """``corner_subpix`` on a card (one K2 and one K4 launch, no host read)
    against the plain loop on K2's slabs on the card: 1,020 corners of a
    benchmark frame at 1080p and of a 12 MP still, and the edge case.
    Every valid corner within 2e-3 px (the five sums run in another order,
    and a stop that flips moves a point by under eps), the iteration counts
    equal on at least 99% of the points; on the edge case the flat seeds
    stop at once where they are, and the points that drift past half_win +
    1 in the plain loop drift past it in K4."""
    from velocity_tpu_torch.ops import harris, launches

    if case == "edges":
        img, seeds, flat = _subpix_edge_case()
        img, seeds = img.to(cuda_device), seeds.to(cuda_device)
        valid = torch.ones(seeds.shape[0], dtype=torch.bool, device=cuda_device)
    else:
        img, seeds, valid = _scene_seeds(case, cuda_device)
        assert seeds.shape[0] == 1020
    saved = launches.read()
    try:
        launches.set_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, iters = harris._corner_subpix(img, seeds, 5, 100, 0.001)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        counts = launches.read()
    finally:
        launches.set_counts(saved)
    assert counts["corner_subpix"] == (1, {27: 1})
    assert counts["extract_slabs"] == (1, {27: 1})
    slabs, cl = harris._subpix_slabs(img, seeds, 5)
    want, want_iters = harris.subpix_loop_ref(slabs, cl, seeds, 5, 100, 0.001)
    err = (got - want).abs().amax(dim=1)
    assert float(err[valid].max()) <= 2e-3, float(err[valid].max())
    assert float((iters == want_iters).float().mean()) >= 0.99
    if case == "edges":
        assert (iters[flat:] == 1).all() and torch.equal(got[flat:], seeds[flat:])
        drift = (want - seeds).abs().amax(dim=1) > 6
        assert bool(((got - seeds).abs().amax(dim=1) > 6)[drift].all())


# ------------------------------------------------------------------------ K5

# Stage 3's warped windows at win 51: the forward leg's and the backward
# leg's source windows take the same shape, P 64 (Q 72), anchor offset 29.
K5_P, K5_Q, K5_OO = 64, 72, 29


def _warp_image(H, W, seed):
    """A smooth random texture (as a level of a frame) with a black block
    (exact zeros) and a block below zero, so that the stencils' products
    and sums meet +-0."""
    rng = np.random.default_rng(seed)
    img = torch.as_tensor(rng.uniform(0, 255, (H // 8 + 2, W // 8 + 2)).astype(np.float32))
    img = torch.nn.functional.interpolate(img[None, None], size=(H, W), mode="bilinear",
                                          align_corners=False)[0, 0]
    img[: H // 5, : W // 5] = 0.0
    img[H // 2:, W // 2:] -= 128.0
    return img.contiguous()


def _warp_maps(rng, n):
    """n near-identity affine maps (n, 2, 3), float32."""
    return torch.as_tensor((np.eye(2, 3) + rng.normal(0, [[0.03, 0.03, 2.0]] * 2, (n, 2, 3)))
                           .astype(np.float32))


def _warped_case(kind, device="cpu", N=1024, H=270, W=480):
    """(imgp, pad, centers (2, N), P, M, oo) of a stage-3 call: the level
    edge-padded by Q as ``_level_loop`` pads it, points inside it (and, for
    "edges", on and past the padded image's edges, huge and NaN), a shared
    (2, 3) map or one per point; "backward" hands the centres as the
    transposed view the backward leg's source windows take; "stack" and
    "stack_shared" put V = 3 images in one (V, H, W) stack, lane-major;
    "small_m11" and "edges" give maps with |m11| <= 1e-3 (the reciprocal's
    fallback) and around it."""
    from velocity_tpu_torch.ops.lk import _pad_edge

    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    V = 3 if kind.startswith("stack") else 1
    img = torch.stack([_warp_image(H, W, seed=v) for v in range(V)]) if V > 1 \
        else _warp_image(H, W, seed=7)
    N -= N % V
    pts = np.stack([rng.uniform(-20, W + 20, N), rng.uniform(-20, H + 20, N)], 1)
    shared = torch.tensor([[1.02, 0.03, 1.7], [-0.02, 0.98, -2.3]])
    M = shared if kind in ("forward", "backward", "stack_shared") else _warp_maps(rng, N)
    if kind == "stack":
        M = _warp_maps(rng, V).repeat_interleave(N // V, dim=0)
    if kind in ("small_m11", "edges"):
        f32 = float(np.float32(1e-3))
        m11 = [0.0, 5e-4, -5e-4, f32, -f32, 1.0000001e-3, 2e-3, -0.9]
        M[: len(m11), 1, 1] = torch.tensor(m11)
    if kind == "edges":
        Hp, Wp = H + 2 * K5_Q, W + 2 * K5_Q
        pts[:12] = [[0, 0], [-K5_Q, -K5_Q], [W + K5_Q - 1, H + K5_Q - 1], [-3 * K5_Q, H / 2],
                    [W / 2, -3 * K5_Q], [Wp, Hp], [W - 0.5, H - 0.5], [1e9, -1e9],
                    [-1e9, 1e9], [np.inf, 3.0], [np.nan, 5.0], [12.25, np.nan]]
    pts = torch.as_tensor(pts.astype(np.float32), device=device)
    centers = pts.T if kind == "backward" else pts.T.contiguous()
    return (_pad_edge(img.to(device), K5_Q), K5_Q, centers, K5_P, M.to(device), K5_OO)


def _same_bits(a, b):
    """Equal shapes, NaN at the same places and every other word bit-equal
    (the sign of a zero too)."""
    nan = a.isnan()
    return (a.shape == b.shape and torch.equal(nan, b.isnan())
            and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


@pytest.mark.parametrize("m11", [0.97, 4e-4])
def test_plain_warped_windows_match_jax(m11):
    """The plain stage-3 warped windows (K5's twin, on K2's plain slabs)
    against JAX's ``_extract_warped_lanes`` on one shared map, inside the
    image and past its edges; with |m11| under 1e-3 both take the
    reciprocal's fallback. The corners exactly, the patches within XLA's
    contraction of products into FMAs."""
    import jax.numpy as jnp
    from velocity_tpu.ops.lk_lanes import _extract_warped_lanes as jax_warped

    imgp, pad, centers, P, _, oo = _warped_case("forward", N=96, H=60, W=90)
    M = torch.tensor([[1.02, 0.03, 1.7], [-0.02, m11, -2.3]])
    got, got_c = lk_lanes._extract_warped_lanes_ref(imgp, pad, centers, P, M, oo)
    want, want_c = jax_warped(jnp.asarray(imgp.numpy()), pad, jnp.asarray(centers.numpy()), P,
                              jnp.asarray(M.numpy()), oo)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got.numpy(), np.transpose(np.asarray(want), (2, 0, 1)),
                               rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("kind", ["forward", "backward", "per_point", "stack", "edges"])
def test_k5_wrapper_on_cpu_is_the_plain_version(kind):
    """On the CPU ``_extract_warped_lanes`` is its plain version bit for bit
    and launches nothing: a whole stage-3 forward-backward call leaves every
    kernel counter, K5's too, at 0."""
    from velocity_tpu_torch.ops import launches

    imgp, pad, centers, P, M, oo = _warped_case(kind, N=48, H=60, W=90)
    saved = launches.read()
    try:
        launches.set_counts()
        got, got_c = lk_lanes._extract_warped_lanes(imgp, pad, centers, P, M, oo)
        img = imgp[..., pad:-pad, pad:-pad]
        if kind == "forward":
            pts = torch.as_tensor(np.random.default_rng(2).uniform(10, 50, (24, 2))
                                  .astype(np.float32))
            lk_lanes.lk_forward_backward_lanes(img, img + 1.0, pts, fb_threshold=0.3,
                                               warp_dst=M, win=51, max_level=0, iters=5,
                                               eps=0.001)
        assert launches.read() == {name: (0, {}) for name in launches.counters()}
    finally:
        launches.set_counts(saved)
    want, want_c = lk_lanes._extract_warped_lanes_ref(imgp, pad, centers, P, M, oo)
    assert got.shape == (centers.shape[1], P, P) and got_c.shape == (2, centers.shape[1])
    assert _same_bits(got, want) and _same_bits(got_c, want_c)


def test_k5_wrapper_refuses_bad_inputs():
    """K5's launcher refuses a dtype other than float32, centres that are
    not (2, N), a map that is neither (2, 3) nor one per point, a
    non-contiguous image or map, an image smaller than the slab, points
    that do not split over a stack, and a device other than CUDA, before it
    builds or launches anything; the wrapper sends a device that is neither
    the CPU nor CUDA there."""
    imgp, pad, centers, P, M, oo = _warped_case("per_point", N=12, H=60, W=90)
    meta = [t.to("meta") for t in (imgp, centers, M)]
    with pytest.raises(ValueError, match="unsupported device"):
        lk_lanes._extract_warped_lanes(meta[0], pad, meta[1], P, meta[2], oo)
    with pytest.raises(ValueError, match="unsupported device"):
        lk_lanes.extract_warped(imgp, pad, centers, P, M, oo)
    bad = [(imgp, centers.double(), M), (imgp, centers[:1], M), (imgp, centers, M[:5]),
           (imgp, centers, M[:, :, :2]), (imgp.double(), centers, M), (imgp.t(), centers, M),
           (imgp[:60, :70].contiguous(), centers, M), (imgp[None].expand(5, -1, -1).contiguous(),
                                                      centers, M),
           (imgp, centers, M.transpose(1, 2).contiguous().transpose(1, 2))]
    for img_b, c_b, m_b in bad:
        with pytest.raises(ValueError, match="must be|points on"):
            lk_lanes.extract_warped(img_b, pad, c_b, P, m_b, oo)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["forward", "backward", "per_point", "stack", "stack_shared",
                                  "small_m11", "edges", "frame_1080p"])
def test_k5_matches_plain_on_card(cuda_device, kind):
    """K5 (``_extract_warped_lanes`` on a card: one launch, no host read)
    bit-equal to its plain version on the card, patches and corners: the
    forward leg's and the backward leg's (transposed centres) windows, a
    shared map and one per point, an (H, W) image and a stack of 3, maps
    that take the reciprocal's fallback, points on and past the padded
    image's edges, huge and NaN; and at a 1080p frame's full width, 1,024
    points."""
    from velocity_tpu_torch.ops import launches

    if kind == "frame_1080p":
        imgp, pad, centers, P, M, oo = _warped_case("forward", cuda_device, H=1080, W=1920)
    else:
        imgp, pad, centers, P, M, oo = _warped_case(kind, cuda_device)
    saved = launches.read()
    try:
        launches.set_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, got_c = lk_lanes._extract_warped_lanes(imgp, pad, centers, P, M, oo)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        counts = launches.read()
    finally:
        launches.set_counts(saved)
    assert counts["extract_warped"] == (1, {(K5_P, K5_Q): 1})
    assert counts["extract_slabs"] == (0, {})
    want, want_c = lk_lanes._extract_warped_lanes_ref(imgp, pad, centers, P, M, oo)
    assert _same_bits(got_c, want_c)
    assert float((got - want).abs().nan_to_num().max()) == 0.0
    assert _same_bits(got, want)


@pytest.mark.cuda
def test_k5_captured_stage3_matches_eager_on_card(cuda_device):
    """A stage-3 call (``lk_forward_backward_lanes`` with a warp, win 51,
    level 0, 30 iterations: the frame step's) captured in a CUDA graph in
    the step's fixed-trip form and replayed gives the eager call's points
    and status bit for bit, and its capture counts 7 K5 launches: one for
    each of the forward leg's 6 blocks and one for the backward leg's
    source windows."""
    from velocity_tpu_torch.ops import launches
    from velocity_tpu_torch.utils.loops import fixed_trip_loops

    H, W = 540, 960
    src = _warp_image(H, W, seed=3).to(cuda_device)
    M = torch.tensor([[1.01, 0.02, 3.4], [-0.015, 0.99, -1.2]], device=cuda_device)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=cuda_device),
                            torch.arange(W, dtype=torch.float32, device=cuda_device),
                            indexing="ij")
    # the destination frame: src sampled through the inverse map, so M is the motion
    A = M[:, :2]
    Ai = torch.linalg.inv(A)
    q = torch.stack([xx - M[0, 2], yy - M[1, 2]], dim=-1) @ Ai.T
    grid = torch.stack([q[..., 0] / (W - 1) * 2 - 1, q[..., 1] / (H - 1) * 2 - 1], dim=-1)
    dst = torch.nn.functional.grid_sample(src[None, None], grid[None], align_corners=True,
                                          padding_mode="border")[0, 0].contiguous()
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(np.stack([rng.uniform(40, W - 40, 1024), rng.uniform(40, H - 40, 1024)],
                                   1).astype(np.float32), device=cuda_device)
    kw = dict(fb_threshold=0.3, warp_dst=M, win=51, max_level=0, iters=30, eps=0.001)

    def call():
        with fixed_trip_loops():
            return lk_lanes.lk_forward_backward_lanes(src, dst, pts, **kw)

    want = call()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    torch.cuda.synchronize()
    saved = launches.read()
    try:
        launches.set_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out = call()
        counts = launches.read()
    finally:
        launches.set_counts(saved)
    assert counts["extract_warped"] == (7, {(K5_P, K5_Q): 7})
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.points, want.points) and torch.equal(out.status, want.status)
    assert int(want.status.sum()) > 256  # the points track: the comparison is not of nothing


@pytest.mark.cuda
def test_k5_counts_while_its_caller_is_wrapped(cuda_device, monkeypatch):
    """K5 counts its launch on its own wrapper, ``extract_warped``, also
    while ``_extract_warped_lanes`` is replaced by a wrapper of it, as a
    profiler annotation replaces it."""
    from velocity_tpu_torch.ops import launches

    real = lk_lanes._extract_warped_lanes
    monkeypatch.setattr(lk_lanes, "_extract_warped_lanes", lambda *args: real(*args))
    before = launches.read()
    lk_lanes._extract_warped_lanes(*_warped_case("forward", cuda_device, N=64))
    torch.cuda.synchronize()
    assert launches.since(before)["extract_warped"] == (1, {(K5_P, K5_Q): 1})


# ------------------------------------------------------------------------ K6

# The source windows of a lanes step: (win, cubic) of stages 1-2 (win 15,
# P 24, 4 linear taps), stage 3's forward leg (win 51, P 56) and its
# backward leg (win 51 on K5's P 64 patch, 7 cubic taps)
K6_SHAPES = {"win15": (15, False), "win51": (51, False), "win51_cubic": (51, True)}
K6_KEYS = {"win15": (15, 24, False), "win51": (51, 56, False), "win51_cubic": (51, 64, True)}
K6_THRESH = 1e-4  # the trackers' min_eig_threshold
# the structure tensor's sums against the plain version's: relative to the
# tensor's trace (a12 may cancel to 0), the products after them likewise
K6_RTOL = 1e-5


def _k6_case(kind, device="cpu", N=1024, H=270, W=480):
    """(simg, p_l (2, N), win, Ms) of one level's source window: a textured
    level (with exact zeros and a block below zero), points inside it and
    past its edges, at the level's scale as ``lk_pyramidal_lanes`` hands
    them over (the transposed view of (N, 2) points); "win51_cubic" with
    the backward leg's shared (2, 3) map; "stack" three levels (V, H, W),
    win 15, lane-major; "stack_cubic" the same at win 51 with a map a lane,
    one per point; "edges" win 15 with points on the edges, huge, infinite
    and NaN."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    V = 3 if kind.startswith("stack") else 1
    img = torch.stack([_warp_image(H, W, seed=v) for v in range(V)]) if V > 1 \
        else _warp_image(H, W, seed=11)
    N -= N % V
    pts = np.stack([rng.uniform(-30, W + 30, N), rng.uniform(-30, H + 30, N)], 1)
    if kind == "edges":
        pts[:12] = [[0, 0], [-15, -15], [-16.5, 3], [W - 0.5, H - 0.5], [W + 7.0, 2.0],
                    [1e9, -1e9], [-1e9, 1e9], [np.inf, 3.0], [np.nan, 5.0], [12.25, np.nan],
                    [-np.inf, -np.inf], [7.0, 7.0]]
    win, cubic = K6_SHAPES.get(kind, (51, True) if kind == "stack_cubic" else (15, False))
    Ms = None
    if cubic:
        Ms = (_warp_maps(rng, V).repeat_interleave(N // V, dim=0) if kind == "stack_cubic"
              else torch.tensor([[1.02, 0.03, 1.7], [-0.02, 0.98, -2.3]]))
        Ms = Ms.to(device)
    p_l = torch.as_tensor(pts.astype(np.float32), device=device).T
    return img.to(device), p_l, win, Ms


def _jax_source_window(simg, p_l, win, min_eig_threshold, Ms):
    """JAX's source window (``velocity_tpu/ops/lk_lanes.py:439-475``, the
    body of its level loop, from its own functions) on numpy inputs; the
    windows points-major."""
    import jax.numpy as jnp
    from velocity_tpu.ops import lk_lanes as J

    dtype = jnp.float32
    simg, p_l = jnp.asarray(simg), jnp.asarray(p_l)
    Hs, Ws = simg.shape
    half = (win - 1) * 0.5
    cx, cy = p_l[0], p_l[1]
    src_margin = 2
    src_ok = ((jnp.floor(cx - half) >= -win) & (jnp.floor(cy - half) >= -win)
              & (jnp.floor(cx - half) < Ws) & (jnp.floor(cy - half) < Hs))
    if Ms is None:
        Ps = J._round8(win + 2 * src_margin + 1)
        simgp = J.pad_aligned(simg, Ps)
        ci = jnp.floor(p_l).astype(jnp.int32)
        corners = jnp.stack([ci[0] - (win - 1) // 2 - src_margin + Ps,
                             ci[1] - (win - 1) // 2 - src_margin + Ps], axis=1)
        spatch, scorner = J._extract_slabs(simgp, corners, Ps)
        su = cx - half - (scorner[:, 0] - Ps).astype(dtype)
        sv = cy - half - (scorner[:, 1] - Ps).astype(dtype)
        s_taps, s_cubic = src_margin + 2, False
    else:
        oo_s = (win - 1) // 2 + J.REACH + 1
        Psw = J._round8(win + 2 * J.REACH + 3)
        Qs = J._round8(Psw + J.WARP_TAPS)
        simgp = J.pad_aligned(simg, Qs)
        spatch, scorner2 = J._extract_warped_lanes(simgp, Qs, p_l, Psw, jnp.asarray(Ms), oo_s)
        su = cx - half - scorner2[0]
        sv = cy - half - scorner2[1]
        s_taps, s_cubic = J.REACH + 4, True
    sgx, sgy = J._grad_xy(spatch)
    Ip = J._sample_taps(spatch, sv, su, win, s_taps, cubic=s_cubic)
    gxp = J._sample_taps(sgx, sv, su, win, s_taps, cubic=s_cubic)
    gyp = J._sample_taps(sgy, sv, su, win, s_taps, cubic=s_cubic)
    a11 = jnp.sum(gxp * gxp, axis=(0, 1))
    a12 = jnp.sum(gxp * gyp, axis=(0, 1))
    a22 = jnp.sum(gyp * gyp, axis=(0, 1))
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    min_eig = (tr - jnp.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) * 0.5 / (win * win)
    eig_ok = (min_eig >= min_eig_threshold * 1024.0) & (det >= jnp.finfo(dtype).tiny * 16)
    inv_det = jnp.where(det != 0, 1.0 / det, 0.0)
    pm = lambda a: np.transpose(np.asarray(a), (2, 0, 1))  # noqa: E731
    return (pm(Ip), pm(gxp), pm(gyp), np.asarray(a11), np.asarray(a12), np.asarray(a22),
            np.asarray(inv_det), np.asarray(src_ok & eig_ok), np.asarray(min_eig))


@pytest.mark.parametrize("kind", list(K6_SHAPES))
def test_plain_source_window_matches_jax(kind):
    """The plain source window (K6's twin, on K2's or K5's plain slabs)
    against JAX's, assembled from the JAX engine's own functions, at the
    three shapes of a lanes step, points inside the level and past its
    edges. The windows within XLA's contraction of products into FMAs
    (rtol 1e-5, atol 2e-3, as K5's twin against JAX's warped windows); the
    sums over the window, taken in another order, within 1e-4 relative to
    the tensor's trace; the gate equal but where min_eig lies within that
    margin of the threshold."""
    from velocity_tpu_torch.ops import lk_lanes

    simg, p_l, win, Ms = _k6_case(kind, N=96, H=60, W=90)
    got = lk_lanes._source_window_ref(simg, p_l, win, K6_THRESH, Ms)
    want = _jax_source_window(simg.numpy(), p_l.numpy(), win, K6_THRESH,
                              None if Ms is None else Ms.numpy())
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=2e-3)
    scale = np.abs(want[3]) + np.abs(want[5])
    for g, w in zip(got[3:6], want[3:6]):
        assert (np.abs(g.numpy() - w) <= 1e-4 * scale + 1e-6).all()
    thr = K6_THRESH * 1024.0
    near = np.abs(want[8] - thr) <= 1e-4 * scale / win ** 2
    assert int(want[7].sum()) > 10 and int((~want[7]).sum()) > 10  # both sides of the gate
    np.testing.assert_array_equal(got[7].numpy()[~near], want[7][~near])


@pytest.mark.parametrize("kind", ["win15", "win51_cubic", "stack", "edges"])
def test_k6_wrapper_on_cpu_is_the_plain_version(kind):
    """On the CPU ``source_window`` is its plain version bit for bit and
    launches nothing: a whole lanes call leaves every kernel counter, K6's
    too, at 0."""
    from velocity_tpu_torch.ops import launches

    simg, p_l, win, Ms = _k6_case(kind, N=48, H=60, W=90)
    saved = launches.read()
    try:
        launches.set_counts()
        got = lk_lanes.source_window(simg, p_l, win, K6_THRESH, Ms)
        if kind == "win15":
            pts = p_l.T.contiguous()[:24]
            lk_lanes.lk_forward_backward_lanes(simg, simg + 1.0, pts, fb_threshold=0.3, win=15,
                                               max_level=2, iters=5, eps=0.01)
        assert launches.read() == {name: (0, {}) for name in launches.counters()}
    finally:
        launches.set_counts(saved)
    want = lk_lanes._source_window_ref(simg, p_l, win, K6_THRESH, Ms)
    assert got[0].shape == (p_l.shape[1], win, win) and got[7].dtype == torch.bool
    for g, w in zip(got, want):
        assert _same_bits(g, w) if g.is_floating_point() else torch.equal(g, w)


def test_k6_wrapper_refuses_bad_inputs():
    """K6's wrapper refuses a dtype other than float32, points that are not
    (2, N), a level that is empty or whose stack does not split the points,
    and a device other than CUDA, before it builds or launches anything
    (here on meta tensors: the CPU takes the plain version)."""
    simg, p_l, win, Ms = _k6_case("win51_cubic", N=12, H=60, W=90)
    img, pts, maps = (t.to("meta") for t in (simg, p_l, Ms))
    with pytest.raises(ValueError, match="unsupported device"):
        lk_lanes.source_window(img, pts, win, K6_THRESH, maps)
    with pytest.raises(ValueError, match="unsupported device"):
        lk_lanes.source_window(img, pts, win, K6_THRESH, None)
    bad = [(img, pts.double()), (img, pts.T), (img, pts[:1]), (img.double(), pts),
           (img[None, None], pts), (img[:0], pts), (img[None].expand(5, -1, -1), pts)]
    for img_b, pts_b in bad:
        with pytest.raises(ValueError, match="must be|points on"):
            lk_lanes.source_window(img_b, pts_b, win, K6_THRESH, None)


def _k6_compare(got, want, win):
    """(near, dmax) after holding K6's results to the plain version's on the
    card: Ip, gx and gy bit-equal; a11, a12, a22 within K6_RTOL of the
    trace; det (from the sums) and inv_det within K6_RTOL of the products'
    size carried through 1 / det; trackable equal but on the points whose
    min_eig or det lies within that margin of its threshold (``near``)."""
    for name, g, w in zip(("Ip", "gxp", "gyp"), got[:3], want[:3]):
        assert _same_bits(g, w), f"{name}: max |err| {float((g - w).abs().nan_to_num().max())}"
    g11, g12, g22, ginv = (t.double() for t in got[3:7])
    w11, w12, w22, winv = (t.double() for t in want[3:7])
    finite = torch.isfinite(w11) & torch.isfinite(w12) & torch.isfinite(w22)
    assert torch.equal(finite, torch.isfinite(g11) & torch.isfinite(g12) & torch.isfinite(g22))
    tr = (w11.abs() + w22.abs())[finite]
    dmax = 0.0
    for g, w in ((g11, w11), (g12, w12), (g22, w22)):
        d = (g[finite] - w[finite]).abs()
        assert bool((d <= K6_RTOL * tr).all()), f"sum off by {float((d / tr).max())} of the trace"
        dmax = max(dmax, float((d / tr.clamp_min(1e-30)).max()))
    wdet = (w11 * w22 - w12 * w12)[finite]
    size = (w11 * w22).abs()[finite] + (w12 * w12)[finite]
    gdet = (g11 * g22 - g12 * g12)[finite]
    assert bool(((gdet - wdet).abs() <= 4 * K6_RTOL * size).all())
    carried = 4 * K6_RTOL * size / wdet.abs().clamp_min(1e-30)  # det's margin through 1 / det
    ok = (ginv[finite] - winv[finite]).abs() <= carried * winv[finite].abs() * 1.01 + 1e-30
    assert bool((ok | (wdet.abs() <= 4 * K6_RTOL * size)).all())
    min_eig = ((w11 + w22) - torch.sqrt((w11 - w22) ** 2 + 4 * w12 * w12)) * 0.5 / win ** 2
    thr = K6_THRESH * 1024.0
    near = torch.zeros_like(finite)
    near[finite] = (((min_eig[finite] - thr).abs() <= 2 * K6_RTOL * tr / win ** 2)
                    | ((wdet - 16 * torch.finfo(torch.float32).tiny).abs() <= 4 * K6_RTOL * size))
    assert torch.equal(got[7][~near], want[7][~near])
    return near, dmax


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["win15", "win51", "win51_cubic", "stack", "stack_cubic",
                                  "edges", "frame_1080p"])
def test_k6_matches_plain_on_card(cuda_device, kind):
    """K6 (``source_window`` on a card: one launch, and K5's before it for
    the backward leg, no host read) against its plain version on the card
    at the three shapes of a lanes step, on a stack of three levels (win 15,
    and win 51 with a map a lane), with points on and past the edges, huge
    and NaN, and on a 1080p level at N 1,024: Ip, gx and gy bit-equal, the
    sums within K6_RTOL (``_k6_compare``); prints the points near a gate's
    threshold."""
    from velocity_tpu_torch.ops import launches

    if kind == "frame_1080p":
        simg, p_l, win, Ms = _k6_case("win15", cuda_device, H=1080, W=1920)
    else:
        simg, p_l, win, Ms = _k6_case(kind, cuda_device)
    saved = launches.read()
    try:
        launches.set_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = lk_lanes.source_window(simg, p_l, win, K6_THRESH, Ms)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        counts = launches.read()
    finally:
        launches.set_counts(saved)
    key = (win, 64 if Ms is not None else 24 if win == 15 else 56, Ms is not None)
    assert counts["source_window"] == (1, {key: 1})
    assert counts["extract_warped"][0] == int(Ms is not None)
    assert counts["extract_slabs"] == (0, {})
    want = lk_lanes._source_window_ref(simg, p_l, win, K6_THRESH, Ms)
    near, dmax = _k6_compare(got, want, win)
    print(f"K6 {kind}: windows bit-equal, sums within {dmax:.3g} of the trace, "
          f"{int(near.sum())} of {p_l.shape[1]} points near a gate, "
          f"{int(want[7].sum())} trackable")
    assert int(want[7].sum()) > 64  # the comparison is not of nothing


@pytest.mark.cuda
def test_k6_calls_agree_bit_for_bit_on_card(cuda_device):
    """K6's sums run in a fixed order: two calls, and a call captured in a
    CUDA graph and replayed, give the same bits."""
    simg, p_l, win, Ms = _k6_case("win51_cubic", cuda_device)
    first = lk_lanes.source_window(simg, p_l, win, K6_THRESH, Ms)
    again = lk_lanes.source_window(simg, p_l, win, K6_THRESH, Ms)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = lk_lanes.source_window(simg, p_l, win, K6_THRESH, Ms)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, out):
        assert _same_bits(a, b) and _same_bits(a, c) if a.is_floating_point() \
            else torch.equal(a, b) and torch.equal(a, c)
