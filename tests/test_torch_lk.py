"""The port's pyramids, lanes LK engine and RANSAC against the JAX package
(CPU, small sizes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_tpu.ops.lk_lanes import lk_forward_backward_lanes as jax_fb
from velocity_tpu.ops.lk_lanes import lk_pyramidal_lanes as jax_lk
from velocity_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from velocity_tpu.ops.pyramid import resize_nearest as jax_resize_nearest
from velocity_tpu.ops.ransac import estimate_affine_ransac as jax_ransac
from velocity_tpu_torch.ops.lk_lanes import lk_forward_backward_lanes, lk_pyramidal_lanes
from velocity_tpu_torch.ops.pyramid import build_pyramid, resize_nearest
from velocity_tpu_torch.ops.ransac import estimate_affine_ransac
from velocity_tpu_torch.testing.synthetic_clip import render_clip

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(240, 320), (67, 93)])
def test_pyramid_and_resize_match_jax(shape):
    """pyr_down as a stencil vs the JAX matmul form: the same 5-tap sums in
    another order, within 1e-4 (f32 on 0..255 data); nearest resize is a
    selection, compared exactly."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = jax_build_pyramid(jnp.asarray(img), 4)
    got = build_pyramid(torch.as_tensor(img), 4)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(resize_nearest(torch.as_tensor(img), 0.25).numpy(),
                                  np.asarray(jax_resize_nearest(jnp.asarray(img), 0.25)))
    f = img.astype(np.float32)
    np.testing.assert_array_equal(resize_nearest(torch.as_tensor(f), 0.25).numpy(),
                                  np.asarray(jax_resize_nearest(jnp.asarray(f), 0.25)))


@pytest.fixture(scope="module")
def pair():
    """Two consecutive frames of the synthetic clip at 240x320 (the car
    recedes: scale change plus drift) and points spread over the frame."""
    clip = render_clip(n_frames=2, width=320, height=240, seed=4)
    a, b = (g.astype(np.float32) for g in clip.reader.grays)
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(4, 316, 96), rng.uniform(4, 236, 96)], 1).astype(np.float32)
    return a, b, pts


# near-identity affine prior, as a stage-3 RANSAC estimate would be
M = np.float32([[1.02, 0.008, 1.5], [-0.006, 0.985, -0.8]])


@pytest.mark.parametrize("form", ["plain", "warped", "fb", "fb_warped"])
def test_lk_matches_jax(pair, form):
    """Plain, warped (stage-3 forward) and forward-backward LK, the last
    with the backward-warped leg. Status agrees on >= 99% of lanes; points
    valid in both agree within 1e-3 px (f32 sums in another order)."""
    a, b, pts = pair
    if form in ("plain", "fb"):
        kw = dict(win=15, max_level=3, iters=10, eps=0.1)
    else:
        kw = dict(win=51, max_level=0, iters=30, eps=0.001, warp_dst=M)
    if form.startswith("fb"):
        kw["fb_threshold"] = 0.3
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    fj = jax_fb if form.startswith("fb") else jax_lk
    ft = lk_forward_backward_lanes if form.startswith("fb") else lk_pyramidal_lanes
    want = fj(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pts), **jkw)
    got = ft(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(pts), **tkw)
    sw, sg = np.asarray(want.status), got.status.numpy()
    assert (sw == sg).mean() >= 0.99
    both = sw & sg
    assert both.sum() >= 20
    np.testing.assert_allclose(got.points.numpy()[both], np.asarray(want.points)[both],
                               rtol=0, atol=1e-3)


def test_ransac_matches_jax_with_injected_noise():
    """With JAX's own Gumbel draws, the port samples the same triples: the
    same inlier set and M within 1e-4 (3x3 solves in another order)."""
    rng = np.random.default_rng(7)
    N, trials = 200, 64
    src = rng.uniform(0, 400, (N, 2)).astype(np.float32)
    A = np.float32([[1.01, 0.02, 3.0], [-0.015, 0.99, -2.0]])
    dst = src @ A[:, :2].T + A[:, 2] + rng.normal(0, 0.3, (N, 2)).astype(np.float32)
    dst[:50] += rng.uniform(-40, 40, (50, 2)).astype(np.float32)  # outliers
    mask = rng.random(N) > 0.1
    key = jax.random.PRNGKey(3)
    g = np.asarray(jax.random.gumbel(key, (trials, N), dtype=jnp.float32))
    want = jax_ransac(jnp.asarray(src), jnp.asarray(dst), mask=jnp.asarray(mask), key=key,
                      trials=trials, threshold=3.0)
    got = estimate_affine_ransac(torch.as_tensor(src), torch.as_tensor(dst),
                                 mask=torch.as_tensor(mask), trials=trials, threshold=3.0,
                                 gumbel=torch.as_tensor(g))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.M.numpy(), np.asarray(want.M), rtol=0, atol=1e-4)
    assert int(got.n_inliers) == int(want.n_inliers)


def test_ransac_draws_its_own_noise_from_the_generator():
    """Without injected noise RANSAC draws standard Gumbel noise from its
    generator (finite, mean 0.5772 and std 1.2825 within 2%, the same draws
    from the same seed), so its hypotheses are random triples of valid
    lanes: on points with 40% outliers it finds the outliers, and its model
    maps every inlier within the threshold, whatever the seed."""
    from velocity_tpu_torch.ops.ransac import gumbel_noise

    g = gumbel_noise(256, 1024, torch.Generator().manual_seed(0))
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.02 and abs(float(g.std()) - 1.2825) < 0.03
    assert torch.equal(g, gumbel_noise(256, 1024, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(8)
    N = 184  # a capacity at which noise of NaNs made every hypothesis fail
    src = rng.uniform(0, 400, (N, 2)).astype(np.float32)
    A = np.float32([[0.9, 0.01, 20.0], [-0.01, 0.9, 12.0]])
    dst = src @ A[:, :2].T + A[:, 2]
    out = rng.random(N) < 0.4
    dst[out] += rng.uniform(20, 60, (int(out.sum()), 2)).astype(np.float32)
    mask = np.ones(N, bool)
    mask[100:] = False  # dead lanes: never part of a hypothesis
    for seed in range(3):
        r = estimate_affine_ransac(torch.as_tensor(src), torch.as_tensor(dst),
                                   mask=torch.as_tensor(mask), trials=64, threshold=3.0,
                                   generator=torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(r.inliers.numpy(), mask & ~out)
        M = r.M.numpy()
        inl = mask & ~out
        assert (np.linalg.norm(src[inl] @ M[:, :2].T + M[:, 2] - dst[inl], axis=1) <= 3.0).all()
