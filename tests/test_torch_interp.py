"""The port's sampling primitives (``ops/interp.py``, ``ops/warp.py``) against
the JAX package's, on the CPU at f32.

Tolerance: the largest difference is at most 1e-5 of the largest magnitude
of the JAX result (the same f32 arithmetic; XLA may contract or reorder it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_tpu.ops import interp as jinterp
from velocity_tpu.ops.warp import affine_warp as jax_affine_warp
from velocity_tpu_torch.ops import interp
from velocity_tpu_torch.ops.warp import affine_warp

torch.set_num_threads(1)

REL = 1e-5
M = np.float32([[1.02, 0.008, 1.5], [-0.006, 0.985, -0.8]])


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64))))
    assert err <= rel * scale, (err, scale)


def _image(H=47, W=61, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (H, W)).astype(np.float32)


def _coords(shape, H, W, seed=1):
    """Sample positions inside, on the border and past every side."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, W + 2, shape).astype(np.float32)
    y = rng.uniform(-3, H + 2, shape).astype(np.float32)
    x.flat[:4] = [0.0, W - 1.0, -0.5, W - 0.5]
    y.flat[:4] = [0.0, H - 1.0, H - 0.5, -0.5]
    return x, y


@pytest.mark.parametrize("border", ["clamp", "zero"])
def test_bilinear_sample_matches_jax(border):
    img = _image()
    x, y = _coords((9, 13), *img.shape)
    want = jinterp.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), border)
    got = interp.bilinear_sample(torch.as_tensor(img), torch.as_tensor(x), torch.as_tensor(y),
                                 border)
    _close(got.numpy(), want)


def _centers(N=24, H=47, W=61, seed=2):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-4, W + 4, N), rng.uniform(-4, H + 4, N)], 1).astype(np.float32)


@pytest.mark.parametrize("border", ["clamp", "zero"])
@pytest.mark.parametrize("size", [7, 8])
def test_gather_patches_matches_jax(border, size):
    img, c = _image(), _centers()
    want = jinterp.gather_patches(jnp.asarray(img), jnp.asarray(c), size, border)
    got = interp.gather_patches(torch.as_tensor(img), torch.as_tensor(c), size, border)
    _close(got.numpy(), want)


@pytest.mark.parametrize("border", ["clamp", "zero"])
def test_affine_grid_patches_matches_jax(border):
    img, c = _image(), _centers()
    want = jinterp.affine_grid_patches(jnp.asarray(img), jnp.asarray(c), 9, jnp.asarray(M),
                                       border)
    got = interp.affine_grid_patches(torch.as_tensor(img), torch.as_tensor(c), 9,
                                     torch.as_tensor(M), border)
    _close(got.numpy(), want)


def _offsets(N=16, P=20, seed=3):
    """Fractional offsets inside the patch and past both ends (clipped)."""
    rng = np.random.default_rng(seed)
    off = rng.uniform(-2.0, P + 1.0, N).astype(np.float32)
    off[:3] = [0.0, 0.5, P - 6.25]
    return off


@pytest.mark.parametrize("cubic", [False, True])
def test_sep_weights_match_jax(cubic):
    off = _offsets()
    want = jinterp._sep_weights(jnp.asarray(off), 7, 20, cubic)
    got = interp._sep_weights(torch.as_tensor(off), 7, 20, cubic)
    _close(got.numpy(), want)
    # rows sum to one: the cubic weights renormalise over the clipped support
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cubic", [False, True])
def test_sample_patches_matches_jax(cubic):
    rng = np.random.default_rng(4)
    patches = rng.uniform(0, 255, (16, 20, 20)).astype(np.float32)
    dy, dx = _offsets(seed=5), _offsets(seed=6)
    want = jinterp.sample_patches(jnp.asarray(patches), jnp.asarray(dy), jnp.asarray(dx), 7,
                                  cubic=cubic)
    got = interp.sample_patches(torch.as_tensor(patches), torch.as_tensor(dy),
                                torch.as_tensor(dx), 7, cubic=cubic)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_affine_warp_matches_jax(dtype, border):
    img = _image(31, 45).astype(dtype)
    kw = dict(offset=(3.0, -2.0), border=border)
    want = jax_affine_warp(jnp.asarray(img), jnp.asarray(M), (27, 40), **kw)
    got = affine_warp(torch.as_tensor(img), torch.as_tensor(M), (27, 40), **kw)
    _close(got.numpy(), want)
