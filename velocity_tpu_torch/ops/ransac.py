"""Fixed-trial batched RANSAC affine estimation (torch twin of ``velocity_tpu/ops/ransac.py``).

K point triples per call are drawn by masked Gumbel top-3, each gives a
closed-form 2x3 affine, the largest masked inlier count wins (first maximum
on ties, as ``jnp.argmax``), then a guarded least-squares refit runs twice.
The Gumbel noise comes from a ``torch.Generator``; a caller may pass the
noise itself (``gumbel``), which is how the tests reproduce the JAX draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def fit_affine_lsq(src, dst, weights):
    """Weighted LSQ affine M (2x3): dst ~ [src 1] @ M^T, masked by ``weights``."""
    dtype = src.dtype
    w = weights.to(dtype)[:, None]
    A = torch.cat([src, torch.ones((src.shape[0], 1), dtype=dtype, device=src.device)], dim=1)
    Aw = A * w
    G = A.T @ Aw  # (3, 3) normal equations for both output rows at once
    B = Aw.T @ dst  # (3, 2)
    jitter = torch.eye(3, dtype=dtype, device=src.device) * torch.finfo(dtype).eps * torch.trace(G)
    sol = torch.linalg.solve_ex(G + jitter, B).result  # singular -> non-finite, as jnp
    return sol.T


def _affine_from_triples(s3, d3):
    """Exact affines through (K, 3, 2) correspondences -> ((K, 2, 3), safe (K,))."""
    dtype = s3.dtype
    ones = torch.ones(s3.shape[:-1] + (1,), dtype=dtype, device=s3.device)
    A = torch.cat([s3, ones], dim=-1)  # (K, 3, 3)
    det = torch.linalg.det(A)
    safe = torch.abs(det) > 1e-6
    eye = torch.eye(3, dtype=dtype, device=s3.device).expand_as(A)
    Asafe = torch.where(safe[:, None, None], A, eye)
    # a triple that is singular in f32 despite the det guard yields a
    # non-finite model with no inliers (jnp.linalg.solve's behaviour), not an error
    sol = torch.linalg.solve_ex(Asafe, d3).result  # (K, 3, 2)
    return sol.transpose(1, 2), safe


class AffineRansacResult(NamedTuple):
    M: torch.Tensor  # (2, 3)
    inliers: torch.Tensor  # (N,) bool (False on masked-out input lanes)
    n_inliers: torch.Tensor


def gumbel_noise(trials: int, n: int, generator: torch.Generator | None = None,
                 device=None):
    """(trials, n) standard Gumbel f32 noise from ``generator``."""
    u = torch.rand((trials, n), generator=generator, dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log((-torch.log(u.clamp_min(tiny))).clamp_min(tiny))


def estimate_affine_ransac(
    src,
    dst,
    mask=None,
    generator: torch.Generator | None = None,
    trials: int = 256,
    threshold: float = 3.0,
    gumbel=None,
) -> AffineRansacResult:
    """RANSAC 2D affine from masked correspondences src, dst (N, 2).

    ``gumbel``: optional (trials, N) f32 noise; drawn from ``generator``
    when absent.
    """
    dtype = src.dtype
    dev = src.device
    N = src.shape[0]
    if mask is None:
        mask = torch.ones(N, dtype=torch.bool, device=dev)
    if gumbel is None:
        gumbel = gumbel_noise(trials, N, generator, dev)

    # 3 distinct-ish valid indices per trial via masked Gumbel top-3
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
    logits = torch.where(mask, torch.zeros((), dtype=torch.float32, device=dev), neg_inf)
    g = gumbel.to(device=dev, dtype=torch.float32) + logits[None, :]
    idx3 = torch.topk(g, 3, dim=1).indices  # (trials, 3)

    Ms, safe = _affine_from_triples(src[idx3], dst[idx3])  # (K, 2, 3)
    pred = torch.einsum("nj,kij->kni", src, Ms[:, :, :2]) + Ms[:, None, :, 2]
    d2 = torch.sum((pred - dst[None]) ** 2, dim=2)  # (K, N)
    thr2 = threshold * threshold
    inls = mask[None, :] & (d2 <= thr2) & safe[:, None]
    counts = torch.sum(inls, dim=1)
    best = torch.argmax(counts)

    # local optimization: LSQ refit on the inlier set, kept only if it does
    # not lose inliers (a blind refit of a near-degenerate triple collapses)
    M = Ms[best]
    inliers = inls[best]
    n_in = counts[best]
    for _ in range(2):
        M_ref = fit_affine_lsq(src, dst, inliers.to(dtype))
        pred = src @ M_ref[:, :2].T + M_ref[:, 2]
        d2 = torch.sum((pred - dst) ** 2, dim=1)
        inl_ref = mask & (d2 <= thr2)
        n_ref = torch.sum(inl_ref)
        better = (n_in >= 3) & (n_ref >= n_in)
        M = torch.where(better, M_ref, M)
        inliers = torch.where(better, inl_ref, inliers)
        n_in = torch.where(better, n_ref, n_in)

    # guard: if every hypothesis failed, fall back to identity
    eye = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], dtype=dtype, device=dev)
    pred_i = src @ eye[:, :2].T + eye[:, 2]
    d2_i = torch.sum((pred_i - dst) ** 2, dim=1)
    inl_i = mask & (d2_i <= thr2)
    good = n_in >= 3
    M = torch.where(good, M, eye)
    inliers = torch.where(good, inliers, inl_i)
    return AffineRansacResult(M=M, inliers=inliers, n_inliers=torch.sum(inliers))
