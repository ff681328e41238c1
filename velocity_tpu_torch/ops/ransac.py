"""Fixed-trial batched RANSAC affine estimation (torch twin of ``velocity_tpu/ops/ransac.py``).

K point triples per call are drawn by masked Gumbel top-3, each gives a
closed-form 2x3 affine, the largest masked inlier count wins (first maximum
on ties, as ``jnp.argmax``), then a guarded least-squares refit runs twice.
The Gumbel noise comes from a ``torch.Generator``; a caller may pass the
noise itself (``gumbel``), which is how the tests reproduce the JAX draws,
or, in place of the generator, a ``DrawnNoise``: noise drawn ahead, in the
order the calls would draw it (the frame step captured in a CUDA graph
reads its noise from buffers filled before each replay).

Lanes (JAX's vmap over videos): inputs with a leading lane axis, (V, N, 2),
and one generator per lane, each lane drawing its noise as it does alone.
The per-point and per-hypothesis work runs batched; each lane's matrix
products and 3x3 solves run as its own call, because a batched BLAS or
LAPACK call may pick other kernels and so other bits. Each lane gets the
bits of its own call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _per_lane(fn, *args):
    """``fn`` on each lane of its arguments' leading axis, outputs stacked."""
    outs = [fn(*lane) for lane in zip(*args)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _map_points(src, M):
    """[src 1] @ M^T for (N, 2) points and one (2, 3) map, or per lane."""
    if src.dim() == 3:
        return _per_lane(_map_points, src, M)
    return src @ M[:, :2].T + M[:, 2]


def fit_affine_lsq(src, dst, weights):
    """Weighted LSQ affine M (2x3): dst ~ [src 1] @ M^T, masked by ``weights``
    (with a leading lane axis: one M per lane)."""
    if src.dim() == 3:
        return _per_lane(fit_affine_lsq, src, dst, weights)
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
    M: torch.Tensor  # (2, 3), or (V, 2, 3)
    inliers: torch.Tensor  # (N,) or (V, N) bool (False on masked-out inputs)
    n_inliers: torch.Tensor  # () or (V,)


def gumbel_noise(trials: int, n: int, generator: torch.Generator | None = None,
                 device=None):
    """(trials, n) standard Gumbel f32 noise from ``generator``."""
    u = torch.rand((trials, n), generator=generator, dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log((-torch.log(u.clamp_min(tiny))).clamp_min(tiny))


def draw_gumbel(generator, trials: int, n: int, device, lanes: bool = False):
    """The noise ``estimate_affine_ransac`` draws from ``generator``: (trials,
    n), or with ``lanes`` (V, trials, n) from a list of V generators, lane v
    from the v-th."""
    if lanes:
        return torch.stack([gumbel_noise(trials, n, g, device) for g in generator])
    return gumbel_noise(trials, n, generator, device)


class DrawnNoise:
    """Noise drawn ahead of the RANSAC calls that take it: passed in place
    of their generator, each ``estimate_affine_ransac`` call takes the next
    tensor of ``draws``, in order; ``taken`` counts them."""

    def __init__(self, draws):
        self._draws = list(draws)
        self.taken = 0

    def take(self):
        if self.taken == len(self._draws):
            raise RuntimeError(f"DrawnNoise: more than {len(self._draws)} RANSAC calls")
        self.taken += 1
        return self._draws[self.taken - 1]


def _hypotheses(src, dst, idx3):
    """One lane's exact affines through its (K, 3) triples and their
    predictions: (Ms (K, 2, 3), safe (K,), pred (K, N, 2))."""
    Ms, safe = _affine_from_triples(src[idx3], dst[idx3])
    pred = torch.einsum("nj,kij->kni", src, Ms[:, :, :2]) + Ms[:, None, :, 2]
    return Ms, safe, pred


def _pick(x, index, dim: int):
    """x at ``index`` (one per lane) along ``dim``, that axis dropped."""
    index = index.reshape(index.shape + (1,) * (x.dim() - index.dim()))
    return torch.take_along_dim(x, index, dim=dim).squeeze(dim)


def estimate_affine_ransac(
    src,
    dst,
    mask=None,
    generator=None,
    trials: int = 256,
    threshold: float = 3.0,
    gumbel=None,
) -> AffineRansacResult:
    """RANSAC 2D affine from masked correspondences src, dst (N, 2).

    ``gumbel``: optional (trials, N) f32 noise; drawn from ``generator``
    when absent (taken from it where it is a ``DrawnNoise``). Lanes: src,
    dst (V, N, 2), mask (V, N), ``generator`` a list of V generators (lane
    v draws from the v-th), ``gumbel`` (V, trials, N).
    """
    dtype = src.dtype
    dev = src.device
    lead = src.shape[:-2]  # () or (V,)
    N = src.shape[-2]
    if mask is None:
        mask = torch.ones(lead + (N,), dtype=torch.bool, device=dev)
    if gumbel is None:
        gumbel = (generator.take() if isinstance(generator, DrawnNoise)
                  else draw_gumbel(generator, trials, N, dev, lanes=bool(lead)))

    # 3 distinct-ish valid indices per trial via masked Gumbel top-3
    neg_inf = torch.full((), -float("inf"), dtype=torch.float32, device=dev)
    logits = torch.where(mask, torch.zeros((), dtype=torch.float32, device=dev), neg_inf)
    g = gumbel.to(device=dev, dtype=torch.float32) + logits[..., None, :]
    idx3 = torch.topk(g, 3, dim=-1).indices  # (..., trials, 3)

    if lead:
        Ms, safe, pred = _per_lane(_hypotheses, src, dst, idx3)  # (V, K, 2, 3) ...
    else:
        Ms, safe, pred = _hypotheses(src, dst, idx3)  # (K, 2, 3), (K,), (K, N, 2)
    d2 = torch.sum((pred - dst[..., None, :, :]) ** 2, dim=-1)  # (..., K, N)
    thr2 = threshold * threshold
    inls = mask[..., None, :] & (d2 <= thr2) & safe[..., None]
    counts = torch.sum(inls, dim=-1)
    best = torch.argmax(counts, dim=-1)

    # local optimization: LSQ refit on the inlier set, kept only if it does
    # not lose inliers (a blind refit of a near-degenerate triple collapses)
    M = _pick(Ms, best, -3)
    inliers = _pick(inls, best, -2)
    n_in = _pick(counts, best, -1)
    for _ in range(2):
        M_ref = fit_affine_lsq(src, dst, inliers.to(dtype))
        d2 = torch.sum((_map_points(src, M_ref) - dst) ** 2, dim=-1)
        inl_ref = mask & (d2 <= thr2)
        n_ref = torch.sum(inl_ref, dim=-1)
        better = (n_in >= 3) & (n_ref >= n_in)
        M = torch.where(better[..., None, None], M_ref, M)
        inliers = torch.where(better[..., None], inl_ref, inliers)
        n_in = torch.where(better, n_ref, n_in)

    # guard: if every hypothesis failed, fall back to identity
    eye = torch.eye(2, 3, dtype=dtype, device=dev)
    pred_i = src @ eye[:, :2].T + eye[:, 2]
    d2_i = torch.sum((pred_i - dst) ** 2, dim=-1)
    inl_i = mask & (d2_i <= thr2)
    good = n_in >= 3
    M = torch.where(good[..., None, None], M, eye)
    inliers = torch.where(good[..., None], inliers, inl_i)
    return AffineRansacResult(M=M, inliers=inliers, n_inliers=torch.sum(inliers, dim=-1))
