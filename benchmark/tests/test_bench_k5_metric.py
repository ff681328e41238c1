"""The ``k5_roofline`` reader on a hand-made trace: K5's least bytes, its
share of the roofline, K2's reader and K5's each leaving the other's
kernel out, and no reading on a program without K5's counter or a trace
without K5's kernel."""

from types import SimpleNamespace

import pytest

from benchmark.tests.test_bench_metrics import _metric, _trace


def test_k5_least_bytes_and_roofline():
    k5 = _metric("k5_roofline")
    # 1,024 patches of 64 x 64 float32 and the (2, N) corner written
    assert k5.least_s(64, 1024) == pytest.approx((4 * 1024 * 64 * 64 + 8 * 1024) / 3.35e12)
    tracker = SimpleNamespace(max_features=1024)
    counts = {"extract_slabs": (5, {72: 5}), "extract_warped": (7, {(64, 72): 7})}
    ns = int(4 * 7 * k5.least_s(64, 1024) * 1e9)  # K5 took four times its least time
    dev = [("(anonymous namespace)::warp_window((anonymous namespace)::Args)", 0, ns, 1),
           ("void gather_windows<256, 4, false, false>(...)", 0, 10**6, 2)]
    run = SimpleNamespace(trace=_trace(dev), launches=counts, pcfg=SimpleNamespace(tracker=tracker))
    assert k5.read(run) == pytest.approx(25.0, rel=1e-4)
    # K2's reader leaves K5's kernel out, and K5's K2's
    assert _metric("k2_roofline").read(SimpleNamespace(
        trace=_trace(dev[:1]), launches={**counts, "extract_patches": (0, {})},
        pcfg=SimpleNamespace(tracker=SimpleNamespace(subpix_window=5, max_features=1024)))) is None
    # a program without K5's counter (the parent of K5) reads nothing, nor a trace without K5
    run.launches = {"extract_slabs": (5, {72: 5})}
    assert k5.read(run) is None
    run.launches, run.trace = counts, _trace(dev[1:])
    assert k5.read(run) is None
