"""The ``k6_roofline`` reader on a hand-made trace: K6's least bytes, its
share of the roofline summed over the three shapes of a lanes step, never
above 100% for launches at their least time, K5's reader and K6's each
leaving the other's kernel out, and no reading on a program without K6's
counter or a trace without K6's kernels."""

from types import SimpleNamespace

import pytest

from benchmark.tests.test_bench_metrics import _metric, _trace

# one lanes step's K6 launches: stages 1-2 at win 15, stage 3's two legs
STEP = {(15, 24, False): 15, (51, 56, False): 1, (51, 64, True): 1}


def _run(dev, counts):
    tracker = SimpleNamespace(max_features=1024)
    return SimpleNamespace(trace=_trace(dev), launches=counts,
                           pcfg=SimpleNamespace(tracker=tracker))


def test_k6_least_bytes_and_roofline():
    k6 = _metric("k6_roofline")
    # Ip, gx, gy (3 x 15 x 15 float32), four floats and a flag a point
    assert k6.least_s(15, 1024) == pytest.approx((4 * 1024 * (3 * 225 + 4) + 1024) / 3.35e12)
    least = 15 * k6.least_s(15, 1024) + 2 * k6.least_s(51, 1024)
    counts = {"extract_warped": (7, {(64, 72): 7}), "source_window": (17, dict(STEP))}
    ns = int(round(4 * least * 1e9))  # K6 took four times its least time
    dev = [("void (anonymous namespace)::source_window_warp<false>((anonymous namespace)::Args)",
            0, ns // 2, 1),
           ("void (anonymous namespace)::source_window_block<true>((anonymous namespace)::Args)",
            ns // 2, ns, 2),
           ("(anonymous namespace)::warp_window((anonymous namespace)::Args)", 0, 10**6, 3)]
    assert k6.read(_run(dev, counts)) == pytest.approx(25.0, rel=1e-4)
    # launches at their least time read 100%, not more
    at_least = int(round(least * 1e9))
    assert k6.read(_run([(dev[0][0], 0, at_least, 1)], counts)) == pytest.approx(100.0, rel=1e-3)
    # K5's reader leaves K6's kernels out, and K6's K5's
    assert _metric("k5_roofline").read(_run(dev[:2], counts)) is None
    assert k6.read(_run(dev[2:], counts)) is None
    # a program without K6's counter (the parent of K6) reads nothing
    assert k6.read(_run(dev, {"extract_warped": (7, {(64, 72): 7})})) is None
    assert k6.read(SimpleNamespace(trace=None, launches=counts, pcfg=None)) is None
