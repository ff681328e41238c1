"""The benchmark's arithmetic on fixed inputs: percentiles over every clip,
spreads, the device's busy time as a union, K2's least bytes, and each
per-layer reader."""

from types import SimpleNamespace

import pytest

from benchmark import harness, stats, trace

HERE = harness.HERE


def _metric(name):
    return harness.load_module(HERE / "metrics" / f"{name}.py", name)


def test_percentile_over_all_clips():
    walls = [1.0, 1.1, 1.2, 1.3, 10.0]
    assert stats.percentile(walls, 50) == 1.2
    assert stats.percentile(walls, 100) == 10.0
    # rank 0.95 * 4 = 3.8: 1.3 + 0.8 * (10.0 - 1.3)
    assert stats.percentile(walls, 95) == pytest.approx(8.26)
    assert stats.percentile(list(reversed(walls)), 95) == pytest.approx(8.26)
    assert stats.percentile([2.5], 95) == 2.5


def test_busy_time_is_a_union():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_ns([(0, 100), (10, 20), (30, 40)]) == 100
    assert trace.union_ns([]) == 0


def _trace(device, window_s=1.0, launches=()):
    tr = trace.Trace(window_s=window_s, device=list(device), host=[],
                     graph_launches=set(launches))
    tr.busy_s = trace.union_ns((s, e) for _n, s, e, _c in tr.device) / 1e9
    return tr


def test_device_idle_pct():
    run = SimpleNamespace(trace=_trace([("k", 0, 300_000_000, 1), ("k", 200_000_000, 400_000_000, 2)]))
    assert _metric("device_idle_pct").read(run) == pytest.approx(60.0)
    assert _metric("device_idle_pct").read(SimpleNamespace(trace=None)) is None


def test_step_kernel_ms_counts_graph_kernels_over_replays():
    dev = [("a", 0, 2_000_000, 7), ("b", 3_000_000, 4_000_000, 7), ("eager", 0, 50_000_000, 9)]
    run = SimpleNamespace(trace=_trace(dev, launches=[7]), replays=2)
    assert _metric("step_kernel_ms").read(run) == pytest.approx(1.5)
    run.replays = 0
    assert _metric("step_kernel_ms").read(run) is None


def test_k2_least_bytes_and_roofline():
    k2 = _metric("k2_roofline")
    # 1,024 windows of 72 x 72 float32 written, corners read and written
    assert k2.least_s(72, 1024) == pytest.approx((4 * 1024 * 72 * 72 + 16 * 1024) / 3.35e12)
    tracker = SimpleNamespace(subpix_window=5, max_features=1024)
    counts = {"extract_slabs": (3, {72: 2, 27: 1}), "extract_patches": (0, {}),
              "lk_block": (0, {})}
    least = 2 * k2.least_s(72, 1024) + k2.least_s(27, 1020)
    ns = int(2 * least * 1e9)  # the kernels took twice their least time
    dev = [("void gather_windows<128, 4, true, false>(...)", 0, ns, 1), ("other", 0, 10**9, 2)]
    run = SimpleNamespace(trace=_trace(dev), launches=counts, pcfg=SimpleNamespace(tracker=tracker))
    assert k2.read(run) == pytest.approx(50.0, rel=1e-4)
    counts["extract_patches"] = (1, {34: 1})  # K3 shares the kernel: no split, no reading
    assert k2.read(run) is None


def test_span_metrics_are_means_over_clips():
    clips = [{"timings": {"decode_s": 0.01, "init_s": 0.31, "msv_s": 0.1},
              "pulls": []},
             {"timings": {"decode_s": 0.03, "init_s": 0.43, "msv_s": 0.3},
              "pulls": []}]
    run = SimpleNamespace(clips=clips)
    assert _metric("decode_ms").read(run) == pytest.approx(20.0)
    assert _metric("init_ms").read(run) == pytest.approx(350.0)
    assert _metric("msv_ms").read(run) == pytest.approx(200.0)
    assert _metric("msv_ms").read(SimpleNamespace(clips=[{"timings": {}}])) is None


def test_frame_gap_is_the_median_after_the_msv_frame():
    pulls = [0.0, 1.0, 2.0, 3.0, 3.1, 3.2, 3.3, 3.5]  # msv 2: gaps from frame 3 on
    run = SimpleNamespace(clips=[{"pulls": pulls}], pcfg=SimpleNamespace(msv_frame=2))
    assert _metric("frame_gap_ms").read(run) == pytest.approx(100.0)


def test_end_to_end_readers():
    clips = [{"wall_s": w, "frames": 20} for w in (1.0, 1.1, 1.2, 1.3, 10.0)]
    run = SimpleNamespace(clips=clips, window_s=14.6, setup_s=21.5)
    assert _metric("frames_per_s").read(run) == pytest.approx(100 / 14.6)
    assert _metric("setup_s").read(run) == 21.5
    assert _metric("clip_p95_s").read(run) == pytest.approx(8.26)
    empty = SimpleNamespace(clips=[], window_s=0.0, setup_s=1.0)
    assert _metric("frames_per_s").read(empty) is None
    assert _metric("clip_p95_s").read(empty) is None
