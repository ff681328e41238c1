"""The ``subpix_iters`` reader on a fixed run, and on runs whose program
keeps no counter ``subpix.iterations`` (or no record at all), where it
gives no reading and does not raise."""

from types import SimpleNamespace

import pytest

from benchmark.tests.test_bench_metrics import _metric


def _run(*counts):
    spans = [("run", None, 0, 10)]
    return SimpleNamespace(clips=[{"timings": {"spans": spans, "counts": c}, "pulls": []}
                                  for c in counts])


def test_subpix_iters_is_the_mean_over_the_window_clips():
    run = _run({"subpix.iterations": 100, "reanchor.iterations": 9},
               {"subpix.iterations": 200}, {"subpix.iterations": 60})
    assert _metric("subpix_iters").read(run) == pytest.approx(120.0)


def test_subpix_iters_reads_nothing_without_the_counter():
    assert _metric("subpix_iters").read(_run({"reanchor.iterations": 9}, {})) is None
    no_record = SimpleNamespace(clips=[{"timings": {"wall_s": 1.0}, "pulls": []}])
    assert _metric("subpix_iters").read(no_record) is None
