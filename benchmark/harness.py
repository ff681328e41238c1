"""One run of one cell: render the clip pool, warm up, run a closed loop
with one client through the pool in the seed's order for the window, judge
every clip against the reference, and return the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``'s ``workloads``, its configuration's file, its traffic
mix in ``benchmark/traffic/<traffic>.json``, the mix's driver in
``benchmark/drivers/<driver>.py``, each metric's reader (end-to-end and
per-layer) in ``benchmark/metrics/<metric>.py`` and the cell's limits in
``benchmark/limits/<workload>.json``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from benchmark import scene
from benchmark.reference import control as control_ref
from benchmark.reference import judge

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "velocity_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, spec: dict | None = None):
    """(the workload's entry, its configuration, its traffic mix, the
    benchmark's spec)."""
    spec = spec if spec is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = json.loads((ROOT / cf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    return wl, config, traffic, spec


def driver_class(traffic: dict):
    return load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                       f"benchmark.drivers.{traffic['driver']}").Driver


def end_to_end(spec: dict, wl: dict) -> list:
    """The end-to-end metrics that this cell reports."""
    return [m for m in spec["end_to_end"] if "workloads" not in m or wl["name"] in m["workloads"]]


def per_layer(spec: dict, wl: dict) -> list:
    """The per-layer metrics that this cell reports."""
    reports = {m["name"] for m in end_to_end(spec, wl)}
    return [m for m in spec["per_layer"]
            if m["moves"] in reports and ("workloads" not in m or wl["name"] in m["workloads"])]


def read_metrics(entries: list, run) -> dict:
    """Each metric's reader (``metrics/<name>.py``) on ``run``; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in entries:
        v = load_module(HERE / "metrics" / f"{m['name']}.py",
                        f"benchmark.metrics.{m['name']}").read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def limits(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Run:
    """What the metrics' readers read: the set-up, the window and its clips,
    the clip traced with CUDA activity alone and the program's counters over
    it, the configuration."""

    def __init__(self, pcfg):
        self.pcfg = pcfg  # the PipelineConfig the driver runs
        self.setup_s = 0.0  # process start to the first timed call
        self.window_s = 0.0  # first timed call to the last clip's return
        self.clips = []  # {"wall_s", "frames", "timings", "pulls"}
        self.trace = None  # trace.Trace of the traced clip (CUDA activity alone)
        self.launches = None  # ops.launches counts made in the traced clip
        self.replays = 0  # captured-step replays in the traced clip


def _replays() -> int:
    from velocity_tpu_torch.pipeline.step_graph import step_graphs

    return sum(g.replays for g in step_graphs().values())


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, control: bool = False, adjust=None,
             limits_for=None, before_window=None, log=print) -> dict:
    """One run; returns the result line's object. ``control``: judge the
    reference's bfloat16 answers in the program's place (the control).
    ``adjust(config, traffic)``, where given, changes the loaded
    configuration and mix in place, and ``limits_for`` replaces the cell's
    limits (the tests' small sizes); ``before_window()`` runs after the
    warm-up (the tests' faults)."""
    t_start = time.perf_counter() if t_start is None else t_start
    wl, config, traffic, spec = cell(workload)
    if adjust is not None:
        adjust(config, traffic)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    n = traffic["frames"]
    marks = {"start": time.perf_counter() - t_start}
    pool = scene.pool(config["scene"], n, traffic["pool"], dev)
    slots = scene.order(seed, len(pool))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks["render"] = time.perf_counter() - t_start
    drv = driver_class(traffic)(config, traffic, dev)
    msv = drv.pcfg.msv_frame
    items = [drv.prepare(c) for c in pool]
    gps = (config["gps_fix"], config["yaw_deg"]) if config.get("gps_fix") else None

    def call(k):
        item = items[slots[k % len(slots)]]
        item[0].pulls = []
        t0 = time.perf_counter()
        ans = drv(item)
        if cuda:
            torch.cuda.synchronize(dev)
        return t0, time.perf_counter(), ans, item[0].pulls

    marks["driver"] = time.perf_counter() - t_start
    call(0)  # warm-up at the cell's own shapes: builds, captures
    run = Run(drv.pcfg)
    run.setup_s = time.perf_counter() - t_start
    log("set-up, s from process start: " + ", ".join(f"{k} {v:.3f}" for k, v in marks.items())
        + f", warm-up {run.setup_s:.3f}", file=sys.stderr)
    if before_window is not None:
        before_window()
    done, attempted, failed = [], 0, 0
    t_w0 = time.perf_counter()
    t_end = t_w0
    while not attempted or t_end - t_w0 < seconds:
        k = attempted
        attempted += 1
        try:
            t0, t_end, ans, pulls = call(k)
        except Exception as exc:  # a clip that raises is a failed attempt
            failed += 1
            t_end = time.perf_counter()
            log(f"clip {k} raised {type(exc).__name__}: {exc}", file=sys.stderr)
            continue
        done.append((slots[k % len(slots)], ans))
        log(f"clip {k} (slot {slots[k % len(slots)]}): {t_end - t0:.4f} s, "
            + ", ".join(f"{key} {v:.4f}" for key, v in ans["timings"].items()
                        if key.endswith("_s") and isinstance(v, float)), file=sys.stderr)
        run.clips.append({"wall_s": t_end - t0, "frames": n, "timings": ans["timings"],
                          "pulls": pulls})
    run.window_s = t_end - t_w0

    if trace:
        from benchmark import trace as tracing
        from velocity_tpu_torch.ops import launches

        before, r0 = launches.read(), _replays()
        (_t0, _t1, ans, _p), run.trace = tracing.traced(lambda: call(attempted))
        run.launches, run.replays = launches.since(before), _replays() - r0
        done.append((slots[attempted % len(slots)], ans))
        # the next clip with host ops recorded too, to name the idle gaps
        (_t0, _t1, ans, _p), named = tracing.traced(lambda: call(attempted + 1), host=True)
        done.append((slots[(attempted + 1) % len(slots)], ans))
        log(f"traced clips: {run.trace.window_s:.4f} s (CUDA activity), "
            f"{named.window_s:.4f} s (and host ops)", file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    out = {"correct": False, "attempted": attempted, "failed": failed}
    metrics = read_metrics(per_layer(spec, wl) if trace else end_to_end(spec, wl), run)
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": named.idle_gaps()}
        run.trace = named = None

    # the program's state goes before the reference runs
    del drv, items, call
    from velocity_tpu_torch.pipeline.step_graph import release_step_graphs

    release_step_graphs()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    per_clip = []
    for j, ans in done:
        truth = pool[j].truth
        if control:
            ans = control_ref.answers(ans, truth, gps)
        per_clip.append(judge.readings(ans, truth, n, msv, gps))
    worst = judge.worst(per_clip)
    lim = limits(workload) if limits_for is None else limits_for
    checks = {k: {"value": worst.get(k, math.inf), "limit": v} for k, v in lim.items()}
    checks["missing"] = {"value": worst.get("missing", 1.0), "limit": 0}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = (bool(lim) and bool(per_clip)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out.update(correct=correct, metrics=metrics, device=device_info)
    out["readings"] = worst
    out["checks"] = checks
    return out

