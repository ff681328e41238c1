"""Each cell run on the CPU at a small size: the program comes out correct,
the control (the reference's bfloat16 answers in its place) does not, and
neither does a run whose timed path is broken underneath: a frame step that
returns its state unchanged, half of each clip's frames left out, and an
answer altered where it is produced. (A fault in an exchange between chips
has no place in these one-chip cells.)"""

import pytest

from benchmark import harness
from benchmark.drivers import _port
from benchmark.tests.small import LIMITS, shrink

WORKLOADS = [w["name"] for w in harness.cell(
    "phone1080p30-lanes-ba.scan20")[3]["workloads"]]
SEED = 2**31 + 977


def _run(workload, **kw):
    return harness.run_cell(workload, SEED, 0.0, False, device="cpu", adjust=shrink(),
                            limits_for=LIMITS, log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_correct_and_control_not(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    ctrl = _run(workload, control=True)
    assert not ctrl["correct"]
    failed = [k for k, c in ctrl["checks"].items() if c["value"] > c["limit"]]
    assert "track_err_px" in failed and "residual_px" in failed


def _step_faults(monkeypatch, fault):
    import velocity_tpu_torch.pipeline.speedest as speedest
    import velocity_tpu_torch.pipeline.step_graph as step_graph

    real = step_graph.fused_frame_step_pyr

    def broken(*a):
        out = real(*a)
        if fault == "unchanged":  # the state goes out as it came in
            t_prev = a[12] if a[12] is not None else out[5]
            return (out[0], out[1], a[3], a[4], a[5], t_prev.to(out[5].dtype), *out[6:])
        return (out[0], out[1], out[2] + 2.0, *out[3:])  # every track moved 2 px

    def arm():
        monkeypatch.setattr(step_graph, "fused_frame_step_pyr", broken)
        monkeypatch.setattr(speedest, "fused_frame_step_pyr", broken)

    return arm


def _half_the_frames(monkeypatch):
    video, burst = _port.ClipReader.frames, _port.BurstReader.frames

    def clip_half(self, start=0, count=None, step=1):
        n = len(self.grays) // 2
        yield from video(self, start, n if count is None else min(count, n), step)

    def burst_half(self):
        for k, item in enumerate(burst(self)):
            if k >= len(self.grays) // 2:
                return
            yield item

    def arm():
        monkeypatch.setattr(_port.ClipReader, "frames", clip_half)
        monkeypatch.setattr(_port.BurstReader, "frames", burst_half)

    return arm


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    arm = (_half_the_frames(monkeypatch) if fault == "half"
           else _step_faults(monkeypatch, fault))
    out = _run(workload, before_window=arm)
    assert not out["correct"], out["checks"]
