"""The frame step captured as one CUDA graph, replayed once per frame.

JAX runs the fused frame step as one compiled program (a ``lax.scan`` body
in the scan runner, a ``jax.jit`` call in the per-frame driver), with its
loops as ``lax.while_loop``s on the device. The port's step
(``fused_frame_step_pyr``) copies nothing to the device, and in its captured
form (its loops at their fixed trip count, ``utils/loops.py``) it reads
nothing back to the host, so on a card it is captured once as a CUDA graph
(``_StepGraph``, one per device, input shapes and dtypes, configuration and
``lean``; the ``STEP_GRAPHS_KEPT`` most recently used are kept in one LRU
for the process, ``release_step_graphs()`` drops them) and each frame is one
replay of it: the frame, the carry, the structure, the camera and the
frame's RANSAC noise (drawn from the frame's generator before the replay, in
the order the step would draw it) are copied into the graph's input
buffers, and it writes its outputs into buffers of its own, which the next
replay overwrites. ``scan_segment`` (``pipeline/scan.py``) and the per-frame
drivers (``pipeline/speedest.py``, ``pipeline/stills.py``) replay it; a
driver and a non-lean segment on the same device, shapes and configuration
share one capture. A capture that fails raises; nothing falls back to the
eager step on a card.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from velocity_tpu_torch.ops import launches
from velocity_tpu_torch.ops.ransac import DrawnNoise, draw_gumbel, gumbel_noise
from velocity_tpu_torch.pipeline.tracker import RANSAC_CALLS, fused_frame_step_pyr, pack_summary
from velocity_tpu_torch.utils import profiling
from velocity_tpu_torch.utils.loops import fixed_trip_loops


def _frame(im, carry, p3, intr, generator, cfg, solver_cfg, solver_dtype, lean):
    """One frame step, the body of both forms of the step: (the next carry,
    what a segment stacks of the frame)."""
    pyr, spyr, pts, vg, vp, t_prev = carry
    (pyr, spyr, pts, vg, vp, t, res, pproj, n2, _T23) = fused_frame_step_pyr(
        pyr, spyr, im, pts, vg, vp, p3, intr, generator, cfg, solver_cfg, solver_dtype, t_prev)
    carry = (pyr, spyr, pts, vg, vp, t.to(t_prev.dtype))
    return carry, ((pack_summary(t, res, vg, n2),) if lean
                   else (pts, vg, vp, t, res, pproj, n2))


def _flat(x):
    """The tensors of nested tuples, in order."""
    return [x] if isinstance(x, torch.Tensor) else [t for e in x for t in _flat(e)]


def _clone(x):
    """A copy of nested tuples (named or not) of tensors."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    items = [_clone(e) for e in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


class _StepGraph:
    """``_frame`` captured as one CUDA graph on the device of its inputs.

    The capture runs the step once on a side stream (which loads the
    kernels' library and the BLAS handles), then captures it on that
    stream from copies of the first call's inputs, which stay the graph's
    input buffers, with ``ransac.DrawnNoise`` over noise buffers in place
    of the generator; both runs take the step's fixed-trip form
    (``utils/loops.py``). The kernels' wrappers count their launches while
    the graph is captured only, so the counters are set back after the
    capture and each replay adds the capture's counts (``launches``).

    Kept for reports: ``capture_s`` (warm-up and capture, seconds),
    ``pool_bytes`` (the segments of the graph's private memory pool, which
    holds its outputs and every intermediate), ``input_bytes`` (its input
    buffers), ``replays``; and ``graph`` (``keep_graph=True``: its nodes
    can be counted from ``graph.raw_cuda_graph()``). Inside a driver's run
    the capture is the span ``graph.capture`` and adds one to the counter
    ``graph.captures``.
    """

    @profiling.spanned("graph.capture")
    def __init__(self, im, carry, p3, intr, cfg, solver_cfg, solver_dtype, lean):
        profiling.count("graph.captures")
        dev = im.device
        t0 = time.perf_counter()
        counts = launches.read()
        self.inputs = _clone((im, carry, p3, intr))
        self.input_bytes = sum(t.numel() * t.element_size() for t in _flat(self.inputs))
        pts = carry[2]
        self.trials, self.n, self.lanes = cfg.ransac_trials, pts.shape[-2], pts.dim() == 3
        scratch = torch.Generator(device=dev)
        scratch.manual_seed(0)
        rows = int(np.prod(pts.shape[:-2], dtype=np.int64)) * self.trials
        self.noise = [gumbel_noise(rows, self.n, scratch, dev).reshape(
            pts.shape[:-2] + (self.trials, self.n)) for _ in range(RANSAC_CALLS)]

        def body():
            drawn = DrawnNoise(self.noise)
            with fixed_trip_loops():
                out = _frame(*self.inputs, drawn, cfg, solver_cfg, solver_dtype, lean)
            if drawn.taken != RANSAC_CALLS:
                raise RuntimeError(f"the frame step made {drawn.taken} RANSAC calls, "
                                   f"not {RANSAC_CALLS}")
            return out

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = launches.read()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
            self.outputs = body()
        self.graph.instantiate()
        self.launches = launches.since(before)
        launches.set_counts(counts)
        pool = tuple(self.graph.pool())
        self.pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
                              if tuple(seg["segment_pool_id"]) == pool)
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def __call__(self, im, carry, p3, intr, generator):
        """Replay for one frame: (the next carry, what a segment stacks),
        both in the graph's own buffers, which the next replay overwrites;
        the inputs stay in ``inputs`` until then."""
        for buf, x in zip(_flat(self.inputs), _flat((im, carry, p3, intr))):
            if buf is not x:
                buf.copy_(x)
        dev = im.device
        for buf in self.noise:
            buf.copy_(draw_gumbel(generator, self.trials, self.n, dev, self.lanes))
        self.graph.replay()
        launches.add(self.launches)
        self.replays += 1
        return self.outputs


# The captured frame steps, least recently used first. Each holds its pool's
# device memory (hundreds of MiB to about 2 GiB at full width) until it is
# dropped: the oldest beyond STEP_GRAPHS_KEPT, or all by release_step_graphs().
STEP_GRAPHS_KEPT = 4
_GRAPHS: OrderedDict = OrderedDict()


def step_graphs() -> dict:
    """The captured steps kept now: {(device, input shapes and dtypes,
    tracker config, solver config, solver dtype, lean): ``_StepGraph``}."""
    return dict(_GRAPHS)


def release_step_graphs() -> None:
    """Drop every captured step, its graph and its pool's memory; the next
    segment on a card captures its step anew."""
    _GRAPHS.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _graph_step(im, carry, p3, intr, cfg, solver_cfg, solver_dtype, lean):
    """The captured step for these inputs' device, shapes and dtypes, the
    configurations and ``lean``; captured at its first use."""
    key = (str(im.device), tuple((tuple(t.shape), t.dtype) for t in _flat((im, carry, p3, intr))),
           cfg, solver_cfg, solver_dtype, lean)
    if key in _GRAPHS:
        _GRAPHS.move_to_end(key)
    else:
        while len(_GRAPHS) >= STEP_GRAPHS_KEPT:
            _GRAPHS.popitem(last=False)  # its memory returns at the capture's empty_cache
        _GRAPHS[key] = _StepGraph(im, carry, p3, intr, cfg, solver_cfg, solver_dtype, lean)
    return _GRAPHS[key]
