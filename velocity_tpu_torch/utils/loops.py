"""The two forms of JAX's ``lax.while_loop`` in the frame step.

A loop of the step (the LK blocks of a level, the pose LM) stops early where
it runs eagerly: its condition is read on the host once per trip, and the
trips after the stop are skipped. A step that is being captured in a CUDA
graph may read nothing back, so there each loop runs its fixed trip count
(every LK block of a level, ``max_iters`` LM iterations), and a trip after
the stop changes nothing, as in JAX's ``while_loop`` under vmap. Both forms
give the same bits.

``fixed_trips()`` says which form a loop runs: the fixed one while the
current CUDA stream is being captured, or inside ``fixed_trip_loops()``,
which runs the captured form eagerly (the graph's warm-up, the checks that
hold a replay against the step it captured).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCAL = threading.local()


def fixed_trips() -> bool:
    """True where the step's loops run their fixed trip count."""
    return getattr(_LOCAL, "fixed", False) or (
        torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def fixed_trip_loops():
    """The step's loops run their fixed trip count while this lasts (this
    thread only)."""
    was = getattr(_LOCAL, "fixed", False)
    _LOCAL.fixed = True
    try:
        yield
    finally:
        _LOCAL.fixed = was
