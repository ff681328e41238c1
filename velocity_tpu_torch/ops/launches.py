"""The hand kernels' launch counters, read, set and added as one.

Each kernel's wrapper (K1 ``lk_block_pallas.lk_block``, K2
``slab_pallas.extract_slabs``, K3 ``patch_pallas.extract_patches``, K4
``harris.corner_subpix``, K5 ``lk_lanes.extract_warped``, K6
``lk_lanes.source_window``) adds one to its ``launches`` and to
``launches_by_shape[shape]`` where it launches its kernel, and nowhere
else. A CUDA graph launches its kernels through the
wrappers only while it is captured: ``pipeline/step_graph.py`` sets the counters
back after a capture and adds the capture's counts at each replay.

Counts are {kernel name: (launches, {shape: launches})}.
"""

from __future__ import annotations


def counters() -> dict:
    """{kernel name: its wrapper, which carries the counters}."""
    from velocity_tpu_torch.ops.harris import corner_subpix
    from velocity_tpu_torch.ops.lk_block_pallas import lk_block
    from velocity_tpu_torch.ops.lk_lanes import extract_warped, source_window
    from velocity_tpu_torch.ops.patch_pallas import extract_patches
    from velocity_tpu_torch.ops.slab_pallas import extract_slabs

    return {"lk_block": lk_block, "extract_slabs": extract_slabs,
            "extract_patches": extract_patches, "corner_subpix": corner_subpix,
            "extract_warped": extract_warped, "source_window": source_window}


def read() -> dict:
    """The counts now."""
    return {name: (fn.launches, dict(fn.launches_by_shape))
            for name, fn in counters().items()}


def set_counts(counts: dict | None = None) -> None:
    """Set every counter to ``counts`` (None: zero)."""
    for name, fn in counters().items():
        n, by_shape = counts[name] if counts is not None else (0, {})
        fn.launches = n
        fn.launches_by_shape.clear()
        fn.launches_by_shape.update(by_shape)


def add(counts: dict) -> None:
    """Add ``counts`` to the counters."""
    for name, fn in counters().items():
        n, by_shape = counts[name]
        fn.launches += n
        for key, m in by_shape.items():
            fn.launches_by_shape[key] = fn.launches_by_shape.get(key, 0) + m


def since(before: dict) -> dict:
    """The counts made since ``read()`` gave ``before``."""
    out = {}
    for name, (n, by_shape) in read().items():
        n0, by0 = before[name]
        out[name] = (n - n0, {k: m - by0.get(k, 0) for k, m in by_shape.items()
                              if m > by0.get(k, 0)})
    return out
