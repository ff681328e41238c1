"""String helpers (reference utils/strings.py parity); a copy of
``velocity_tpu/utils/strings.py``."""

from __future__ import annotations


def filename_split(path: str):
    """(dir, stem, extension, name) of a path string."""
    i = path.rfind("/") + 1
    j = path.rfind(".")
    if j < i:
        j = len(path)
    return path[:i], path[i:j], path[j:], path[i:]


def print_dict(d: dict) -> None:
    for k, v in d.items():
        print(f"{str(k):>40s}: {v}")
