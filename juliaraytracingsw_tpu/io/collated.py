"""Collated rolling outputs keyed by entry count.

Equivalent of the reference's utils/Collated.jl: a rolling writer that
switches to ``name_%08d.h5`` after ``max_lines`` appended entries, plus a
reader that maps a function over every entry of every file in sequence
(Collated.jl:13-24, 74-93). Used for per-step packet rows
(raytracing/GPUTwoLayerRaytracing.jl:29-35 writes p/x/<step> collated).
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np

__all__ = ["CollatedWriter", "map_input"]


def _h5py():
    """h5py, imported only where a file is written or read (an optional
    dependency: the simulation itself runs without it)."""
    import h5py

    return h5py


class CollatedWriter:
    def __init__(self, base: str, max_lines: int = 1000):
        parent = os.path.dirname(base)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.base = base
        self.max_lines = int(max_lines)
        self.idx = 0
        self.lines = 0
        self._file = None

    def _path(self, idx):
        return f"{self.base}_{idx:08d}.h5"

    @property
    def file(self):
        if self._file is None:
            self._file = _h5py().File(self._path(self.idx), "w")
        return self._file

    def append(self, key: str, value):
        """Append one entry; rolls to the next file after max_lines."""
        if self.lines >= self.max_lines:
            self.close()
            self.idx += 1
            self.lines = 0
        self.file[key] = np.asarray(value)
        self.lines += 1

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def map_input(base: str, fn: Callable[[str, np.ndarray], object]):
    """Apply ``fn(key, value)`` to every entry of every file in the sequence
    (Collated.jl map_input, :74-93). Returns the list of results."""
    out = []
    idx = 0
    while True:
        path = f"{base}_{idx:08d}.h5"
        if not os.path.exists(path):
            break
        with _h5py().File(path, "r") as f:
            def visit(name, obj):
                if isinstance(obj, _h5py().Dataset):
                    out.append(fn(name, obj[()]))
            f.visititems(visit)
        idx += 1
    return out
