"""Rolling multi-file HDF5 outputs.

Equivalent of the reference's SequencedOutputs / Collated
(utils/SequencedOutputs.jl, utils/Collated.jl): after ``max_writes`` frames
a file is closed and ``<base>.%06d.h5`` with the next index is opened. The
group layout mirrors the reference's JLD2 files so the analysis layer reads
either format:

    snapshots/<name>/<step>     field snapshots
    p/{t,x,k,u,g}/<step>        packet telemetry
    grid/..., params/..., clock/...  from save_problem

Data lands on host via one jax.device_get per frame (the device->disk
boundary, same place the reference calls ``Array(...)``).
"""
from __future__ import annotations

import os
from typing import Callable

import numpy as np

__all__ = ["SequencedWriter", "SequencedReader", "save_problem"]


def _h5py():
    """h5py, imported only where a file is written or read (an optional
    dependency: the simulation itself runs without it)."""
    import h5py

    return h5py


class SequencedWriter:
    def __init__(self, base: str, max_writes: int = 300):
        parent = os.path.dirname(base)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.base = base
        self.max_writes = int(max_writes)
        self.idx = 0
        self.count = 0
        self._file = None

    def _path(self, idx: int) -> str:
        return f"{self.base}.{idx:06d}.h5"

    @property
    def file(self):
        if self._file is None:
            self._file = _h5py().File(self._path(self.idx), "w")
        return self._file

    def _maybe_roll(self):
        if self.count >= self.max_writes:
            self.close()
            self.idx += 1
            self.count = 0

    def write(self, key: str, value):
        """Write one dataset (no frame accounting)."""
        f = self.file
        if key in f:
            del f[key]
        f[key] = np.asarray(value)

    def write_frame(self, step: int, **groups):
        """Write one output frame: write_frame(12, sol=..., t=...) stores
        snapshots/sol/12 etc. Rolls files every max_writes frames."""
        self._maybe_roll()
        f = self.file
        for name, value in groups.items():
            f[f"snapshots/{name}/{step}"] = np.asarray(value)
        self.count += 1

    def write_packets(self, step: int, t, x=None, k=None, u=None, g=None):
        """Packet telemetry frame in the reference's p/ layout
        (raytracing/RaytracingDriver.jl:96-108)."""
        self._maybe_roll()
        f = self.file
        f[f"p/t/{step}"] = float(t)
        for name, val in (("x", x), ("k", k), ("u", u), ("g", g)):
            if val is not None:
                f[f"p/{name}/{step}"] = np.asarray(val)
        self.count += 1

    def flush(self):
        if self._file is not None:
            self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_problem(writer: SequencedWriter, grid, params, dt: float, extra: dict | None = None):
    """Grid/params header mirroring FourierFlows ``saveproblem``."""
    writer.write("grid/nx", grid.nx)
    writer.write("grid/ny", grid.ny)
    writer.write("grid/Lx", grid.Lx)
    writer.write("grid/Ly", grid.Ly)
    writer.write("clock/dt", dt)
    for name, val in vars(params).items() if hasattr(params, "__dict__") else []:
        writer.write(f"params/{name}", val)
    if hasattr(params, "__dataclass_fields__"):
        for name in params.__dataclass_fields__:
            writer.write(f"params/{name}", getattr(params, name))
    for key, val in (extra or {}).items():
        writer.write(key, val)


class SequencedReader:
    """Iterate frames across a rolling file sequence (the analysis-side
    counterpart, cf. analysis/Notebooks/AnalysisUtils.jl:24-78)."""

    def __init__(self, base: str):
        self.base = base
        self.paths = []
        idx = 0
        while os.path.exists(f"{base}.{idx:06d}.h5"):
            self.paths.append(f"{base}.{idx:06d}.h5")
            idx += 1
        if not self.paths and os.path.exists(base):
            self.paths = [base]

    def steps(self, group: str = "snapshots/sol"):
        out = []
        for p in self.paths:
            with _h5py().File(p, "r") as f:
                if group in f:
                    out.extend(int(s) for s in f[group].keys())
        return sorted(out)

    def map(self, fn: Callable, group: str = "snapshots/sol"):
        """Apply fn(step, array) over every frame of every file in order."""
        results = []
        for p in self.paths:
            with _h5py().File(p, "r") as f:
                if group not in f:
                    continue
                for s in sorted(f[group].keys(), key=int):
                    results.append(fn(int(s), f[f"{group}/{s}"][()]))
        return results

    def read(self, key: str):
        for p in self.paths:
            with _h5py().File(p, "r") as f:
                if key in f:
                    return f[key][()]
        raise KeyError(key)

    # -- AnalysisUtils-parity helpers ------------------------------------
    # (analysis/Notebooks/AnalysisUtils.jl:24-78 count/load/map,
    #  :189-285 mapreduce/mapfilter + param readers)

    def count(self, group: str = "snapshots/sol") -> int:
        """Number of frames across the whole file sequence (:24-40)."""
        return len(self.steps(group))

    def load(self, step: int, group: str = "snapshots/sol"):
        """Load one frame by step, searching the file sequence (:42-60)."""
        key = f"{group}/{step}"
        return self.read(key)

    def mapreduce(self, fn: Callable, reducer: Callable, init,
                  group: str = "snapshots/sol"):
        """Streaming reduce over frames without materialising every result
        (:189-230): acc = reducer(acc, fn(step, array))."""
        acc = init
        for p in self.paths:
            with _h5py().File(p, "r") as f:
                if group not in f:
                    continue
                for s in sorted(f[group].keys(), key=int):
                    acc = reducer(acc, fn(int(s), f[f"{group}/{s}"][()]))
        return acc

    def mapfilter(self, fn: Callable, pred: Callable,
                  group: str = "snapshots/sol"):
        """Apply fn only to frames whose step passes pred (:232-260)."""
        results = []
        for p in self.paths:
            with _h5py().File(p, "r") as f:
                if group not in f:
                    continue
                for s in sorted(f[group].keys(), key=int):
                    if pred(int(s)):
                        results.append(fn(int(s), f[f"{group}/{s}"][()]))
        return results

    def params(self) -> dict:
        """All scalar run metadata under grid/, params/, clock/ (:262-285)."""
        out = {}
        for p in self.paths:
            with _h5py().File(p, "r") as f:
                for top in ("grid", "params", "clock"):
                    if top in f:
                        for name, ds in f[top].items():
                            out.setdefault(f"{top}/{name}", ds[()])
        return out

    def packet_times(self):
        """Sorted (step, t) pairs of packet frames across the sequence."""
        pairs = []
        for p in self.paths:
            with _h5py().File(p, "r") as f:
                if "p/t" in f:
                    for s, ds in f["p/t"].items():
                        pairs.append((int(s), float(ds[()])))
        return sorted(pairs)

    def final_packet_frame(self):
        """Stitch the last packet frame across the file sequence
        (analysis/load_file.jl:131-148): the highest step may live in the
        final file while earlier files hold the history — return
        (step, {x,k,u,g}) from the globally-latest packet write."""
        best_step, best = -1, None
        for p in self.paths:
            with _h5py().File(p, "r") as f:
                if "p/x" not in f:
                    continue
                s = max(int(k) for k in f["p/x"].keys())
                if s > best_step:
                    best_step = s
                    best = {name: f[f"p/{name}/{s}"][()]
                            for name in ("t", "x", "k", "u", "g")
                            if f"p/{name}/{s}" in f}
        return best_step, best
