"""The hero deployment: 512^2 rotating shallow water + a 1M-packet ensemble.

This is the README quick-start configuration (the reference's 512^2 RSW +
packets runs, rsw/RSWRaytracingParameters.jl, at this repository's hero
ensemble size): RSW on a 2*pi-periodic ``nx^2`` grid, IF-AB3, ``f = 3``,
``Cg = 1``, ``dt = 1e-3``, fourth-order hyperviscosity from ``derive_nu``,
a band-limited geostrophic + wave initial condition from a seed, and
``lattice_packets(sqrt_packets, ...)`` on the |k| = sqrt(3) f / Cg ring.
``chip_smoke.py``, ``bench.py`` and ``benchmarks/fused_vs_plain.py`` build
their runs from it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

__all__ = ["Hero", "F", "CG", "DT", "make_hero", "rsw_psih_fn"]

F, CG, DT = 3.0, 1.0, 1e-3


class Hero(NamedTuple):
    grid: object
    model: object
    psih_fn: Callable
    rp: object          # RayParams
    sol0: object        # (3, nl, nkr) complex64 spectral state
    packets: object     # Packets
    k0: float


def rsw_psih_fn(grid, params):
    """Balanced streamfunction of an RSW state (the field that advects the
    packets): psi_h = -q_h / (K^2 + f^2 / Cg^2)."""
    def psih_fn(sol):
        qh = grid.ik * sol[1] - grid.il * sol[0] - params.f * sol[2]
        return -qh / (grid.Krsq + params.f ** 2 / params.Cg2)

    return psih_fn


def make_hero(nx: int = 512, sqrt_packets: int = 1024,
              interp: str = "bilinear", table_dtype: str = "float32",
              gather: str = "auto", seed: int = 1234) -> Hero:
    """Build the hero configuration; ``gather='auto'`` is resolved against
    the ensemble size (patch at 512^2 + 1M packets)."""
    from ..core.grid import make_grid
    from ..models import rsw
    from ..rays.packets import lattice_packets
    from ..rays.raytrace import RayParams, resolve_gather
    from .driver import derive_nu
    from .initial_conditions import band_geo_wave_ic

    grid = make_grid(nx)
    model = rsw.make_model(grid, nu=derive_nu(1.0, nx, 4, DT), nnu=4, f=F,
                           Cg=CG)
    sol0 = band_geo_wave_ic(grid, np.random.default_rng(seed), Kg=(10, 13),
                            Kw=(0, 5), ag=0.5, aw=0.05, f=F, Cg=CG)
    k0 = float(np.sqrt(3.0) * F / CG)
    packets = lattice_packets(sqrt_packets, grid.Lx, grid.Ly, k0=k0,
                              k_ring=True)
    rp = RayParams(f=F, Cg=CG, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=interp,
                   table_dtype=table_dtype, gather=gather)
    rp = resolve_gather(rp, packets.n, grid.ny, grid.nx)
    return Hero(grid, model, rsw_psih_fn(grid, model.params), rp, sol0,
                packets, k0)
