"""Spectrally-exact ray tracing via NUFFT field evaluation.

Equivalent of the reference raytracing/NUFFTRaytracing.jl (which evaluates
velocity/gradient spectra at packet positions with type-2 NUFFT and was
partially bit-rotted — SURVEY.md §2.3): here the evaluation is the exact
dense contraction of analysis/nufft.py (two matmuls per stage), linear
time blending between spectral snapshots, fixed-substep RK4/midpoint.

Use when interpolation error must be zero (verification oracles for the
gridded interpolation paths) — cost is O(modes x packets) per stage.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..analysis.nufft import nufft2d2
from ..core.spectral import spectral_gradients
from .dispersion import group_velocity
from .packets import Packets
from .raytrace import RayParams

__all__ = ["spectra_from_psih", "nufft_raytrace"]


def spectra_from_psih(psih, grid):
    """(5, nl, nkr) [uh, vh, uxh, uyh, vxh] spectral stack."""
    return jnp.stack(spectral_gradients(psih, grid))


def _rhs(p: Packets, spec, grid, rp: RayParams):
    vals = nufft2d2(spec, p.x, p.y, grid)   # (5, N)
    u, v, ux, uy, vx = vals[0], vals[1], vals[2], vals[3], vals[4]
    cgx, cgy = group_velocity(p.k, p.l, rp.f, rp.Cg, p.sign)
    return Packets(
        u + cgx, v + cgy,
        -(ux * p.k + vx * p.l),
        -(uy * p.k - ux * p.l),
        jnp.zeros_like(p.sign),
    )


@partial(jax.jit, static_argnames=("nsubsteps", "rp"))
def nufft_raytrace(packets: Packets, spec_old, spec_new, t0, t1, grid,
                   rp: RayParams, nsubsteps: int = 1) -> Packets:
    """RK4 substeps with per-stage spectral blending (exact interpolation)."""
    h = (t1 - t0) / nsubsteps
    da = 1.0 / nsubsteps

    def blend(a):
        return (1.0 - a) * spec_old + a * spec_new

    def axpy(p, d, s):
        return Packets(p.x + s * d.x, p.y + s * d.y, p.k + s * d.k,
                       p.l + s * d.l, p.sign)

    def body(p, i):
        a0 = i * da
        F0, Fh, F1 = blend(a0), blend(a0 + 0.5 * da), blend(a0 + da)
        k1 = _rhs(p, F0, grid, rp)
        k2 = _rhs(axpy(p, k1, 0.5 * h), Fh, grid, rp)
        k3 = _rhs(axpy(p, k2, 0.5 * h), Fh, grid, rp)
        k4 = _rhs(axpy(p, k3, h), F1, grid, rp)
        new = Packets(
            p.x + h / 6 * (k1.x + 2 * k2.x + 2 * k3.x + k4.x),
            p.y + h / 6 * (k1.y + 2 * k2.y + 2 * k3.y + k4.y),
            p.k + h / 6 * (k1.k + 2 * k2.k + 2 * k3.k + k4.k),
            p.l + h / 6 * (k1.l + 2 * k2.l + 2 * k3.l + k4.l),
            p.sign,
        )
        return new, None

    out, _ = jax.lax.scan(body, packets,
                          jnp.arange(nsubsteps, dtype=jnp.float32))
    return out
