"""One-layer equivalent-barotropic shallow-water QG model.

Physics (reference swqg/SWQG.jl): prognostic PV q = (del^2 - Kd^2) psi,

    q_t = -J(psi, q) - nu (-del^2)^{n_nu} q

with the Jacobian in conservative form J(f,g) = (f_x g)_y - (f_y g)_x
(swqg/SWQG.jl:152) and a *diagonal* hyperviscous linear operator, so the
IFMAB3 stepper reduces to scalar integrating factors (swqg/SWQG.jl:93).

State: single complex spectral field ``qh`` of shape (nl, nkr).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..core.grid import Grid
from ..core.spectral import (irfft2, irfft2_dealiased, parseval_sum,
                             parseval_sum2, rfft2, rfft2_dealiased)
from .base import Model

__all__ = ["SWQGParams", "make_model", "streamfunction_from_pv",
           "pv_from_streamfunction", "kinetic_energy", "potential_energy",
           "enstrophy", "energy"]


@dataclass(frozen=True)
class SWQGParams:
    nu: float        # hyperviscosity coefficient
    nnu: int         # hyperviscosity order
    Kd2: float       # squared deformation wavenumber (= f^2/Cg^2)


def pv_from_streamfunction(psih, grid: Grid, params: SWQGParams):
    """qh = -(K^2 + Kd^2) psih (swqg/SWQG.jl:101-103)."""
    return -(grid.Krsq + params.Kd2) * psih


def streamfunction_from_pv(qh, grid: Grid, params: SWQGParams):
    """psih = -qh / (K^2 + Kd^2) (swqg/SWQG.jl:105-107)."""
    return -qh / (grid.Krsq + params.Kd2)


def make_model(
    grid: Grid,
    nu: float = 1e-16,
    nnu: int = 4,
    f: float = 1.0,
    Cg: float = 1.0,
) -> Model:
    params = SWQGParams(nu=float(nu), nnu=int(nnu), Kd2=float(f) ** 2 / float(Cg) ** 2)
    D = -params.nu * grid.Krsq ** params.nnu  # (nl, nkr) real diagonal

    def calcN(solh, t):
        """q_t nonlinear term: -J(psi, q) = -(psi_x q)_y + (psi_y q)_x."""
        qh = solh
        psih = streamfunction_from_pv(qh, grid, params)
        ik, il = grid.ik, grid.il
        # one batched inverse FFT: q, psi_x, psi_y
        stack = jnp.stack([qh, ik * psih, il * psih])
        # dealiasing rides the folded transforms
        # (core/spectral.rfft2_dealiased): masked modes are never computed
        # on the dense-DFT backend; output ops are elementwise so no further
        # dealias is needed
        q, psix, psiy = irfft2_dealiased(stack, grid)
        prods = jnp.stack([psix * q, psiy * q])
        prodh = rfft2_dealiased(prods, grid)
        # dealias the output too: the reference mutates sol in place
        # (dealias!(sol, grid), swqg/SWQG.jl:141) so the *state* stays in the
        # truncated subspace; in our pure-functional step the equivalent is
        # keeping N truncated (state stays truncated by induction).
        return -il * prodh[0] + ik * prodh[1]

    return Model(
        name="swqg", grid=grid, params=params, L=D, calcN=calcN, nfields=1
    )


# --- energetics (swqg/SWQG.jl:205-250) --------------------------------------

def kinetic_energy(qh, grid: Grid, params: SWQGParams):
    psih = streamfunction_from_pv(qh, grid, params)
    grad_mag = jnp.sqrt(grid.Krsq) * psih
    return parseval_sum2(grad_mag, grid) / (2.0 * grid.Lx * grid.Ly)


def potential_energy(qh, grid: Grid, params: SWQGParams):
    psih = streamfunction_from_pv(qh, grid, params)
    return params.Kd2 * parseval_sum2(psih, grid) / (2.0 * grid.Lx * grid.Ly)


def energy(qh, grid: Grid, params: SWQGParams):
    return kinetic_energy(qh, grid, params) + potential_energy(qh, grid, params)


def enstrophy(qh, grid: Grid, params: SWQGParams):
    return parseval_sum2(qh, grid) / (2.0 * grid.Lx * grid.Ly)


def energy_dissipation(qh, grid: Grid, params: SWQGParams):
    integrand = params.nu * grid.Krsq ** (params.nnu - 1) * jnp.abs(qh) ** 2
    return parseval_sum(integrand.astype(jnp.complex64), grid) / (grid.Lx * grid.Ly)


def enstrophy_dissipation(qh, grid: Grid, params: SWQGParams):
    integrand = params.nu * grid.Krsq ** params.nnu * jnp.abs(qh) ** 2
    return parseval_sum(integrand.astype(jnp.complex64), grid) / (grid.Lx * grid.Ly)
