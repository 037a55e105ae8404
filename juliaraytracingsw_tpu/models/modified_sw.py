"""Modified shallow water: nonlinear pressure F(eta) = 3/2 - 1/(2 (1+eta)^2).

The pressure is removed from the linear operator (zero third column in the
momentum rows, reference rsw/ModifiedShallowWater.jl:260-289) and added to
the nonlinear term as -i k Cg^2 F_hat (rsw/ModifiedShallowWater.jl:209-224).
Height flux is unchanged: eta_t = -div((1+eta) u) linear part -div(u) in L.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.spectral import (irfft2, irfft2_dealiased, rfft2,
                             rfft2_dealiased)
from .base import Model
from .rsw import RSWParams

__all__ = ["make_model", "build_L_modified"]


def build_L_modified(grid, params: RSWParams, decouple_eta: bool = False):
    """RSW L with pressure column zeroed; with ``decouple_eta`` also zero the
    divergence row (QuadHeight variant, rsw/QuadHeightModifiedShallowWater.jl)."""
    kr = np.asarray(grid.kr, np.float64)[None, :]
    ell = np.asarray(grid.l, np.float64)[:, None]
    D = -params.nu * np.asarray(grid.Krsq, np.float64) ** params.nnu
    nl, nkr = D.shape
    L = np.zeros((3, 3, nl, nkr), np.complex128)
    L[0, 0] = D
    L[0, 1] = params.f
    L[1, 0] = -params.f
    L[1, 1] = D
    if not decouple_eta:
        L[2, 0] = -1j * kr * np.ones_like(ell)
        L[2, 1] = -1j * ell * np.ones_like(kr)
    L[2, 2] = D
    return L.astype(np.complex64)


def _modified_N(solh, grid, pressure_of_eta, flux_var: str):
    """Shared nonlinear RHS for Modified (prognostic eta) and QuadHeight
    (prognostic m) variants: advection + nonlinear pressure + flux."""
    uh, vh, hh = solh[0], solh[1], solh[2]
    ik, il = grid.ik, grid.il
    stack = jnp.stack([uh, vh, hh, ik * uh, il * uh, ik * vh, il * vh])
    # dealiasing rides the folded transforms
    phys = irfft2_dealiased(stack, grid)
    u, v, h, ux, uy, vx, vy = (phys[i] for i in range(7))

    F = pressure_of_eta(h)
    prods = jnp.stack([u * ux + v * uy, u * vx + v * vy, F, h * u, h * v])
    prodh = rfft2_dealiased(prods, grid)
    Nu = -prodh[0] - ik * prodh[2]
    Nv = -prodh[1] - il * prodh[2]
    Nh = -(ik * prodh[3] + il * prodh[4])
    return jnp.stack([Nu, Nv, Nh])


def make_model(grid, nu=1e-16, nnu=4, f=1.0, Cg=1.0, forcing=None) -> Model:
    params = RSWParams(nu=float(nu), nnu=int(nnu), f=float(f), Cg2=float(Cg) ** 2)
    L = build_L_modified(grid, params)
    Cg2 = params.Cg2

    def pressure(eta):
        # Cg^2 F with F = 3/2 - 1/(2 (1+eta)^2)  (ModifiedShallowWater.jl:219)
        return Cg2 * (1.5 - 0.5 / (1.0 + eta) ** 2)

    def calcN(solh, t):
        N = _modified_N(solh, grid, pressure, "eta")
        if forcing is not None:
            N = N + forcing(solh, t)
        return N

    return Model(
        name="modified_sw", grid=grid, params=params, L=L, calcN=calcN, nfields=3
    )
