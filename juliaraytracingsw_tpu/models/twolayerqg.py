"""Equal-depth two-layer quasi-geostrophic model with background shear.

Reference swqg/TwoLayerQG.jl: layers move with background velocities +/-U,
bottom drag mu acts on layer 2, stretching parameter
F = 2 f0^2 / (Cg^2 * (drho/rho0)). State qh has shape (2, nl, nkr).

Per-mode PV <-> streamfunction inversion (S with q = del^2 psi -+ F (psi1 - psi2)):

    S      = [[-K^2 - F,  F], [F, -K^2 - F]]
    S^{-1} = [[-K^2 - F, -F], [-F, -K^2 - F]] / (K^2 (K^2 + 2F))

The non-diagonal linear operator combines mean-flow advection -+ i k U q_j,
PV-gradient terms -+ 2 i k F U psi_j, drag mu K^2 psi_2 and hyperviscosity
(reference builds it in a KernelAbstractions kernel, swqg/TwoLayerQG.jl:184-206;
here a host-side float64 construction consumed by the matrix-exponential
IF-AB3 stepper).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spectral import (irfft2, irfft2_dealiased, parseval_sum,
                             rfft2, rfft2_dealiased)
from .base import Model

__all__ = [
    "TwoLayerParams", "make_model", "build_L",
    "streamfunction_from_pv", "pv_from_streamfunction",
    "kinetic_energy", "potential_energy",
]


@dataclass(frozen=True)
class TwoLayerParams:
    U: float      # background shear: layer1 +U, layer2 -U
    mu: float     # bottom drag on layer 2
    nu: float
    nnu: int
    F: float      # 2 f0^2 / (Cg^2 drho/rho0)


def pv_from_streamfunction(psih, grid, params: TwoLayerParams):
    """(2, nl, nkr): q_j = -K^2 psi_j + F (psi_other - psi_j)
    (swqg/TwoLayerQG.jl:92-99)."""
    F = params.F
    q1 = -grid.Krsq * psih[0] + F * (psih[1] - psih[0])
    q2 = -grid.Krsq * psih[1] + F * (psih[0] - psih[1])
    return jnp.stack([q1, q2])


def streamfunction_from_pv(qh, grid, params: TwoLayerParams):
    """Inverse stretching (swqg/TwoLayerQG.jl:101-111); zero at the mean mode."""
    F = params.F
    qsum = qh[0] + qh[1]
    p1 = -(grid.Krsq * qh[0] + F * qsum)
    p2 = -(grid.Krsq * qh[1] + F * qsum)
    scale = grid.invKrsq / (grid.Krsq + 2.0 * F)
    return jnp.stack([p1, p2]) * scale


def build_L(grid, params: TwoLayerParams):
    """(2, 2, nl, nkr) complex block operator (swqg/TwoLayerQG.jl:184-206)."""
    kr = np.asarray(grid.kr, np.float64)[None, :]
    K2 = np.asarray(grid.Krsq, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        K2inv = np.where(K2 > 0, 1.0 / np.where(K2 > 0, K2, 1.0), 0.0)
    F, U, mu = params.F, params.U, params.mu
    D = -params.nu * K2 ** params.nnu

    # S^{-1} rows scaled by the per-layer psi coefficients:
    # layer 1: -2ikFU * psi1 ; layer 2: (+2ikFU + mu K^2) * psi2
    denom = K2inv / (K2 + 2.0 * F)
    Sinv00 = (-K2 - F) * denom
    Sinv01 = -F * denom
    c1 = -2j * kr * F * U * np.ones_like(K2)
    c2 = (2j * kr * F * U + mu * K2)

    nl, nkr = K2.shape
    L = np.zeros((2, 2, nl, nkr), np.complex128)
    L[0, 0] = c1 * Sinv00 + (-1j * kr * U) + D
    L[0, 1] = c1 * Sinv01
    L[1, 0] = c2 * Sinv01
    L[1, 1] = c2 * Sinv00 + (1j * kr * U) + D
    return L.astype(np.complex64)


def make_model(
    grid,
    U: float = 0.5,
    mu: float = 1e-2,
    nu: float = 1e-6,
    nnu: int = 4,
    f0: float = 3.0,
    Cg: float = 1.0,
    drho_rho0: float = 0.2,
) -> Model:
    params = TwoLayerParams(
        U=float(U), mu=float(mu), nu=float(nu), nnu=int(nnu),
        F=float(2.0 * f0**2 / Cg**2 / drho_rho0),
    )
    L = build_L(grid, params)

    def calcN(solh, t):
        """Per-layer q_t = -J(psi_j, q_j), conservative form, batched FFTs
        (swqg/TwoLayerQG.jl:152-182)."""
        qh = solh
        psih = streamfunction_from_pv(qh, grid, params)
        ik, il = grid.ik, grid.il
        stack = jnp.concatenate([qh, ik * psih, il * psih])  # (6, nl, nkr)
        # dealiasing rides the folded transforms
        # (core/spectral.rfft2_dealiased): masked modes are never computed
        # on the dense-DFT backend; output ops are elementwise so no further
        # dealias is needed
        phys = irfft2_dealiased(stack, grid)
        q, psix, psiy = phys[0:2], phys[2:4], phys[4:6]
        prodh = rfft2_dealiased(jnp.concatenate([psix * q, psiy * q]),
                                grid)
        return -il * prodh[0:2] + ik * prodh[2:4]

    return Model(
        name="twolayerqg", grid=grid, params=params, L=L, calcN=calcN, nfields=2
    )


# --- energetics (swqg/TwoLayerQG.jl:230-253) ---------------------------------

def kinetic_energy(qh, grid, params: TwoLayerParams):
    psih = streamfunction_from_pv(qh, grid, params)
    integrand = grid.Krsq * jnp.abs(psih) ** 2
    ke = parseval_sum(integrand.astype(jnp.complex64), grid) / (grid.Lx * grid.Ly)
    return ke[0], ke[1]


def potential_energy(qh, grid, params: TwoLayerParams):
    psih = streamfunction_from_pv(qh, grid, params)
    diff = jnp.abs(psih[0] - psih[1]) ** 2
    return (
        params.F
        * parseval_sum(diff.astype(jnp.complex64), grid)
        / (2.0 * grid.Lx * grid.Ly)
    )
