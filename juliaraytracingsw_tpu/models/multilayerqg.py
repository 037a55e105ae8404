"""General n-layer quasi-geostrophic model.

Equivalent of the external GeophysicalFlows ``MultiLayerQG``
module the reference drivers build problems from (e.g.
raytracing/TwoLayerRaytracing.jl:174, simulation/TwoLayerSimulation.jl:37).

Physics: layer PVs q_j with background zonal flows U_j, beta, bottom drag mu:

    dq_j/dt + J(psi_j, q_j) + U_j dq_j/dx + Q_jy dpsi_j/dx
        = -delta_{jn} mu del^2 psi_n - nu (-del^2)^{n_nu} q_j

    q = (-K^2 I + A) psi  per mode, A the tridiagonal stretching coupling
    A[j,j+-1] = F_coupling, Q_y = beta - A U.

Layout: state (n, nl, nkr); the per-mode n x n stretching inverse and the
full non-diagonal L are precomputed on host in float64 and applied as
channel einsums (generalising swqg/TwoLayerQG.jl:184-206 to n layers).
Defaults reproduce the equal-depth two-layer configuration used throughout
the reference (U1 = -U2 = U, F = f0^2/(g' H) with equal layers).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spectral import (irfft2, irfft2_dealiased, parseval_sum,
                             rfft2, rfft2_dealiased)
from .base import Model

__all__ = ["MultiLayerParams", "make_model", "streamfunction_from_pv",
           "pv_from_streamfunction", "kinetic_energy", "potential_energy"]


@dataclass(frozen=True)
class MultiLayerParams:
    nlayers: int
    U: tuple            # per-layer background zonal velocity
    beta: float
    mu: float           # bottom drag
    nu: float
    nnu: int
    Fcoup: tuple        # interface coupling F_{j+1/2} per interface (len n-1)
    delta: tuple        # layer depth fractions H_j / H (len n)


def _stretching_matrix(params: MultiLayerParams):
    """A (n x n): q_j = -K^2 psi_j + (A psi)_j, built from interface couplings.

    With depth weighting: layer j couples to j+1 via F_{j+1/2}/delta_j etc.
    """
    n = params.nlayers
    A = np.zeros((n, n))
    for j in range(n - 1):
        Fj = params.Fcoup[j]
        A[j, j] -= Fj / params.delta[j]
        A[j, j + 1] += Fj / params.delta[j]
        A[j + 1, j + 1] -= Fj / params.delta[j + 1]
        A[j + 1, j] += Fj / params.delta[j + 1]
    return A


def _host_arrays(grid):
    kr = np.asarray(grid.kr, np.float64)[None, :]
    ell = np.asarray(grid.l, np.float64)[:, None]
    K2 = np.asarray(grid.Krsq, np.float64)
    return kr, ell, K2


def _sinv(grid, params: MultiLayerParams):
    """(n, n, nl, nkr) inverse of S = -K^2 I + A per mode; zero at K=0."""
    n = params.nlayers
    _, _, K2 = _host_arrays(grid)
    A = _stretching_matrix(params)
    S = -K2[..., None, None] * np.eye(n) + A  # (nl, nkr, n, n)
    S = S.copy()
    S[0, 0] = np.eye(n)  # placeholder to keep it invertible at K=0
    Sinv = np.linalg.inv(S)
    Sinv[0, 0] = 0.0
    return np.transpose(Sinv, (2, 3, 0, 1))  # (n, n, nl, nkr)


def build_L(grid, params: MultiLayerParams, Sinv=None):
    """(n, n, nl, nkr) complex linear operator (see module docstring)."""
    n = params.nlayers
    kr, _, K2 = _host_arrays(grid)
    if Sinv is None:
        Sinv = _sinv(grid, params)
    A = _stretching_matrix(params)
    U = np.asarray(params.U, np.float64)
    Qy = params.beta - A @ U      # (n,) per-layer background PV gradient
    D = -params.nu * K2 ** params.nnu

    L = np.zeros((n, n, *K2.shape), np.complex128)
    # psi-proportional coefficient per layer row: -ik Qy_j (PV gradient)
    # plus bottom drag mu K^2 on layer n
    coef = np.zeros((n, *K2.shape), np.complex128)
    for j in range(n):
        coef[j] = -1j * kr * Qy[j] * np.ones_like(K2)
    coef[n - 1] += params.mu * K2
    # L = coef_j * Sinv[j, :] + diag(-ik U_j + D)
    for j in range(n):
        for m in range(n):
            L[j, m] = coef[j] * Sinv[j, m]
        L[j, j] += -1j * kr * U[j] + D
    return L.astype(np.complex64)


def two_layer_defaults(
    nx=128, U=0.5, mu=1e-2, nu=1e-6, nnu=4, f0=3.0, Cg=1.0, drho_rho0=0.2
):
    """Coupling matching swqg/TwoLayerQG.jl's F = 2 f0^2/(Cg^2 drho/rho0)
    for equal layers (per-layer coupling F each)."""
    F = 2.0 * f0**2 / Cg**2 / drho_rho0
    return dict(U=(U, -U), beta=0.0, mu=mu, nu=nu, nnu=nnu,
                Fcoup=(F / 2.0,), delta=(0.5, 0.5))


def make_model(
    grid,
    U: Sequence[float] = (0.5, -0.5),
    beta: float = 0.0,
    mu: float = 1e-2,
    nu: float = 1e-6,
    nnu: int = 4,
    Fcoup: Sequence[float] = (9.0,),
    delta: Sequence[float] | None = None,
) -> Model:
    n = len(U)
    if delta is None:
        delta = tuple(1.0 / n for _ in range(n))
    params = MultiLayerParams(
        nlayers=n, U=tuple(float(u) for u in U), beta=float(beta),
        mu=float(mu), nu=float(nu), nnu=int(nnu),
        Fcoup=tuple(float(f) for f in Fcoup), delta=tuple(float(d) for d in delta),
    )
    Sinv = _sinv(grid, params)
    Sinv_j = Sinv.astype(np.complex64)
    L = build_L(grid, params, Sinv)

    def psi_from_q(qh):
        return jnp.einsum("ab...,b...->a...", Sinv_j, qh,
                          precision=jax.lax.Precision.HIGHEST)

    def calcN(solh, t):
        qh = solh
        psih = psi_from_q(qh)
        ik, il = grid.ik, grid.il
        stack = jnp.concatenate([qh, ik * psih, il * psih])  # (3n, nl, nkr)
        # dealiasing rides the folded transforms
        # (core/spectral.rfft2_dealiased): masked modes are never computed
        # on the dense-DFT backend; output ops are elementwise so no further
        # dealias is needed
        phys = irfft2_dealiased(stack, grid)
        q, psix, psiy = phys[0:n], phys[n:2 * n], phys[2 * n:3 * n]
        prodh = rfft2_dealiased(jnp.concatenate([psix * q, psiy * q]),
                                grid)
        return -il * prodh[0:n] + ik * prodh[n:2 * n]

    model = Model(
        name="multilayerqg", grid=grid, params=params, L=L, calcN=calcN,
        nfields=n, extras={"psi_from_q": psi_from_q},
    )
    return model


def streamfunction_from_pv(qh, grid, params: MultiLayerParams):
    # the inverse stretching matrix is REAL — keep it float32 so eager
    # calls only transfer real host data (promotion to complex happens on
    # device). precision=HIGHEST: at default precision an accelerator may
    # run these contractions with reduced-precision passes (TF32 on GPUs);
    # these tiny n x n channel contractions cost nothing at full precision.
    Sinv = _sinv(grid, params).astype(np.float32)
    return jnp.einsum("ab...,b...->a...", Sinv, qh,
                      precision=jax.lax.Precision.HIGHEST)


def pv_from_streamfunction(psih, grid, params: MultiLayerParams):
    A = _stretching_matrix(params).astype(np.float32)   # real, see above
    return -grid.Krsq * psih + jnp.einsum(
        "ab,b...->a...", A, psih, precision=jax.lax.Precision.HIGHEST)


def kinetic_energy(qh, grid, params: MultiLayerParams):
    """Per-layer depth-weighted KE (GeophysicalFlows convention)."""
    psih = streamfunction_from_pv(qh, grid, params)
    integrand = grid.Krsq * jnp.abs(psih) ** 2
    ke = parseval_sum(integrand.astype(jnp.complex64), grid) / (grid.Lx * grid.Ly)
    return tuple(
        0.5 * params.delta[j] * ke[j] for j in range(params.nlayers)
    )


def potential_energy(qh, grid, params: MultiLayerParams):
    """Per-interface APE ~ F/2 <(psi_j - psi_{j+1})^2> with depth weights."""
    psih = streamfunction_from_pv(qh, grid, params)
    out = []
    for j in range(params.nlayers - 1):
        diff = jnp.abs(psih[j] - psih[j + 1]) ** 2
        out.append(
            0.5 * params.Fcoup[j]
            * parseval_sum(diff.astype(jnp.complex64), grid)
            / (grid.Lx * grid.Ly)
        )
    return tuple(out)
