"""f-plane rotating shallow water in velocity/height variables.

Physics (reference rsw/RotatingShallowWater.jl): state (u, v, eta) with

    u_t   =  f v - Cg^2 eta_x - (u u_x + v u_y) - nu (-del^2)^{n} u
    v_t   = -f u - Cg^2 eta_y - (u v_x + v v_y) - nu (-del^2)^{n} v
    eta_t = -(u_x + v_y) - ((eta u)_x + (eta v)_y) - nu (-del^2)^{n} eta

The full linear part (Coriolis + pressure + divergence + hyperviscosity) is
a non-diagonal per-mode 3x3 operator handled by the matrix-exponential
IFMAB3 stepper (rsw/RotatingShallowWater.jl:242-307 builds L with a CUDA
kernel; here it is a vectorised numpy construction, exponentiated once on
host — core/steppers.expm_tables).

State: (3, nl, nkr) complex spectral stack [uh, vh, etah].
Design: all inverse transforms of the RHS are fused into ONE batched
irfft2 of 7 fields and ONE batched rfft2 of 4 products (the reference does
10 sequential cuFFT round-trips with two scratch fields,
rsw/RotatingShallowWater.jl:140-230).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.grid import Grid
from ..core.spectral import (irfft2, irfft2_dealiased, parseval_sum2, rfft2,
                             rfft2_dealiased)
from .base import Model

__all__ = [
    "RSWParams", "make_model", "build_L", "updatevars", "set_solution",
    "kinetic_energy", "potential_energy", "total_energy",
]


@dataclass(frozen=True)
class RSWParams:
    nu: float
    nnu: int
    f: float
    Cg2: float

    @property
    def Cg(self) -> float:
        return float(np.sqrt(self.Cg2))


def build_L(grid: Grid, params: RSWParams) -> jax.Array:
    """Blockwise linear operator, shape (3, 3, nl, nkr), complex64.

    Rows/cols ordered (u, v, eta); matches rsw/RotatingShallowWater.jl:242-274:
        [ D    f    -ik Cg^2 ]
        [-f    D    -il Cg^2 ]
        [-ik  -il    D       ]
    with D = -nu * K^{2 nnu} on the diagonal.
    """
    kr = np.asarray(grid.kr, np.float64)[None, :]
    ell = np.asarray(grid.l, np.float64)[:, None]
    Krsq = np.asarray(grid.Krsq, np.float64)
    D = -params.nu * Krsq ** params.nnu
    nl, nkr = D.shape
    L = np.zeros((3, 3, nl, nkr), np.complex128)
    L[0, 0] = D
    L[0, 1] = params.f
    L[0, 2] = -1j * kr * params.Cg2
    L[1, 0] = -params.f
    L[1, 1] = D
    L[1, 2] = -1j * ell * params.Cg2
    L[2, 0] = -1j * kr * np.ones_like(ell)
    L[2, 1] = -1j * ell * np.ones_like(kr)
    L[2, 2] = D
    # host numpy: embeds as a jit constant without complex h2d transfers
    return L.astype(np.complex64)


def _advection_N(solh, grid: Grid, rotational_only: bool = False):
    """Shared nonlinear RHS for RSW and the Linborg variant.

    Returns N = [-(u u_x + v u_y), -(u v_x + v v_y), -div(eta u)] in spectral
    space. With ``rotational_only`` the *advecting* velocity is replaced by
    its rotational (divergence-free) part (Linborg variant,
    rsw/LinborgShallowWater.jl:155-237).

    Dealiasing rides the folded transforms: the masked irfft2/rfft2 pair
    applies the 2/3 truncation as part of the transform itself — on the
    dense-DFT backend the masked modes are never computed
    (core/spectral.rfft2_dealiased), elsewhere the mask multiply is
    explicit. The output needs no further dealias: every post-transform op
    here is an elementwise multiply, which commutes with the mask."""
    uh, vh, etah = solh[0], solh[1], solh[2]
    ik, il = grid.ik, grid.il

    fields = [uh, vh, etah, ik * uh, il * uh, ik * vh, il * vh]
    if rotational_only:
        # zeta = v_x - u_y; psi_rot = -zeta/K^2; (ur, vr) = (-psi_y, psi_x)
        zetah = ik * vh - il * uh
        psirh = -zetah * grid.invKrsq
        fields += [-il * psirh, ik * psirh]
    stack = jnp.stack(fields)
    phys = irfft2_dealiased(stack, grid)
    u, v, eta, ux, uy, vx, vy = phys[0], phys[1], phys[2], phys[3], phys[4], phys[5], phys[6]
    ua, va = (phys[7], phys[8]) if rotational_only else (u, v)

    prods = jnp.stack([ua * ux + va * uy, ua * vx + va * vy, eta * u, eta * v])
    prodh = rfft2_dealiased(prods, grid)
    Nu = -prodh[0]
    Nv = -prodh[1]
    Neta = -(ik * prodh[2] + il * prodh[3])
    # the state stays in the truncated subspace (the reference
    # dealias!-mutates sol in place, RotatingShallowWater.jl:141)
    return jnp.stack([Nu, Nv, Neta])


def make_model(
    grid: Grid,
    nu: float = 1e-16,
    nnu: int = 4,
    f: float = 1.0,
    Cg: float = 1.0,
    forcing=None,
) -> Model:
    """``forcing(sol, t) -> Fh`` is an optional additive spectral forcing
    (reference ``addforcing!``, rsw/RotatingShallowWater.jl:232-240)."""
    params = RSWParams(nu=float(nu), nnu=int(nnu), f=float(f), Cg2=float(Cg) ** 2)
    L = build_L(grid, params)

    def calcN(solh, t):
        N = _advection_N(solh, grid)
        if forcing is not None:
            N = N + forcing(solh, t)
        return N

    return Model(name="rsw", grid=grid, params=params, L=L, calcN=calcN, nfields=3)


# --- variables / diagnostics -------------------------------------------------

def updatevars(solh, grid: Grid, params: RSWParams):
    """Physical (u, v, eta, zeta_lin) from the spectral state; the reference's
    ``updatevars!`` computes linearised PV zeta = v_x - u_y - f eta
    (rsw/RotatingShallowWater.jl:101-116)."""
    solh = grid.dealias(solh)
    uh, vh, etah = solh[0], solh[1], solh[2]
    zetah = grid.ik * vh - grid.il * uh - params.f * etah
    phys = irfft2(jnp.stack([uh, vh, etah, zetah]), grid.nx)
    return phys[0], phys[1], phys[2], phys[3]


def set_solution(u0h, v0h, eta0h):
    return jnp.stack([u0h, v0h, eta0h])


def kinetic_energy(solh, grid: Grid):
    """(1/2) <u^2 + v^2> / area (rsw/RotatingShallowWater.jl:323-327)."""
    return (
        parseval_sum2(solh[0], grid) + parseval_sum2(solh[1], grid)
    ) / (2.0 * grid.Lx * grid.Ly)


def potential_energy(solh, grid: Grid, params: RSWParams):
    """(Cg^2/2) <eta^2> / area (rsw/RotatingShallowWater.jl:329-331)."""
    return 0.5 * params.Cg2 * parseval_sum2(solh[2], grid) / (grid.Lx * grid.Ly)


def total_energy(solh, grid: Grid, params: RSWParams):
    return kinetic_energy(solh, grid) + potential_energy(solh, grid, params)
