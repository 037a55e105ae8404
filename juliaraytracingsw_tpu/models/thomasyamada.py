"""Thomas-Yamada coupled barotropic / baroclinic model.

Reference thomasyamada/ThomasYamada.jl: nondimensional state
(zeta_t, u_c, v_c, p_c) — barotropic vorticity + baroclinic velocity and
pressure, shape (4, nl, nkr). Linear wave terms are kept in N (not L):

    d zeta_t /dt = -Ro [ div(u_t zeta_t) + (l^2-k^2)(uc vc)^ + k l ((uc^2)^-(vc^2)^) ]
    d u_c /dt    =  v_c - i k p_c - Ro [ i k (ut uc)^ + (vt uc_y)^ + (vc ut_y)^ ]
    d v_c /dt    = -u_c - i l p_c - Ro [ i l (vt vc)^ + (ut vc_x)^ + (uc vt_x)^ ]
    d p_c /dt    = -i k u_c - i l v_c - Ro [ (ut pc_x)^ + (vt pc_y)^ ]

Diagonal hyperviscous L on all four components; default stepper ETDRK4
(reference :55-74). The linear eigenbasis (omega = sqrt(1 + K^2)) and the
wave/geostrophic decomposition of the baroclinic components follow
thomasyamada/TYUtils.jl.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spectral import (irfft2, irfft2_dealiased, parseval_sum2,
                             rfft2, rfft2_dealiased)
from .base import Model

__all__ = [
    "TYParams", "make_model", "ty_bases", "decompose_balanced_wave",
    "barotropic_energy", "baroclinic_energy", "wave_geostrophic_energy",
]


@dataclass(frozen=True)
class TYParams:
    nu: float
    nnu: int
    Ro: float


def make_model(grid, nu=3.5e-25, nnu=8, Ro=0.2) -> Model:
    params = TYParams(nu=float(nu), nnu=int(nnu), Ro=float(Ro))
    D = -params.nu * grid.Krsq ** params.nnu  # (nl, nkr), same for all 4
    Ro = params.Ro

    def calcN(solh, t):
        solh = grid.dealias(solh)
        zth, uch, vch, pch = solh[0], solh[1], solh[2], solh[3]
        ik, il = grid.ik, grid.il
        psith = -zth * grid.invKrsq
        uth = -il * psith
        vth = ik * psith

        # one batched inverse FFT for all needed physical fields
        stack = jnp.stack([
            zth, uth, vth, uch, vch,
            il * uch,   # uc_y
            ik * vch,   # vc_x
            il * uth,   # ut_y
            ik * vth,   # vt_x
            ik * pch,   # pc_x
            il * pch,   # pc_y
        ])
        # input stays explicitly dealiased above: N has LINEAR terms in
        # solh (wave coupling) that never pass through the folded
        # transforms; the transforms themselves fold the mask
        ph = irfft2_dealiased(stack, grid)
        zt, ut, vt, uc, vc, ucy, vcx, uty, vtx, pcx, pcy = (
            ph[i] for i in range(11)
        )

        # one batched forward FFT of all quadratic products
        prods = jnp.stack([
            ut * zt, vt * zt,        # vorticity advection
            uc * vc,                 # baroclinic stress
            uc * uc, vc * vc,
            ut * uc, vt * vc,        # baroclinic advection diagonal
            vt * ucy + vc * uty,     # uc cross terms
            ut * vcx + uc * vtx,     # vc cross terms
            ut * pcx + vt * pcy,     # pressure advection
        ])
        prodh = rfft2_dealiased(prods, grid)
        utzt, vtzt = prodh[0], prodh[1]
        ucvc, uc2, vc2 = prodh[2], prodh[3], prodh[4]
        utuc, vtvc = prodh[5], prodh[6]
        uc_cross, vc_cross, pc_adv = prodh[7], prodh[8], prodh[9]

        k = grid.kr[None, :]
        l = grid.l[:, None]

        Nzt = -Ro * (
            1j * k * utzt + 1j * l * vtzt
            + (-(k**2) + l**2) * ucvc
            + k * l * (uc2 - vc2)
        )
        Nuc = vch - 1j * k * pch - Ro * (1j * k * utuc + uc_cross)
        Nvc = -uch - 1j * l * pch - Ro * (1j * l * vtvc + vc_cross)
        Npc = -1j * k * uch - 1j * l * vch - Ro * pc_adv
        return jnp.stack([Nzt, Nuc, Nvc, Npc])

    return Model(
        name="thomasyamada", grid=grid, params=params,
        L=jnp.broadcast_to(D, (4,) + D.shape), calcN=calcN, nfields=4,
    )


# --- eigenbasis and decomposition (thomasyamada/TYUtils.jl) ------------------

def ty_bases(grid):
    """(Phi0, Phip, Phim) each (3, nl, nkr) for the baroclinic components
    (uc, vc, pc); omega = sqrt(1 + K^2) (TYUtils.jl:10-37)."""
    kr = np.asarray(grid.kr, np.float64)[None, :]
    ell = np.asarray(grid.l, np.float64)[:, None]
    Krsq = np.asarray(grid.Krsq, np.float64)
    invK = np.asarray(grid.invKrsq, np.float64)
    om = np.sqrt(1.0 + Krsq)
    s = np.sqrt(invK / 2.0)

    Phi0 = np.empty((3,) + Krsq.shape, np.complex128)
    Phi0[0] = 1j * ell / om
    Phi0[1] = -1j * kr / om
    Phi0[2] = -1.0 / om
    Phi0[:, 0, 0] = [0.0, 0.0, 1.0]

    Phip = np.empty_like(Phi0)
    Phip[0] = (om * kr + 1j * ell) * s / om
    Phip[1] = (om * ell - 1j * kr) * s / om
    Phip[2] = (om**2 - 1.0) * s / om
    Phip[:, 0, 0] = np.asarray([1j, 1.0, 0.0]) / np.sqrt(2.0)

    Phim = np.empty_like(Phi0)
    Phim[0] = (-om * kr + 1j * ell) * s / om
    Phim[1] = (-om * ell - 1j * kr) * s / om
    Phim[2] = (om**2 - 1.0) * s / om
    Phim[:, 0, 0] = np.asarray([1j, -1.0, 0.0]) / np.sqrt(2.0)

    cast = lambda a: a.astype(np.complex64)
    return cast(Phi0), cast(Phip), cast(Phim)


def decompose_balanced_wave(solh, grid, bases=None):
    """(Gh, Wh): geostrophic and wave parts of the baroclinic components
    (TYUtils.jl:39-51). Input full state (4, nl, nkr); outputs (3, nl, nkr)."""
    if bases is None:
        bases = ty_bases(grid)
    Phi0, Phip, Phim = bases
    bc = solh[1:4]

    def proj(Phi):
        return jnp.sum(bc * jnp.conj(Phi), axis=0)

    Gh = proj(Phi0) * Phi0
    Wh = proj(Phip) * Phip + proj(Phim) * Phim
    return Gh, Wh


# --- energetics (ThomasYamada.jl:333-367) ------------------------------------

def barotropic_energy(solh, grid):
    return parseval_sum2(jnp.sqrt(grid.invKrsq) * solh[0], grid)


def baroclinic_energy(solh, grid):
    ke = parseval_sum2(solh[1], grid) + parseval_sum2(solh[2], grid)
    pe = parseval_sum2(solh[3], grid)
    return ke, pe


def wave_geostrophic_energy(solh, grid, bases=None):
    Gh, Wh = decompose_balanced_wave(solh, grid, bases)
    wave = (
        parseval_sum2(Wh[0], grid) + parseval_sum2(Wh[1], grid),
        parseval_sum2(Wh[2], grid),
    )
    geo = (
        parseval_sum2(Gh[0], grid) + parseval_sum2(Gh[1], grid),
        parseval_sum2(Gh[2], grid),
    )
    return wave, geo
