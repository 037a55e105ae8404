"""Slab-sharded rotating-shallow-water simulation.

``ShardedRSW`` instantiates the model-generic slab-sharded core
(parallel/sharded.ShardedSpectralModel — kr-column-sharded state, slab-local
FFTs with all_to_all transposes, all-gathered interpolation fields,
data-parallel coupled rays) for the 3-field RSW system
(rsw/RotatingShallowWater.jl): full 3x3 non-diagonal L handled by the
matrix-exponential IF-AB3, advection + height-flux nonlinearity, and the
PV-inversion streamfunction for ray advection
(rsw/RSWRaytracingDriver.jl:56-67).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..models import modified_sw, rsw
from .sharded import ShardedSpectralModel

__all__ = ["ShardedRSW", "ShardedLinborg", "ShardedModifiedSW",
           "ShardedQuadHeight"]


@dataclass
class ShardedRSW(ShardedSpectralModel):
    """Slab-sharded RSW stepping + coupled rays (``params`` is RSWParams)."""

    nfields = 3

    def _build_L(self):
        return rsw.build_L(self.grid, self.params)

    def _extra_consts(self):
        K2 = np.asarray(self.grid.Krsq, np.float64)
        Kd2 = self.params.f ** 2 / self.params.Cg2
        return {"pvfac": (-1.0 / (K2 + Kd2)).astype(np.float32)}

    def _calcN_local(self, solh, c):
        """rsw._advection_N on one kr-column shard: same math, transforms
        replaced by slab-local FFT + all_to_all (rsw/RotatingShallowWater.jl
        calcN!, :140-230)."""
        from .fft import local_irfft2, local_rfft2

        g = self.grid
        ik, il, deal = c["ik"], c["il"], c["deal"]
        solh = solh * deal
        uh, vh, etah = solh[0], solh[1], solh[2]
        fields = jnp.stack([uh, vh, etah, ik * uh, il * uh, ik * vh, il * vh])
        phys = local_irfft2(fields, g.nx, self.axis)   # (7, ny/P, nx)
        u, v, eta, ux, uy, vx, vy = (phys[i] for i in range(7))
        prods = jnp.stack([u * ux + v * uy, u * vx + v * vy, eta * u, eta * v])
        prodh = local_rfft2(prods, self.nkr_pad, self.axis)
        Nu = -prodh[0]
        Nv = -prodh[1]
        Neta = -(ik * prodh[2] + il * prodh[3])
        return jnp.stack([Nu, Nv, Neta]) * deal

    def _psih_local(self, sol, c):
        """PV-inversion streamfunction psih = -q/(K^2 + Kd^2)
        (rsw/RSWRaytracingDriver.jl:56-67) on one shard."""
        ik, il = c["ik"], c["il"]
        qh = ik * sol[1] - il * sol[0] - self.params.f * sol[2]
        return qh * c["pvfac"]


# -----------------------------------------------------------------------------
# RSW variants (the reference's file-swap models,
# rsw/{Linborg,Modified,QuadHeightModified}ShallowWater.jl)
# -----------------------------------------------------------------------------

@dataclass
class ShardedLinborg(ShardedRSW):
    """Linborg variant: advection by the rotational (divergence-free)
    component only (models.linborg; rsw/LinborgShallowWater.jl:155-237).
    Same L and ray streamfunction as RSW."""

    def _extra_consts(self):
        d = super()._extra_consts()
        d["invK"] = np.asarray(self.grid.invKrsq, np.float32)
        return d

    def _calcN_local(self, solh, c):
        from .fft import local_irfft2, local_rfft2

        g = self.grid
        ik, il, deal, invK = c["ik"], c["il"], c["deal"], c["invK"]
        solh = solh * deal
        uh, vh, etah = solh[0], solh[1], solh[2]
        zetah = ik * vh - il * uh
        psirh = -zetah * invK
        fields = jnp.stack([uh, vh, etah, ik * uh, il * uh, ik * vh,
                            il * vh, -il * psirh, ik * psirh])
        phys = local_irfft2(fields, g.nx, self.axis)   # (9, ny/P, nx)
        u, v, eta, ux, uy, vx, vy, ur, vr = (phys[i] for i in range(9))
        prods = jnp.stack([ur * ux + vr * uy, ur * vx + vr * vy,
                           eta * u, eta * v])
        prodh = local_rfft2(prods, self.nkr_pad, self.axis)
        Neta = -(ik * prodh[2] + il * prodh[3])
        return jnp.stack([-prodh[0], -prodh[1], Neta]) * deal


@dataclass
class ShardedModifiedSW(ShardedRSW):
    """Modified SW variant: nonlinear pressure F(eta) in N, pressure column
    removed from L (models.modified_sw; rsw/ModifiedShallowWater.jl)."""

    _decouple_eta = False

    def _build_L(self):
        return modified_sw.build_L_modified(self.grid, self.params,
                                            decouple_eta=self._decouple_eta)

    def _pressure_local(self, h):
        # Cg^2 F with F = 3/2 - 1/(2 (1+eta)^2) (ModifiedShallowWater.jl:219)
        return self.params.Cg2 * (1.5 - 0.5 / (1.0 + h) ** 2)

    def _calcN_local(self, solh, c):
        from .fft import local_irfft2, local_rfft2

        g = self.grid
        ik, il, deal = c["ik"], c["il"], c["deal"]
        solh = solh * deal
        uh, vh, hh = solh[0], solh[1], solh[2]
        stack = jnp.stack([uh, vh, hh, ik * uh, il * uh, ik * vh, il * vh])
        phys = local_irfft2(stack, g.nx, self.axis)
        u, v, h, ux, uy, vx, vy = (phys[i] for i in range(7))
        F = self._pressure_local(h)
        prods = jnp.stack([u * ux + v * uy, u * vx + v * vy, F, h * u, h * v])
        prodh = local_rfft2(prods, self.nkr_pad, self.axis)
        Nu = -prodh[0] - ik * prodh[2]
        Nv = -prodh[1] - il * prodh[2]
        Nh = -(ik * prodh[3] + il * prodh[4])
        return jnp.stack([Nu, Nv, Nh]) * deal


@dataclass
class ShardedQuadHeight(ShardedModifiedSW):
    """QuadHeight variant: prognostic m = 1/(1+eta), pressure
    F = Cg^2 (3/2 - m^2/2), fully decoupled third L row/column
    (models.quadheight; rsw/QuadHeightModifiedShallowWater.jl). The ray
    streamfunction recovers eta = 1/m - 1 through one extra slab-local FFT
    round-trip before the PV inversion."""

    _decouple_eta = True

    def _pressure_local(self, m):
        return self.params.Cg2 * (1.5 - 0.5 * m * m)

    def _psih_local(self, sol, c):
        from .fft import local_irfft2, local_rfft2

        ik, il = c["ik"], c["il"]
        m = local_irfft2(sol[2:3], self.grid.nx, self.axis)
        etah = local_rfft2(1.0 / m - 1.0, self.nkr_pad, self.axis)[0]
        qh = ik * sol[1] - il * sol[0] - self.params.f * etah
        return qh * c["pvfac"]
