"""Model-generic slab-sharded spectral simulation core.

For grids too large to replicate per chip (the reference's largest
production grid is a 2048^2 two-layer QG, swqg/TwoLayerParameters.jl:5;
SURVEY.md §2.7 calls for slab/pencil FFT at 1024^2+), the spectral state
lives kr-column-sharded across the mesh and every transform in ``calcN``
runs as local FFT -> all_to_all transpose -> local FFT
(parallel/fft.local_rfft2 / local_irfft2). The IF-AB3 step — matrix-
exponential apply, AB3 history, dealiasing — is elementwise in spectral
space and therefore embarrassingly sharded; only the transposes touch the
interconnect.

The machinery (padded sharded constants, shard_map stepper, all-gathered
interpolation fields, coupled ray frame) is model-independent; per-model
deltas are exactly:

- ``_build_L``      : the host-side (C, C, nl, nkr) block (or (nl, nkr)
                      diagonal) linear operator;
- ``_calcN_local``  : the nonlinear RHS on one kr-column shard, written
                      against ``local_rfft2``/``local_irfft2``;
- ``_psih_local``   : the advecting streamfunction for ray tracing;
- ``_extra_consts`` : any per-mode inversion factors the two hooks need.

Instantiations: ``ShardedRSW`` (parallel/sharded_rsw.py), and here
``ShardedTwoLayerQG`` (the reference's 2048^2-capacity model,
swqg/TwoLayerQG.jl:77,184-206) and ``ShardedSWQG`` (swqg/SWQG.jl).

Coupled ray tracing on top: after each sharded flow step the 5
interpolation fields are formed locally in y-slabs and ``all_gather``-ed to
every device (SURVEY.md §2.7: this collective is the interconnect-bandwidth-critical
path); the patch table is then built replicated and packets advance
data-parallel along their own axis.

Layout conventions:
- global sharded spectral state: (C, nl, nkr_pad), PartitionSpec
  (None, None, axis); nkr_pad = padded_nkr(nx, P) and the pad columns stay
  identically zero (L, masks and factors are zero there);
- requires ny % P == 0 and uses one 1-D mesh axis for both the field slabs
  and the packet batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.steppers import AB3State, AB3_H1, AB3_H2, AB3_H3, Clock, apply_L, expm_tables
from ..models import (multilayerqg as _mlqg, swqg as _swqg,
                      thomasyamada as _ty, twolayerqg as _tlqg)
from ..rays.interp import bspline_prefilter_mask
from ..rays.packets import Packets
from ..rays.patch import build_patch_table
from ..rays.raytrace import RayParams, make_pair_table, raytrace_tables
from ..rays.resample import k_cutoff_reset
from .fft import local_irfft2, local_rfft2, padded_nkr

__all__ = ["ShardedSpectralModel", "ShardedTwoLayerQG", "ShardedSWQG",
           "ShardedThomasYamada", "ShardedMultiLayerQG"]


def _pad_last(a: np.ndarray, size: int) -> np.ndarray:
    out = np.zeros(a.shape[:-1] + (size,), a.dtype)
    out[..., : a.shape[-1]] = a
    return out


@dataclass
class ShardedSpectralModel:
    """Slab-sharded spectral stepping + coupled rays, generic over models.

    Usage (any subclass)::

        sh = ShardedTwoLayerQG(grid, params, mesh, dt=dt)
        sol_sh = sh.shard_solution(sol)          # (C, nl, nkr_pad) sharded
        init_fn, step_fn = sh.stepper()          # same protocol as build_stepper
        fields = sh.fields(sol_sh)               # (5, ny, nx) replicated
        frame = sh.make_coupled_frame(...)       # flow+rays, one jitted program
    """

    grid: object
    params: object
    mesh: Mesh
    dt: float
    axis: str = "packets"
    interp: str = "bilinear"

    nfields = 0  # subclass responsibility

    # --- model hooks (subclass responsibility) -------------------------------
    def _build_L(self) -> np.ndarray:
        """Host (C, C, nl, nkr) block or (nl, nkr) diagonal linear operator."""
        raise NotImplementedError

    def _extra_consts(self) -> dict:
        """Extra host per-mode constants; anything with trailing dim == nkr
        is zero-padded to nkr_pad and kr-column-sharded automatically."""
        return {}

    def _calcN_local(self, solh, c: dict):
        """Nonlinear RHS on one kr-column shard (c = sharded consts dict)."""
        raise NotImplementedError

    def _psih_local(self, sol, c: dict):
        """(nl, nkr_pad/P) advecting streamfunction shard for ray fields."""
        raise NotImplementedError

    # --- generic machinery ---------------------------------------------------
    def __post_init__(self):
        g = self.grid
        nproc = self.mesh.shape[self.axis]
        if g.ny % nproc:
            raise ValueError(f"ny={g.ny} not divisible by mesh size {nproc}")
        self.nkr_pad = padded_nkr(g.nx, nproc)
        nkrp = self.nkr_pad

        def spec_for(a):
            if a.shape[-1] == nkrp:
                return P(*((None,) * (a.ndim - 1)), self.axis)
            return P(*((None,) * a.ndim))

        def put(a):
            a = _pad_last(a, nkrp) if a.shape[-1] == g.nkr else a
            spec = spec_for(a)
            if np.iscomplexobj(a):
                # keep complex constants as HOST numpy: they embed into
                # jitted executables without a device transfer (same
                # policy as the replicated steppers' expm tables,
                # core/transfer.py). shard_map in_specs still apply to the
                # embedded constant at compile time.
                return np.ascontiguousarray(a), spec
            return jax.device_put(
                jnp.asarray(a), NamedSharding(self.mesh, spec)), spec

        e1, e2 = expm_tables(self._build_L(), self.dt)
        self._expL, self._expL_spec = put(e1)
        self._exp2L, _ = put(e2)

        kr = np.asarray(g.kr, np.float64)
        ell = np.asarray(g.l, np.float64)[:, None]
        if self.interp == "bspline":
            fmask = np.asarray(bspline_prefilter_mask(g))
        else:
            fmask = np.ones((g.nl, g.nkr), np.float32)
        host = {
            "ik": (1j * kr[None, :]).astype(np.complex64),
            "il": (1j * ell).astype(np.complex64),          # (nl, 1) replicated
            "deal": np.asarray(g.dealias_mask),
            "fmask": fmask,
        }
        host.update(self._extra_consts())
        self._consts, self._conspecs = {}, {}
        for k, a in host.items():
            self._consts[k], self._conspecs[k] = put(np.asarray(a))
        self.sol_sharding = NamedSharding(self.mesh, P(None, None, self.axis))

    # --- state movement ------------------------------------------------------
    def shard_solution(self, sol):
        """(C, nl, nkr) replicated/host -> (C, nl, nkr_pad) sharded.

        A channel-less (nl, nkr) solution (SWQG) grows a leading C=1 axis.
        Complex transfers go through core/transfer.py.
        """
        from ..core.transfer import to_host

        sol_np = to_host(sol)
        if sol_np.ndim == 2:
            sol_np = sol_np[None]
        sol_np = _pad_last(sol_np, self.nkr_pad)
        if np.iscomplexobj(sol_np):
            re = jax.device_put(
                jnp.asarray(np.ascontiguousarray(sol_np.real)),
                self.sol_sharding)
            im = jax.device_put(
                jnp.asarray(np.ascontiguousarray(sol_np.imag)),
                self.sol_sharding)
            return jax.jit(jax.lax.complex)(re, im)
        return jax.device_put(jnp.asarray(sol_np), self.sol_sharding)

    def unshard(self, sol_sh):
        """Crop the pad and pull to host (C, nl, nkr) (or (nl, nkr) if C=1
        and the model state is channel-less)."""
        from ..core.transfer import to_host

        out = to_host(sol_sh)[..., : self.grid.nkr]
        if self.nfields == 1 and out.shape[0] == 1 and getattr(
                self, "_squeeze_channel", False):
            return out[0]
        return out

    # --- generic IF-AB3 step on local shards ---------------------------------
    def _step_local(self, sol, step, N1, N2, expL, exp2L, c):
        """One IF-AB3 step on local shards (core/steppers.make_ifab3 logic
        with explicit per-shard constants)."""
        N = self._calcN_local(sol, c)
        dt = self.dt

        def euler(_):
            return apply_L(expL, sol + dt * N)

        def ab3(_):
            incr = dt * (
                AB3_H1 * N
                - AB3_H2 * apply_L(expL, N1)
                + AB3_H3 * apply_L(exp2L, N2)
            )
            return apply_L(expL, sol + incr)

        new = jax.lax.cond(step < 3, euler, ab3, None)
        return new, N, N1

    def _fields_local(self, sol, c):
        """Streamfunction -> 5 interpolation fields, local y-slab inverse
        transform, then all_gather to full replication (the interconnect-critical
        collective, SURVEY.md §2.7)."""
        g = self.grid
        ik, il = c["ik"], c["il"]
        psih = self._psih_local(sol, c)
        uh = -il * psih
        vh = ik * psih
        stack = jnp.stack([uh, vh, ik * uh, il * uh, ik * vh]) * c["fmask"]
        phys = local_irfft2(stack, g.nx, self.axis)  # (5, ny/P, nx)
        # untiled gather + explicit transpose/reshape: the tiled form makes
        # XLA:CPU feed the irfft a non-dim0-major layout (fft_thunk RET_CHECK)
        gat = jax.lax.all_gather(phys, self.axis)    # (P, 5, ny/P, nx)
        return jnp.transpose(gat, (1, 0, 2, 3)).reshape(
            phys.shape[0], g.ny, g.nx)

    # --- public jitted entry points -------------------------------------------
    def stepper(self):
        """(init_fn, step_fn) with the standard protocol, on sharded state."""
        ax = self.axis
        sol_spec = P(None, None, ax)
        smapped = jax.shard_map(
            self._step_local, mesh=self.mesh,
            in_specs=(sol_spec, P(), sol_spec, sol_spec,
                      self._expL_spec, self._expL_spec, self._conspecs),
            out_specs=(sol_spec, sol_spec, sol_spec),
        )
        dt = self.dt

        def init_fn(sol_sh):
            z = sol_sh * 0
            return AB3State(z, z)

        @jax.jit
        def step_fn(sol, clock: Clock, state: AB3State):
            new, N1, N2 = smapped(sol, clock.step, state.N1, state.N2,
                                  self._expL, self._exp2L, self._consts)
            return new, Clock(clock.t + dt, clock.step + 1), AB3State(N1, N2)

        return init_fn, step_fn

    def fields(self, sol_sh):
        return self._fields_jit()(sol_sh)

    def _fields_jit(self):
        sol_spec = P(None, None, self.axis)
        smapped = jax.shard_map(
            self._fields_local, mesh=self.mesh,
            in_specs=(sol_spec, self._conspecs),
            out_specs=P(None, None, None),
            # the tiled all_gather makes the output bit-identical on every
            # device, but shard_map can't infer that statically
            check_vma=False,
        )
        return jax.jit(lambda sol: smapped(sol, self._consts))

    def make_coupled_frame(self, rp: RayParams, flow_steps: int,
                           ray_substeps: int = 1, ray_method: str = "rk4",
                           k_cutoff: float | None = None,
                           k0: float | None = None,
                           overlap: bool = False,
                           n_packets: int | None = None,
                           interpret: bool = False):
        """Jitted frame interleaving sharded flow steps with data-parallel
        ray substeps — the multi-chip equivalent of
        coupled.driver.make_coupled_frame.

        ``overlap=True`` pipelines the rays one flow interval behind the
        PDE: each scan iteration advances the flow to t_{n+2} (whose
        interpolation-field ``all_gather`` runs) while the packets
        advance through the already-gathered [t_n, t_{n+1}] pair — the two
        halves share no data, so XLA's latency-hiding scheduler can overlap
        the collective with the ray gather/VPU work (SURVEY.md §2.7
        "flow/ray overlap"). A final catch-up interval after the scan makes
        the trajectories IDENTICAL to the sequential frame — same field
        pairs, same order — pinned by tests/test_sharded_rsw.py.

        The patch-path ray substep runs under ``shard_map`` over the packet
        axis: each card traces its own packet shard through the replicated
        pair table, so the fused Pallas kernel (GPU backends) never has to
        be partitioned by XLA. ``interpret=True`` runs that kernel in the
        Pallas interpreter on any backend (tests)."""
        from ..rays.raytrace import _raytrace_taps, _use_patch, resolve_gather

        g = self.grid
        ny, nx = g.ny, g.nx
        if rp.gather == "auto":
            if n_packets is None:
                raise ValueError(
                    "rp.gather='auto' requires n_packets= so the frame can "
                    "resolve the patch-vs-taps crossover at build time")
            rp = resolve_gather(rp, n_packets, ny, nx)
        use_patch = _use_patch(rp)
        if overlap and not use_patch:
            raise ValueError("overlap=True requires the patch gather path")
        _, step_fn = self.stepper()
        fields_fn = self._fields_jit()

        def trace_local(packets, T_old, T_new, t0, t1):
            packets = raytrace_tables(
                packets, make_pair_table(T_old, T_new, rp.table_dtype), t0, t1, rp, ny, nx,
                nsubsteps=ray_substeps, method=ray_method,
                interpret=interpret,
            )
            if k_cutoff is not None:
                packets = k_cutoff_reset(packets, k_cutoff, k0)
            return packets

        trace = jax.shard_map(
            trace_local, mesh=self.mesh,
            in_specs=(P(self.axis), P(), P(), P(), P()),
            out_specs=P(self.axis), check_vma=False)

        def one(carry, _):
            sol, clock, sstate, packets, fields_old, T_old = carry
            t0 = clock.t
            sol, clock, sstate = step_fn(sol, clock, sstate)
            fields_new = fields_fn(sol)
            if use_patch:
                T_new = build_patch_table(fields_new, rp.interp)
                packets = trace(packets, T_old, T_new, t0, clock.t)
            else:
                # taps gather straight from the all-gathered field stacks —
                # wins when the grid dwarfs the ensemble (any patch path
                # pays a grid-sized table build per step)
                T_new = T_old
                packets = _raytrace_taps(packets, fields_old, fields_new,
                                         t0, clock.t, rp, ray_substeps,
                                         ray_method)
                if k_cutoff is not None:
                    packets = k_cutoff_reset(packets, k_cutoff, k0)
            return (sol, clock, sstate, packets, fields_new, T_new), None

        def one_overlap(carry, _):
            # carry: flow at t_{n+1}; packets at t_n with the gathered
            # (T_n, T_{n+1}) pair in hand
            sol, clock, sstate, packets, T_prev, T_cur, t_prev = carry
            t_cur = clock.t
            sol, clock, sstate = step_fn(sol, clock, sstate)   # -> t_{n+2}
            fields_next = fields_fn(sol)                       # all_gather
            T_next = build_patch_table(fields_next, rp.interp)
            # independent of the step/gather above -> overlappable
            packets = trace(packets, T_prev, T_cur, t_prev, t_cur)
            return (sol, clock, sstate, packets, T_cur, T_next, t_cur), None

        @jax.jit
        def frame(sol, clock, sstate, packets: Packets):
            fields0 = fields_fn(sol)
            T0 = build_patch_table(fields0, rp.interp) if use_patch else ()
            if not overlap:
                carry = (sol, clock, sstate, packets, fields0, T0)
                carry, _ = jax.lax.scan(one, carry, None, length=flow_steps)
                return carry[:4]
            # prologue: flow 0 -> 1 (no ray interval exists yet)
            t0 = clock.t
            sol, clock, sstate = step_fn(sol, clock, sstate)
            fields1 = fields_fn(sol)
            T1 = build_patch_table(fields1, rp.interp)
            carry = (sol, clock, sstate, packets, T0, T1, t0)
            carry, _ = jax.lax.scan(one_overlap, carry, None,
                                    length=flow_steps - 1)
            sol, clock, sstate, packets, T_prev, T_cur, t_prev = carry
            # epilogue: catch the rays up through the last interval
            packets = trace(packets, T_prev, T_cur, t_prev, clock.t)
            return sol, clock, sstate, packets

        return frame


# -----------------------------------------------------------------------------
# Two-layer QG (the reference's largest-capacity model, 2048^2:
# swqg/TwoLayerParameters.jl:5, swqg/TwoLayerQG.jl:77,184-206)
# -----------------------------------------------------------------------------

@dataclass
class ShardedTwoLayerQG(ShardedSpectralModel):
    """Slab-sharded equal-depth two-layer QG + coupled rays.

    ``params`` is a models.twolayerqg.TwoLayerParams. ``advect`` selects the
    ray-advecting streamfunction: 'barotropic' (psi1+psi2)/2 (reference
    raytracing/TwoLayerRaytracing.jl:122) or 'baroclinic' (psi1-psi2)/2
    (swqg/TwoLayerRaytracingDriver.jl:232).
    """

    advect: str = "barotropic"
    nfields = 2

    def _build_L(self):
        return _tlqg.build_L(self.grid, self.params)

    def _extra_consts(self):
        K2 = np.asarray(self.grid.Krsq, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            K2inv = np.where(K2 > 0, 1.0 / np.where(K2 > 0, K2, 1.0), 0.0)
        scale = K2inv / (K2 + 2.0 * self.params.F)
        return {
            "Krsq": np.asarray(self.grid.Krsq, np.float32),
            "scale": scale.astype(np.float32),
        }

    def _stretch_inv(self, qh, c):
        """psih from qh: inverse stretching matrix applied per mode
        (models.twolayerqg.streamfunction_from_pv on one shard)."""
        F = self.params.F
        qsum = qh[0] + qh[1]
        p1 = -(c["Krsq"] * qh[0] + F * qsum)
        p2 = -(c["Krsq"] * qh[1] + F * qsum)
        return jnp.stack([p1, p2]) * c["scale"]

    def _calcN_local(self, solh, c):
        """Per-layer q_t = -J(psi_j, q_j), conservative form
        (models.twolayerqg calcN with the transforms replaced by slab-local
        FFT + all_to_all; swqg/TwoLayerQG.jl:152-182)."""
        ik, il, deal = c["ik"], c["il"], c["deal"]
        qh = solh * deal
        psih = self._stretch_inv(qh, c)
        stack = jnp.concatenate([qh, ik * psih, il * psih])   # (6, nl, nkrp/P)
        phys = local_irfft2(stack, self.grid.nx, self.axis)   # (6, ny/P, nx)
        q, psix, psiy = phys[0:2], phys[2:4], phys[4:6]
        prodh = local_rfft2(jnp.concatenate([psix * q, psiy * q]),
                            self.nkr_pad, self.axis)
        return (-il * prodh[0:2] + ik * prodh[2:4]) * deal

    def _psih_local(self, sol, c):
        psih = self._stretch_inv(sol, c)
        if self.advect == "baroclinic":
            return 0.5 * (psih[0] - psih[1])
        return 0.5 * (psih[0] + psih[1])


# -----------------------------------------------------------------------------
# One-layer equivalent-barotropic QG (swqg/SWQG.jl; diagonal L)
# -----------------------------------------------------------------------------

@dataclass
class ShardedSWQG(ShardedSpectralModel):
    """Slab-sharded SWQG + coupled rays (``params`` is a SWQGParams).

    State is carried internally as (1, nl, nkr_pad); ``shard_solution``
    accepts the model's channel-less (nl, nkr) layout and ``unshard``
    returns it.
    """

    nfields = 1
    _squeeze_channel = True

    def _build_L(self):
        g, p = self.grid, self.params
        return np.asarray(-p.nu * np.asarray(g.Krsq, np.float64) ** p.nnu,
                          np.float32)

    def _extra_consts(self):
        K2 = np.asarray(self.grid.Krsq, np.float64)
        return {"ifac": (-1.0 / (K2 + self.params.Kd2)).astype(np.float32)}

    def _calcN_local(self, solh, c):
        """-J(psi, q) conservative form (models.swqg calcN on one shard;
        swqg/SWQG.jl:140-170)."""
        ik, il, deal = c["ik"], c["il"], c["deal"]
        qh = solh * deal                                     # (1, nl, nkrp/P)
        psih = qh * c["ifac"]
        stack = jnp.concatenate([qh, ik * psih, il * psih])  # (3, ...)
        phys = local_irfft2(stack, self.grid.nx, self.axis)
        q, psix, psiy = phys[0:1], phys[1:2], phys[2:3]
        prodh = local_rfft2(jnp.concatenate([psix * q, psiy * q]),
                            self.nkr_pad, self.axis)
        return (-il * prodh[0:1] + ik * prodh[1:2]) * deal

    def _psih_local(self, sol, c):
        return (sol * c["ifac"])[0]


# -----------------------------------------------------------------------------
# Thomas-Yamada coupled barotropic/baroclinic model
# (thomasyamada/ThomasYamada.jl; diagonal hyperviscous L on 4 components)
# -----------------------------------------------------------------------------

@dataclass
class ShardedThomasYamada(ShardedSpectralModel):
    """Slab-sharded Thomas-Yamada stepping (``params`` is a TYParams).

    State (4, nl, nkr_pad): (zeta_t, u_c, v_c, p_c). Steps with the
    sharded IF-AB3 (the reference's ETDAB3 scheme class); the replicated
    path additionally offers ETDRK4 (the reference TY default,
    thomasyamada/ThomasYamada.jl:55-74). The ray-advecting streamfunction
    is the barotropic psi_t = -zeta_t / K^2.
    """

    nfields = 4

    def _build_L(self):
        g, p = self.grid, self.params
        D = -p.nu * np.asarray(g.Krsq, np.float64) ** p.nnu
        return np.broadcast_to(D, (4,) + D.shape).astype(np.float32)

    def _extra_consts(self):
        g = self.grid
        return {
            "k": np.asarray(g.kr, np.float32)[None, :],
            "lr": np.asarray(g.l, np.float32)[:, None],   # (nl, 1) replicated
            "invK": np.asarray(g.invKrsq, np.float32),
        }

    def _calcN_local(self, solh, c):
        """models.thomasyamada calcN on one kr-column shard (the 11-field
        inverse and 10-product forward transforms become slab-local FFT +
        all_to_all; thomasyamada/ThomasYamada.jl:129-274)."""
        ik, il, deal = c["ik"], c["il"], c["deal"]
        k, l, invK = c["k"], c["lr"], c["invK"]
        Ro = self.params.Ro
        solh = solh * deal
        zth, uch, vch, pch = solh[0], solh[1], solh[2], solh[3]
        psith = -zth * invK
        uth = -il * psith
        vth = ik * psith

        stack = jnp.stack([
            zth, uth, vth, uch, vch,
            il * uch, ik * vch, il * uth, ik * vth, ik * pch, il * pch,
        ])
        ph = local_irfft2(stack, self.grid.nx, self.axis)
        zt, ut, vt, uc, vc, ucy, vcx, uty, vtx, pcx, pcy = (
            ph[i] for i in range(11)
        )
        prods = jnp.stack([
            ut * zt, vt * zt,
            uc * vc, uc * uc, vc * vc,
            ut * uc, vt * vc,
            vt * ucy + vc * uty,
            ut * vcx + uc * vtx,
            ut * pcx + vt * pcy,
        ])
        prodh = local_rfft2(prods, self.nkr_pad, self.axis)
        utzt, vtzt = prodh[0], prodh[1]
        ucvc, uc2, vc2 = prodh[2], prodh[3], prodh[4]
        utuc, vtvc = prodh[5], prodh[6]
        uc_cross, vc_cross, pc_adv = prodh[7], prodh[8], prodh[9]

        Nzt = -Ro * (
            1j * k * utzt + 1j * l * vtzt
            + (-(k**2) + l**2) * ucvc
            + k * l * (uc2 - vc2)
        )
        Nuc = vch - 1j * k * pch - Ro * (1j * k * utuc + uc_cross)
        Nvc = -uch - 1j * l * pch - Ro * (1j * l * vtvc + vc_cross)
        Npc = -1j * k * uch - 1j * l * vch - Ro * pc_adv
        return jnp.stack([Nzt, Nuc, Nvc, Npc]) * deal

    def _psih_local(self, sol, c):
        return -sol[0] * c["invK"]


# -----------------------------------------------------------------------------
# General n-layer QG (models/multilayerqg — the GeophysicalFlows
# MultiLayerQG equivalent the reference drivers build problems from)
# -----------------------------------------------------------------------------

@dataclass
class ShardedMultiLayerQG(ShardedSpectralModel):
    """Slab-sharded n-layer QG (``params`` is a MultiLayerParams).

    State (n, nl, nkr_pad); the per-mode n x n inverse stretching matrix is
    a kr-column-sharded constant applied as a channel einsum (the
    batched-trailing-dims form lowers elementwise). The
    ray-advecting streamfunction is the depth-weighted (barotropic) mean
    sum_j delta_j psi_j (raytracing/TwoLayerRaytracing.jl:122 generalised).
    """

    def __post_init__(self):
        self.nfields = self.params.nlayers
        super().__post_init__()

    def _build_L(self):
        return _mlqg.build_L(self.grid, self.params)

    def _extra_consts(self):
        return {"Sinv": _mlqg._sinv(self.grid, self.params)
                .astype(np.float32)}

    def _psi_from_q(self, qh, c):
        return jnp.einsum("ab...,b...->a...", c["Sinv"], qh,
                          precision=jax.lax.Precision.HIGHEST)

    def _calcN_local(self, solh, c):
        """models.multilayerqg calcN on one kr-column shard: per-layer
        J(psi_j, q_j) advection with the mean-flow/PV-gradient terms in L."""
        ik, il, deal = c["ik"], c["il"], c["deal"]
        n = self.params.nlayers
        qh = solh * deal
        psih = self._psi_from_q(qh, c)
        stack = jnp.concatenate([qh, ik * psih, il * psih])   # (3n, ...)
        phys = local_irfft2(stack, self.grid.nx, self.axis)
        q, psix, psiy = phys[0:n], phys[n:2 * n], phys[2 * n:3 * n]
        prodh = local_rfft2(jnp.concatenate([psix * q, psiy * q]),
                            self.nkr_pad, self.axis)
        return (-il * prodh[0:n] + ik * prodh[n:2 * n]) * deal

    def _psih_local(self, sol, c):
        psih = self._psi_from_q(sol, c)
        w = jnp.asarray(self.params.delta, psih.real.dtype)
        return jnp.tensordot(w, psih, axes=(0, 0),
                             precision=jax.lax.Precision.HIGHEST)
