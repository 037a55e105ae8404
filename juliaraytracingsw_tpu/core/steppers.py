"""Time steppers for stiff pseudo-spectral systems.

Provides JAX equivalents of every stepper the reference uses:

- ``make_ifab3``      : 3rd-order Adams-Bashforth with matrix-exponential
                        integrating factor for non-diagonal per-mode linear
                        operators (reference utils/IFMAB3.jl, utils/ETDAB3.jl).
                        The per-mode ``exp(L dt)`` blocks are precomputed once
                        on the host in float64 (replacing the reference's CUDA
                        ``kernel_exp``, utils/IFMAB3.jl:32-41) and applied each
                        step as a tiny channel einsum — elementwise
                        multiply-adds, fused by XLA with the AB3
                        update (replacing ``mv_mul_kernel``, utils/IFMAB3.jl:90-127).
- ``make_ifrk4``      : working integrating-factor RK4 (the reference's
                        utils/IFMRK4.jl was abandoned/broken — SURVEY.md §2.1).
- ``make_etdrk4``     : Cox-Matthews ETDRK4 with Kassam-Trefethen contour
                        coefficients (reference Thomas-Yamada default stepper,
                        thomasyamada/ThomasYamada.jl:55-74).
- ``make_filtered_ab3`` / ``make_filtered_rk4`` : classic AB3/RK4 on the full
                        RHS L*sol + N with an exponential filter
                        (GeophysicalFlows "FilteredAB3"/"FilteredRK4" used by
                        raytracing/Parameters.jl:7, simulation/Parameters.jl:25).

All steppers share one functional protocol::

    init_fn(sol0) -> state0
    step_fn(sol, clock, state) -> (sol', clock', state')

with ``Clock = (t, step)`` a traced pytree, so any stepper drops into
``lax.scan`` loops and is differentiable end-to-end.

AB3 bootstrap matches the reference exactly: forward-Euler for steps 0..2,
AB3 from step 3 on (utils/IFMAB3.jl:129-140). Because the stepper state
carries (N_{-1}, N_{-2}), checkpoint/resume preserves the AB3 history —
fixing the reference's restart discontinuity (SURVEY.md §5.4).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Clock",
    "apply_L",
    "expm_tables",
    "make_ifab3",
    "make_ifrk4",
    "make_etdrk4",
    "make_filtered_ab3",
    "make_filtered_rk4",
]

AB3_H1, AB3_H2, AB3_H3 = 23.0 / 12.0, 16.0 / 12.0, 5.0 / 12.0


class Clock(NamedTuple):
    t: jax.Array     # model time, float
    step: jax.Array  # integer step count


def tick(clock: Clock, dt: float) -> Clock:
    return Clock(clock.t + dt, clock.step + 1)


def zero_clock(dtype=jnp.float32) -> Clock:
    return Clock(jnp.zeros((), dtype), jnp.zeros((), jnp.int32))


# -----------------------------------------------------------------------------
# Linear-operator application
# -----------------------------------------------------------------------------

def apply_L(L: jax.Array, sol: jax.Array) -> jax.Array:
    """Apply a per-mode linear operator.

    ``L`` is either diagonal with the same shape as ``sol`` (or broadcastable
    to it), or a per-mode block ``(C, C, nl, nkr)`` acting on the channel axis
    of ``sol`` with shape ``(C, nl, nkr)``. The block contraction is pinned
    to full float32 precision: left at the default, a GPU may run it in
    TF32 (~3 decimal digits), three times per IF-AB3 step.
    """
    if L.ndim == sol.ndim + 1:
        return jnp.einsum("ab...,b...->a...", L, sol,
                          precision=jax.lax.Precision.HIGHEST)
    return L * sol


def expm_tables(L, dt: float):
    """Host-side float64 precompute of exp(L*dt) and exp(2*L*dt).

    For block operators this is a batched dense matrix exponential over all
    spectral modes — done once at setup (the reference launches a CUDA kernel
    computing per-mode SMatrix exponentials, utils/IFMAB3.jl:44-66; a
    one-off host precompute in float64 is both simpler and more accurate,
    SURVEY.md §7 "hard parts").
    """
    import scipy.linalg

    from .transfer import to_host

    Lnp = to_host(L)
    if Lnp.ndim >= 2 and Lnp.shape[0] == Lnp.shape[1] and Lnp.ndim >= 4:
        # block (C, C, nl, nkr) -> (nl, nkr, C, C) for batched expm
        perm = tuple(range(2, Lnp.ndim)) + (0, 1)
        blocks = np.transpose(Lnp.astype(np.complex128), perm)
        e1 = scipy.linalg.expm(blocks * dt)
        e2 = scipy.linalg.expm(blocks * (2.0 * dt))
        inv = tuple(range(Lnp.ndim - 2, Lnp.ndim)) + tuple(range(Lnp.ndim - 2))
        e1 = np.transpose(e1, inv)
        e2 = np.transpose(e2, inv)
    else:
        Ld = Lnp.astype(np.complex128)
        e1 = np.exp(Ld * dt)
        e2 = np.exp(Ld * 2.0 * dt)
    cdtype = np.complex64 if Lnp.dtype != np.complex128 else np.complex128
    # NOTE: return HOST numpy arrays. Closed-over numpy constants embed into
    # jitted executables without a device transfer (see core/transfer.py).
    return e1.astype(cdtype), e2.astype(cdtype)


def _as_filter(filt, dtype=jnp.float32):
    if filt is None:
        return None
    return jnp.asarray(filt, dtype)


# -----------------------------------------------------------------------------
# IF-AB3 (matrix-exponential integrating factor Adams-Bashforth 3)
# -----------------------------------------------------------------------------

class AB3State(NamedTuple):
    N1: jax.Array  # N at step-1
    N2: jax.Array  # N at step-2


def make_ifab3(
    L: jax.Array,
    calcN: Callable[[jax.Array, jax.Array], jax.Array],
    dt: float,
    filt: jax.Array | None = None,
):
    """Integrating-factor AB3 stepper (reference utils/IFMAB3.jl:129-169).

    Update (exactly the reference's ordering):
        N    = calcN(sol, t)
        sol += dt * (23/12 N - 16/12 e^{Ldt} N_{-1} + 5/12 e^{2Ldt} N_{-2})
        sol  = e^{Ldt} sol
        sol *= filter
    with forward-Euler bootstrap for steps < 3.
    """
    expLdt, exp2Ldt = expm_tables(L, dt)
    filt = _as_filter(filt)

    def init(sol0: jax.Array) -> AB3State:
        # sol0 * 0: zeros on sol0's device, no complex constant transfer
        z = sol0 * 0
        return AB3State(z, z)

    def step(sol, clock: Clock, state: AB3State):
        N = calcN(sol, clock.t)

        def euler(_):
            return apply_L(expLdt, sol + dt * N)

        def ab3(_):
            incr = dt * (
                AB3_H1 * N
                - AB3_H2 * apply_L(expLdt, state.N1)
                + AB3_H3 * apply_L(exp2Ldt, state.N2)
            )
            return apply_L(expLdt, sol + incr)

        new = jax.lax.cond(clock.step < 3, euler, ab3, None)
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), AB3State(N, state.N1)

    return init, step


# -----------------------------------------------------------------------------
# IF-RK4
# -----------------------------------------------------------------------------

class EmptyState(NamedTuple):
    pass


def make_ifrk4(
    L: jax.Array,
    calcN: Callable[[jax.Array, jax.Array], jax.Array],
    dt: float,
    filt: jax.Array | None = None,
):
    """Integrating-factor RK4 (a working version of the reference's abandoned
    utils/IFMRK4.jl). Standard: with E = exp(L dt/2),

        k1 = N(u, t)
        k2 = N(E u + dt/2 E k1, t + dt/2)
        k3 = N(E u + dt/2 k2, t + dt/2)
        k4 = N(E^2 u + dt E k3, t + dt)
        u' = E^2 u + dt/6 (E^2 k1 + 2 E (k2 + k3) + k4)
    """
    exph, _ = expm_tables(L, dt / 2.0)  # e^{L dt/2}

    def E(x):
        return apply_L(exph, x)

    filt = _as_filter(filt)

    def init(sol0):
        return EmptyState()

    def step(sol, clock: Clock, state: EmptyState):
        t = clock.t
        k1 = calcN(sol, t)
        Eu = E(sol)
        k2 = calcN(Eu + 0.5 * dt * E(k1), t + 0.5 * dt)
        k3 = calcN(Eu + 0.5 * dt * k2, t + 0.5 * dt)
        E2u = E(Eu)
        k4 = calcN(E2u + dt * E(k3), t + dt)
        new = E2u + dt / 6.0 * (E(E(k1)) + 2.0 * E(k2 + k3) + k4)
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), state

    return init, step


# -----------------------------------------------------------------------------
# ETDRK4 (diagonal L only)
# -----------------------------------------------------------------------------

def _etdrk4_coeffs(L_diag: np.ndarray, dt: float, n_contour: int = 32):
    """Kassam-Trefethen contour evaluation of the phi-function coefficients,
    float64 on host."""
    Lh = np.asarray(L_diag).astype(np.complex128) * dt
    E = np.exp(Lh)
    E2 = np.exp(Lh / 2.0)
    M = n_contour
    r = np.exp(2j * np.pi * (np.arange(1, M + 1) - 0.5) / M)  # unit circle
    LR = Lh[..., None] + r  # broadcast contour points
    Q = dt * np.real(np.mean((np.exp(LR / 2.0) - 1.0) / LR, axis=-1))
    f1 = dt * np.real(
        np.mean((-4.0 - LR + np.exp(LR) * (4.0 - 3.0 * LR + LR**2)) / LR**3, axis=-1)
    )
    f2 = dt * np.real(
        np.mean((2.0 + LR + np.exp(LR) * (-2.0 + LR)) / LR**3, axis=-1)
    )
    f3 = dt * np.real(
        np.mean((-4.0 - 3.0 * LR - LR**2 + np.exp(LR) * (4.0 - LR)) / LR**3, axis=-1)
    )
    return E, E2, Q, f1, f2, f3


def make_etdrk4(
    L_diag: jax.Array,
    calcN: Callable[[jax.Array, jax.Array], jax.Array],
    dt: float,
    filt: jax.Array | None = None,
    dtype=jnp.complex64,
):
    """Cox-Matthews ETDRK4 for diagonal linear operators (the reference's
    FourierFlows "ETDRK4", default for Thomas-Yamada,
    thomasyamada/ThomasYamada.jl:62)."""
    E, E2, Q, f1, f2, f3 = _etdrk4_coeffs(np.asarray(L_diag), dt)
    # precision of the tables follows the precision of L
    double = np.asarray(L_diag).dtype in (np.float64, np.complex128)

    # real L gives real coefficients; keep real to save flops
    def cvt(a):
        a = np.asarray(a)
        if np.iscomplexobj(a) and np.max(np.abs(a.imag)) < 1e-14 * max(
            1.0, np.max(np.abs(a.real))
        ):
            a = a.real
        if np.iscomplexobj(a):
            return a.astype(np.complex128 if double else np.complex64)
        return jnp.asarray(a.astype(np.float64 if double else np.float32))

    E, E2, Q, f1, f2, f3 = map(cvt, (E, E2, Q, f1, f2, f3))
    filt = _as_filter(filt)

    def init(sol0):
        return EmptyState()

    def step(sol, clock: Clock, state: EmptyState):
        t = clock.t
        Nu = calcN(sol, t)
        a = E2 * sol + Q * Nu
        Na = calcN(a, t + dt / 2.0)
        b = E2 * sol + Q * Na
        Nb = calcN(b, t + dt / 2.0)
        c = E2 * a + Q * (2.0 * Nb - Nu)
        Nc = calcN(c, t + dt)
        new = E * sol + f1 * Nu + 2.0 * f2 * (Na + Nb) + f3 * Nc
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), state

    return init, step


# -----------------------------------------------------------------------------
# Classic filtered AB3 / RK4 on the full RHS (diagonal L)
# -----------------------------------------------------------------------------

def make_filtered_ab3(
    L: jax.Array,
    calcN: Callable[[jax.Array, jax.Array], jax.Array],
    dt: float,
    filt: jax.Array | None = None,
):
    """Classic 3rd-order Adams-Bashforth on RHS = L*sol + N with spectral
    filtering (GeophysicalFlows "FilteredAB3" semantics)."""
    filt = _as_filter(filt)

    def rhs(sol, t):
        return apply_L(L, sol) + calcN(sol, t)

    def init(sol0):
        # sol0 * 0: zeros on sol0's device, no complex constant transfer
        z = sol0 * 0
        return AB3State(z, z)

    def step(sol, clock: Clock, state: AB3State):
        R = rhs(sol, clock.t)

        def euler(_):
            return sol + dt * R

        def ab3(_):
            return sol + dt * (AB3_H1 * R - AB3_H2 * state.N1 + AB3_H3 * state.N2)

        new = jax.lax.cond(clock.step < 3, euler, ab3, None)
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), AB3State(R, state.N1)

    return init, step


def make_filtered_rk4(
    L: jax.Array,
    calcN: Callable[[jax.Array, jax.Array], jax.Array],
    dt: float,
    filt: jax.Array | None = None,
):
    """Classic RK4 on RHS = L*sol + N with spectral filtering
    (GeophysicalFlows "FilteredRK4" semantics)."""
    filt = _as_filter(filt)

    def rhs(sol, t):
        return apply_L(L, sol) + calcN(sol, t)

    def init(sol0):
        return EmptyState()

    def step(sol, clock: Clock, state: EmptyState):
        t = clock.t
        k1 = rhs(sol, t)
        k2 = rhs(sol + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = rhs(sol + 0.5 * dt * k2, t + 0.5 * dt)
        k4 = rhs(sol + dt * k3, t + dt)
        new = sol + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), state

    return init, step
