"""Batched WKB ray integration through evolving 2-D flows.

Rays obey (reference raytracing/Raytracing.jl:78-89):

    dx/dt =  u(x, t) + Cg^2 k / omega
    dk/dt = -(u_x k + v_x l)
    dl/dt = -(u_y k + v_y l),   with v_y = -u_x (incompressible flow)

The flow enters through 5 gridded fields stacked (5, ny, nx):
``[u, v, u_x, u_y, v_x]`` evaluated spectrally from a streamfunction
(core/spectral.spectral_gradients). Between two flow snapshots the fields
are blended linearly in time, u(t) = (1-a) u_old + a u_new with
a = (t - t0)/(t1 - t0). NOTE: the reference GPU kernel weights the *first*
texture set by a (raytracing/GPURaytracing.jl:33,52-64) while drivers pass
(old, new) — a time-reversed blend; we implement the intended physics and
pin it with a regression test (SURVEY.md §7 "hard parts").

Packets are structure-of-arrays. Two gather strategies, chosen by
``RayParams.gather``:

- ``"patch"`` (default, fast): once per (fields_old, fields_new) pair the
  flow fields are packed into per-cell *patch tables* (rays/patch.py) whose
  row c holds the full interpolation neighborhood of cell c for all 5
  fields. Each substep then costs ONE row-gather per packet for both time
  levels; every RK stage interpolates locally from the gathered patch.
  Because interpolation is linear in the patch values, the time blend is
  applied to the *interpolated results*, not the 80-wide rows. On GPU
  backends the RK4 substep and the adaptive DP5(4) attempt run as fused
  Pallas kernels (ops/pallas_ray_step) that gather their own taps.
- ``"taps"`` (reference semantics, slow): one global gather per tap per
  stage, blending full gridded field stacks — kept as the correctness
  oracle; the patch path is pinned to it by tests.

Substeps run under ``lax.scan``; everything is differentiable (row-gathers
transpose to scatter-adds).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.spectral import irfft2, spectral_gradients
from .dispersion import group_velocity
from .interp import bspline_prefilter_mask, interpolate
from .packets import Packets
from .patch import (
    PATCH_SHAPES,
    build_pair_table_direct,
    build_patch_table,
    patch_interpolate,
    patch_interpolate_pair,
    patch_interpolate_pair_shared,
)

__all__ = [
    "RayParams",
    "fields_from_psih",
    "fields_from_velocity_spectra",
    "raytrace",
    "raytrace_adaptive",
    "raytrace_tables",
    "raytrace_tables_fb",
    "resolve_gather",
    "sample_velocity",
    "sample_gradients",
]


class RayParams(NamedTuple):
    """Static ray-tracing parameters (python floats; close over them)."""

    f: float
    Cg: float
    x0: float      # grid origin (first node coordinate)
    y0: float
    dx: float
    dy: float
    interp: str = "bilinear"   # 'bilinear' | 'bspline' | 'bicubic'
    # 'patch' (fast) | 'taps' (oracle) | 'auto' (measured crossover,
    # resolved against (n_packets, grid) by resolve_gather below)
    gather: str = "patch"
    # implicit-midpoint convergence control (ray_method='midpoint'): the
    # fixed-point solve iterates until the residual drops below
    # atol + rtol*|z| (mixed norm) or maxit — a true converged implicit
    # solve like the reference's ImplicitMidpoint (Raytracing.jl:106-118),
    # not a fixed iteration count. Differentiable via lax.custom_root
    # (implicit function theorem), so convergence control costs nothing in
    # the backward pass.
    midpoint_rtol: float = 1e-6
    midpoint_maxit: int = 20
    # Storage dtype of the gathered pair table ('float32' | 'bfloat16').
    # bfloat16 halves the table's bytes and the bytes every gather moves
    # (bilinear pair row 640 -> 320 B). Stage math always upcasts to f32
    # after the gather, so the only error is ~2^-8 relative rounding of
    # the *stored field values*
    # (the reference's CUDA texture path instead stores f32 fields and
    # quantises the bilinear *weights* to 9-bit fixed point — a different
    # error model; raytracing/GPURaytracing.jl:118-127). Trajectory
    # divergence under bf16 tables is bounded by
    # tests/test_rays.py::test_bf16_table_trajectory_divergence. Default
    # keeps full f32 accuracy.
    table_dtype: str = "float32"


def _maybe_prefilter(stackh, grid, interp: str):
    if interp == "bspline":
        return stackh * bspline_prefilter_mask(grid)
    return stackh


def fields_from_psih(psih, grid, interp: str = "bilinear"):
    """Interpolation field stack from a streamfunction spectrum.

    Equivalent of the drivers' ``get_velocity_info`` 6-derivative extraction
    (swqg/RaytracingDriver.jl:164-185) done as one batched irfft2. For
    'bspline' interpolation the spectral B-spline prefilter is folded in
    here — exact and free (one elementwise multiply). For 'bicubic' (Hermite
    with exact corner derivatives, utils/CUDAInterpolations.jl:71-108) the
    stack is (20, ny, nx) = [f | fx | fy | fxy] of the 5 base fields, all
    exact spectral derivatives; otherwise (5, ny, nx) [u, v, ux, uy, vx].
    """
    uh, vh, uxh, uyh, vxh = spectral_gradients(psih, grid)
    stackh = jnp.stack([uh, vh, uxh, uyh, vxh])
    if interp == "bicubic":
        ik, il = grid.ik, grid.il
        stackh = jnp.concatenate(
            [stackh, ik * stackh, il * stackh, ik * il * stackh]
        )
        return irfft2(stackh, grid.nx)
    stackh = _maybe_prefilter(stackh, grid, interp)
    return irfft2(stackh, grid.nx)


def fields_from_velocity_spectra(uh, vh, grid, interp: str = "bilinear"):
    """Same field stack from explicit (uh, vh) — for flows not derived from a
    streamfunction. v_y is NOT assumed -u_x here; we still only store vx and
    rely on incompressibility downstream, so callers should pass the
    divergence-free (rotational) part."""
    ik, il = grid.ik, grid.il
    stackh = jnp.stack([uh, vh, ik * uh, il * uh, ik * vh])
    stackh = _maybe_prefilter(stackh, grid, interp)
    return irfft2(stackh, grid.nx)


def blend(fields_old, fields_new, a):
    """Linear time blend: a=0 -> old snapshot, a=1 -> new snapshot.

    This is the *intended* physics; the reference GPU kernel's alpha weights
    the first texture set, which drivers bind to the OLD field — a
    time-reversed blend (raytracing/GPURaytracing.jl:33,52-64). Pinned by
    tests/test_rays.py::test_time_blend_convention.
    """
    return (1.0 - a) * fields_old + a * fields_new


def _rhs(p: Packets, sample, a, rp: RayParams):
    """WKB ray RHS; ``sample(x, y, a) -> (5, N)`` interpolated fields at
    relative time a."""
    vals = sample(p.x, p.y, a)
    u, v, ux, uy, vx = vals[0], vals[1], vals[2], vals[3], vals[4]
    cgx, cgy = group_velocity(p.k, p.l, rp.f, rp.Cg, p.sign)
    dx = u + cgx
    dy = v + cgy
    dk = -(ux * p.k + vx * p.l)
    dl = -(uy * p.k - ux * p.l)  # vy = -ux
    return Packets(dx, dy, dk, dl, jnp.zeros_like(p.sign))


def _make_taps_sampler(fields_old, fields_new, rp: RayParams):
    """Global-gather sampler: blend full field stacks, one gather per call."""

    def sample(qx, qy, a):
        F = blend(fields_old, fields_new, a)
        return interpolate(F, qx, qy, rp.x0, rp.y0, rp.dx, rp.dy,
                           method=rp.interp)

    return sample


def _table_impl() -> str:
    """Pair-table build strategy, JRSW_TABLE_BUILD (read at trace time):
    'roll' (default): per-level roll/stack/transpose tables + a 2W concat;
    'conv': one patch-extraction convolution emitting the pair layout
    directly (patch.build_pair_table_direct), an opt-in with a simpler
    forward graph whose backward is a conv transpose."""
    import os

    return os.environ.get("JRSW_TABLE_BUILD", "roll")


def build_pair(fields_old, fields_new, rp: RayParams):
    """(old|new) pair table for the patch fast path (impl: _table_impl)."""
    if _table_impl() == "conv":
        return build_pair_table_direct(fields_old, fields_new, rp.interp,
                                       rp.table_dtype)
    return make_pair_table(build_patch_table(fields_old, rp.interp),
                           build_patch_table(fields_new, rp.interp),
                           rp.table_dtype)


def make_pair_table(T_old, T_new, dtype: str = "float32"):
    """Concatenate two per-snapshot patch tables into one (R, 2W) pair table
    so each substep costs ONE row-gather for both time levels.

    ``dtype='bfloat16'`` stores the pair table at half the bytes; consumers
    upcast the
    gathered rows to f32 before any stage math (see RayParams.table_dtype).
    """
    return jnp.concatenate([T_old, T_new], axis=1).astype(jnp.dtype(dtype))


def _gather_patch_rows(T_pair, p: Packets, rp: RayParams, ny: int, nx: int):
    """ONE row-gather (both time levels) at the packets' positions ->
    (rows f32, base-cell bx, by)."""
    fi_x = (p.x - rp.x0) / rp.dx
    fi_y = (p.y - rp.y0) / rp.dy
    bx = jnp.floor(fi_x)
    by = jnp.floor(fi_y)
    cell = (
        jnp.remainder(by.astype(jnp.int32), ny) * nx
        + jnp.remainder(bx.astype(jnp.int32), nx)
    )
    rows = jnp.take(T_pair, cell, axis=0).astype(jnp.float32)
    return rows, bx, by


def _patch_sampler_from_rows(rows, bx, by, rp: RayParams):
    """Sampler over pre-gathered pair rows: stages interpolate locally (VPU
    only) and blend the interpolated *values* in time (valid because
    interpolation is linear in the patch data)."""
    method = rp.interp
    ds = (rp.dx, rp.dy)   # derivative-channel scale (bicubic only)

    impl = _patch_impl()
    if impl == "mxu":
        # single-pass matmul form: tap reduction + time blend in one dot
        def sample(qx, qy, a):
            lx = (qx - rp.x0) / rp.dx - bx
            ly = (qy - rp.y0) / rp.dy - by
            return patch_interpolate_pair(rows, lx, ly, a, method=method,
                                          deriv_scale=ds)

        return sample

    if impl == "pairsplit":
        # one pass over the pair rows with the weights built once
        def sample(qx, qy, a):
            lx = (qx - rp.x0) / rp.dx - bx
            ly = (qy - rp.y0) / rp.dy - by
            return patch_interpolate_pair_shared(rows, lx, ly, a,
                                                 method=method,
                                                 deriv_scale=ds)

        return sample

    W = rows.shape[1] // 2
    rows_old, rows_new = rows[:, :W], rows[:, W:]

    def sample(qx, qy, a):
        lx = (qx - rp.x0) / rp.dx - bx
        ly = (qy - rp.y0) / rp.dy - by
        vo = patch_interpolate(rows_old, lx, ly, method=method, deriv_scale=ds)
        vn = patch_interpolate(rows_new, lx, ly, method=method, deriv_scale=ds)
        return (1.0 - a) * vo + a * vn

    return sample


def _make_patch_sampler(T_pair, p: Packets, rp: RayParams, ny: int, nx: int):
    """Gather + sampler in one call (the fixed-step substep path)."""
    rows, bx, by = _gather_patch_rows(T_pair, p, rp, ny, nx)
    return _patch_sampler_from_rows(rows, bx, by, rp)


def _axpy(p: Packets, d: Packets, h):
    return Packets(p.x + h * d.x, p.y + h * d.y, p.k + h * d.k, p.l + h * d.l, p.sign)


def _lincomb(p: Packets, ds, ws, h):
    acc = [jnp.zeros_like(p.x)] * 4
    for d, w in zip(ds, ws):
        acc[0] = acc[0] + w * d.x
        acc[1] = acc[1] + w * d.y
        acc[2] = acc[2] + w * d.k
        acc[3] = acc[3] + w * d.l
    return Packets(
        p.x + h * acc[0], p.y + h * acc[1], p.k + h * acc[2], p.l + h * acc[3], p.sign
    )


# Dormand-Prince 5(4) tableau (fixed-step use)
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
# embedded 4th-order weights of the Dormand-Prince pair (error estimator)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)

# Fehlberg 7(8) tableau — the Vern7-accuracy-class adaptive option
# (reference production GPU path solves with adaptive Vern7,
# raytracing/GPURaytracing.jl:111-113; Verner's coefficients are long
# decimals, Fehlberg's classical 13-stage 7(8) pair is exactly rational and
# the same order class). 7th-order solution propagated, 8th-order for the
# error estimate; order pinned by tests/test_adaptive_rays.py convergence.
_F78_C = (0.0, 2 / 27, 1 / 9, 1 / 6, 5 / 12, 1 / 2, 5 / 6, 1 / 6, 2 / 3,
          1 / 3, 1.0, 0.0, 1.0)
_F78_A = (
    (),
    (2 / 27,),
    (1 / 36, 1 / 12),
    (1 / 24, 0.0, 1 / 8),
    (5 / 12, 0.0, -25 / 16, 25 / 16),
    (1 / 20, 0.0, 0.0, 1 / 4, 1 / 5),
    (-25 / 108, 0.0, 0.0, 125 / 108, -65 / 27, 125 / 54),
    (31 / 300, 0.0, 0.0, 0.0, 61 / 225, -2 / 9, 13 / 900),
    (2.0, 0.0, 0.0, -53 / 6, 704 / 45, -107 / 9, 67 / 90, 3.0),
    (-91 / 108, 0.0, 0.0, 23 / 108, -976 / 135, 311 / 54, -19 / 60, 17 / 6,
     -1 / 12),
    (2383 / 4100, 0.0, 0.0, -341 / 164, 4496 / 1025, -301 / 82, 2133 / 4100,
     45 / 82, 45 / 164, 18 / 41),
    (3 / 205, 0.0, 0.0, 0.0, 0.0, -6 / 41, -3 / 205, -3 / 41, 3 / 41, 6 / 41,
     0.0),
    (-1777 / 4100, 0.0, 0.0, -341 / 164, 4496 / 1025, -289 / 82, 2193 / 4100,
     51 / 82, 33 / 164, 12 / 41, 0.0, 1.0),
)
_F78_B7 = (41 / 840, 0.0, 0.0, 0.0, 0.0, 34 / 105, 9 / 35, 9 / 35, 9 / 280,
           9 / 280, 41 / 840, 0.0, 0.0)
_F78_B8 = (0.0, 0.0, 0.0, 0.0, 0.0, 34 / 105, 9 / 35, 9 / 35, 9 / 280,
           9 / 280, 0.0, 41 / 840, 41 / 840)

# name -> (C, A, propagated weights, error weights bh-bl, 1/(order+1) exp)
_EMBEDDED_PAIRS = {
    "dopri5": (_DP_C, _DP_A, _DP_B,
               tuple(b - b4 for b, b4 in zip(_DP_B, _DP_B4)), 0.2),
    "rkf78": (_F78_C, _F78_A, _F78_B7,
              tuple(b8 - b7 for b7, b8 in zip(_F78_B7, _F78_B8)), 0.125),
}


def _step(p: Packets, sample, a0, da, h, rp: RayParams, method: str):
    """One substep from relative time a0 (in [0,1] units of the flow step);
    da = h / (t1 - t0). ``sample(x, y, a)`` interpolates the 5 fields."""
    if method == "rk4":
        k1 = _rhs(p, sample, a0, rp)
        k2 = _rhs(_axpy(p, k1, 0.5 * h), sample, a0 + 0.5 * da, rp)
        k3 = _rhs(_axpy(p, k2, 0.5 * h), sample, a0 + 0.5 * da, rp)
        k4 = _rhs(_axpy(p, k3, h), sample, a0 + da, rp)
        return _lincomb(p, (k1, k2, k3, k4), (1 / 6, 1 / 3, 1 / 3, 1 / 6), h)
    if method == "dopri5":
        ks = []
        for ci, ai in zip(_DP_C, _DP_A):
            q = _lincomb(p, ks, ai, h) if ai else p
            ks.append(_rhs(q, sample, a0 + ci * da, rp))
        return _lincomb(p, ks, _DP_B, h)
    if method == "midpoint":
        # implicit midpoint (symplectic; the reference CPU path solves a
        # true implicit system, raytracing/Raytracing.jl:106-118). Solved
        # as a CONVERGED fixed point on the midpoint slope z = G(z) with a
        # residual-controlled while_loop, wrapped in lax.custom_root so the
        # backward pass uses implicit differentiation (a Neumann-series
        # tangent solve) instead of unrolling iterations.
        am = a0 + 0.5 * da
        rtol = rp.midpoint_rtol
        maxit = rp.midpoint_maxit

        def G(z):
            mid = Packets(p.x + 0.5 * h * z[0], p.y + 0.5 * h * z[1],
                          p.k + 0.5 * h * z[2], p.l + 0.5 * h * z[3], p.sign)
            d = _rhs(mid, sample, am, rp)
            return (d.x, d.y, d.k, d.l)

        def f_root(z):
            gz = G(z)
            return tuple(a - b for a, b in zip(z, gz))

        def _resid(fz, z):
            r = 0.0
            for e, zi in zip(fz, z):
                sc = 1e-8 + rtol * jnp.abs(zi)
                r = jnp.maximum(r, jnp.max(jnp.abs(e) / sc))
            return r

        def solve(f_, z0):
            # carry (z, f(z)) so the RHS is evaluated ONCE per iteration
            # (cond reads the carried residual; body computes the next)
            def cond(c):
                z, fz, i = c
                return jnp.logical_and(_resid(fz, z) > 1.0, i < maxit)

            def body(c):
                z, fz, i = c
                z_new = tuple(a - b for a, b in zip(z, fz))
                return z_new, f_(z_new), i + 1

            z, _, _ = jax.lax.while_loop(
                cond, body, (z0, f_(z0), jnp.int32(0)))
            return z

        def tangent_solve(g, y):
            # g(z) = z - J z is linear with ||J|| = O(h |grad u|) << 1;
            # Neumann iteration z <- y + J z converges geometrically
            z = y
            for _ in range(8):
                jz = tuple(a - b for a, b in zip(z, g(z)))
                z = tuple(a + b for a, b in zip(y, jz))
            return z

        d0 = _rhs(p, sample, am, rp)
        z = jax.lax.custom_root(f_root, (d0.x, d0.y, d0.k, d0.l),
                                solve, tangent_solve)
        return Packets(p.x + h * z[0], p.y + h * z[1], p.k + h * z[2],
                       p.l + h * z[3], p.sign)
    raise ValueError(f"unknown ray integrator {method!r}")


def _use_patch(rp: RayParams) -> bool:
    return rp.gather == "patch" and rp.interp in PATCH_SHAPES


# Patch-vs-taps crossover: the patch path pays a GRID-sized table build per
# flow step but its per-substep cost is one N-row gather; the taps path is
# grid-build-free but pays per-stage tap gathers + full-field blends.
# patch iff CROSSOVER * n_packets >= grid cells. The constant was fitted on
# earlier hardware (512^2 + 1M and + 262k packets -> patch; 2048^2 + 262k
# and 512^2 + 16k gradients -> taps) and is not yet measured on the H100.
PATCH_TAPS_CROSSOVER = 8


def resolve_gather(rp: RayParams, n_packets: int, ny: int, nx: int) -> RayParams:
    """Replace ``gather='auto'`` with the measured-crossover concrete mode
    (patch for ensemble-dominated runs, taps when the grid dwarfs the
    ensemble). No-op for explicit 'patch'/'taps'."""
    if rp.gather != "auto":
        return rp
    use_patch = (rp.interp in PATCH_SHAPES
                 and PATCH_TAPS_CROSSOVER * int(n_packets) >= ny * nx)
    return rp._replace(gather="patch" if use_patch else "taps")


def _patch_impl() -> str:
    """Stage-math formulation for the patch sampler, JRSW_PATCH_IMPL:
    'pairsplit' (default): one (N,2,F,ph,pw) pass over the pair rows with
    the separable weight matrices built ONCE per stage and shared between
    the two time levels (patch_interpolate_pair_shared);
    'split': per-time-level (N,F,ph,pw) broadcast reduction (kept as the
    oracle);
    'mxu': single-pass rows*(tiled weights) @ blend-selector matmul
    (rays/patch.patch_interpolate_pair). Read at trace time."""
    import os

    return os.environ.get("JRSW_PATCH_IMPL", "pairsplit")


def _use_fused(rp: RayParams, interpret: bool = False) -> bool:
    """Whether the patch path runs the fused Pallas kernels
    (ops/pallas_ray_step): on GPU backends, for the interpolations that
    have one (bilinear, bspline; bicubic measured faster on the plain
    path), unless JRSW_FUSED=off (read at trace time; 'auto' is the
    default). Other backends run the plain per-stage path. ``interpret=True`` runs
    the kernels in the Pallas interpreter on any backend (tests). On a GPU
    a kernel that fails to compile is an error, never a silent switch."""
    import os

    from ..ops.pallas_ray_step import FUSED_INTERPS

    mode = os.environ.get("JRSW_FUSED", "auto")
    if mode not in ("auto", "off"):
        raise ValueError(f"JRSW_FUSED={mode!r}: expected 'auto' or 'off'")
    return (mode == "auto" and rp.interp in FUSED_INTERPS
            and (interpret or jax.default_backend() == "gpu"))


def _raytrace_taps(packets, fields_old, fields_new, t0, t1, rp: RayParams,
                   nsubsteps: int, method: str):
    """Reference-semantics path: one global tap-gather per stage from the
    time-blended field stacks (the correctness oracle; also the backward
    formulation of the fast path, see raytrace_tables_fb)."""
    h = (t1 - t0) / nsubsteps
    da = 1.0 / nsubsteps
    sample = _make_taps_sampler(fields_old, fields_new, rp)

    def body(p, i):
        return _step(p, sample, i * da, da, h, rp, method), None

    packets, _ = jax.lax.scan(
        body, packets, jnp.arange(nsubsteps, dtype=fields_old.dtype)
    )
    return packets


def _patch_bwd_impl() -> str:
    """Backward formulation for the patch fast path, JRSW_PATCH_BWD (read at
    trace time): 'table' (default) | 'taps'.

    - 'table' (default): plain AD transpose of gather+build — ONE N-row
      scatter-add into the (ny*nx, 2W) table per substep plus field-sized
      roll/concat transposes.
    - 'taps' (opt-in): custom VJP whose backward re-interpolates directly
      from the field stacks (raytrace_tables_fb). Cost ~ N x taps x stages
      scattered gathers + scatter-adds per pass, and under remat it pays
      the patch forward recompute PLUS a taps linearization.

    For small-ensemble long-horizon gradients ``RayParams(gather='taps')``
    end-to-end (taps forward AND backward) avoids the patch path's
    grid-sized table rebuild per step. Neither choice is yet measured on
    the H100."""
    import os

    return os.environ.get("JRSW_PATCH_BWD", "table")


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4))
def _raytrace_patch_fb(rp, ny, nx, nsubsteps, method,
                       packets, T_pair, fields_old, fields_new, t0, t1):
    """Patch-table forward with a taps-formulation backward.

    Primal: identical to raytrace_tables (one row-gather per substep, local
    stage math). Backward: linearize the mathematically-identical taps
    path at the same inputs — interpolating gradients directly from the
    field stacks instead of transposing the table build + row gather. All
    cotangent flows through (packets, fields_old, fields_new, t0, t1);
    T_pair (a deterministic function of the fields) gets zero cotangent so
    nothing is double-counted. Validity bound: patch and taps differ only
    by FP association and the patch clamp for packets drifting >1 cell per
    substep (CFL-guarded); gradient agreement is pinned by
    tests/test_gradients.py."""
    return _raytrace_tables_impl(packets, T_pair, t0, t1, rp, ny, nx,
                                 nsubsteps, method)


def _raytrace_patch_fb_fwd(rp, ny, nx, nsubsteps, method,
                           packets, T_pair, fields_old, fields_new, t0, t1):
    out = _raytrace_tables_impl(packets, T_pair, t0, t1, rp, ny, nx,
                                nsubsteps, method)
    return out, (packets, fields_old, fields_new, t0, t1)


def _raytrace_patch_fb_bwd(rp, ny, nx, nsubsteps, method, res, ct):
    packets, fields_old, fields_new, t0, t1 = res
    _, vjp = jax.vjp(
        lambda p, fo, fn, a, b: _raytrace_taps(p, fo, fn, a, b, rp,
                                               nsubsteps, method),
        packets, fields_old, fields_new, t0, t1,
    )
    d_p, d_fo, d_fn, d_t0, d_t1 = vjp(ct)
    # zero cotangent for the (derived) pair table, reconstructed by shape
    ph, pw, _ = PATCH_SHAPES[rp.interp]
    W = fields_old.shape[0] * ph * pw
    d_T = jnp.zeros((ny * nx, 2 * W), jnp.dtype(rp.table_dtype))
    return d_p, d_T, d_fo, d_fn, d_t0, d_t1


_raytrace_patch_fb.defvjp(_raytrace_patch_fb_fwd, _raytrace_patch_fb_bwd)


@partial(jax.jit, static_argnames=("nsubsteps", "method", "rp", "ny", "nx"))
def raytrace_tables_fb(
    packets: Packets,
    T_pair,
    fields_old,
    fields_new,
    t0,
    t1,
    rp: RayParams,
    ny: int,
    nx: int,
    nsubsteps: int = 1,
    method: str = "rk4",
) -> Packets:
    """raytrace_tables with a selectable backward (see _patch_bwd_impl):
    the default AD table transpose, or the opt-in taps custom VJP that
    re-interpolates gradients from the field stacks. Use when the
    (old, new) field stacks are at hand — the coupled frame always has
    them."""
    if _patch_bwd_impl() == "taps":
        return _raytrace_patch_fb(rp, ny, nx, nsubsteps, method,
                                  packets, T_pair, fields_old, fields_new,
                                  t0, t1)
    return _raytrace_tables_impl(packets, T_pair, t0, t1, rp, ny, nx,
                                 nsubsteps, method)


@partial(jax.jit, static_argnames=("nsubsteps", "method", "rp", "ny", "nx",
                                   "interpret"))
def raytrace_tables(
    packets: Packets,
    T_pair,
    t0,
    t1,
    rp: RayParams,
    ny: int,
    nx: int,
    nsubsteps: int = 1,
    method: str = "rk4",
    interpret: bool = False,
) -> Packets:
    """Patch-table fast path: advance packets through a pre-built (old|new)
    pair table (see rays/patch.build_patch_table + make_pair_table). Used by
    the coupled frame so the per-snapshot table build is amortised over all
    substeps/flow steps.

    For RK4 on GPU backends the whole substep runs through the fused
    Pallas kernel (ops/pallas_ray_step), which gathers its own taps and
    keeps all stages in registers; the plain sampler instead writes the
    gathered rows to device memory and re-reads them once per stage x
    time level. JRSW_FUSED=off restores the per-stage path everywhere;
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests)."""
    return _raytrace_tables_impl(packets, T_pair, t0, t1, rp, ny, nx,
                                 nsubsteps, method, interpret)


def _ray_chunk() -> int:
    """Packet-chunked stage math, JRSW_RAY_CHUNK (read at trace time).

    Unchunked (0), each substep runs over the whole packet batch and the
    gathered (N, 2W) rows become a device-memory intermediate that every
    RK stage re-reads (8 row passes per RK4 substep x time level). A chunk
    size c > 0 wraps the substep in ``lax.map`` over N/c packet chunks so
    each chunk's rows (c x 2W) are a smaller working set.

    Default 65536. On the H100 (1M-packet hero frame) neither 0 nor 65536
    wins for every interpolation, and on GPUs the fused kernels replace
    this path anyway. If N is not divisible by the chunk, successive
    halvings are tried; small batches (N <= c) stay unchunked.
    JRSW_RAY_CHUNK=0 disables."""
    import os

    return int(os.environ.get("JRSW_RAY_CHUNK", "65536"))


def _pick_chunk(n: int, csize: int) -> int:
    """Largest divisor of n among csize, csize/2, ... csize/8 (0 = none)."""
    c = csize
    while c > 0 and (n <= c or n % c):
        c //= 2
        if c < csize // 8:
            return 0
    return c if c > 0 else 0


def _raytrace_tables_impl(packets, T_pair, t0, t1, rp: RayParams,
                          ny: int, nx: int, nsubsteps: int, method: str,
                          interpret: bool = False):
    h = (t1 - t0) / nsubsteps
    da = 1.0 / nsubsteps

    if method == "rk4" and _use_fused(rp, interpret):
        from ..ops.pallas_ray_step import make_fused_substep

        fused = make_fused_substep(rp, da, ny, nx, interpret=interpret)

        def body(p, i):
            scal = jnp.stack([i * da, jnp.asarray(h, p.x.dtype)])
            out = fused(T_pair, p.x, p.y, p.k, p.l, p.sign, scal)
            return Packets(*out, p.sign), None
    else:
        n = packets.x.shape[0]
        csize = _pick_chunk(n, _ray_chunk()) if _ray_chunk() else 0
        if csize:
            nchunks = n // csize

            def body(p, i):
                a0 = i * da

                def one_chunk(pc):
                    sample = _make_patch_sampler(T_pair, pc, rp, ny, nx)
                    return _step(pc, sample, a0, da, h, rp, method)

                pr = jax.tree_util.tree_map(
                    lambda a: a.reshape(nchunks, csize), p)
                out = jax.lax.map(one_chunk, pr)
                return jax.tree_util.tree_map(
                    lambda a: a.reshape(-1), out), None
        else:
            def body(p, i):
                a0 = i * da
                sample = _make_patch_sampler(T_pair, p, rp, ny, nx)
                return _step(p, sample, a0, da, h, rp, method), None

    packets, _ = jax.lax.scan(
        body, packets, jnp.arange(nsubsteps, dtype=packets.x.dtype)
    )
    return packets


@partial(jax.jit, static_argnames=("nsubsteps", "method", "rp"))
def raytrace(
    packets: Packets,
    fields_old,
    fields_new,
    t0,
    t1,
    rp: RayParams,
    nsubsteps: int = 1,
    method: str = "rk4",
) -> Packets:
    """Advance packets from t0 to t1 through linearly-blended flow fields.

    Equivalent of the reference ``raytrace!`` (raytracing/GPURaytracing.jl:115-142)
    with fixed substeps in place of adaptive Vern7 (SURVEY.md §7 stance;
    the embedded adaptive mode lives in raytrace_adaptive below).
    """
    _, ny, nx = fields_old.shape
    rp = resolve_gather(rp, packets.x.shape[0], ny, nx)
    if _use_patch(rp):
        T_pair = build_pair(fields_old, fields_new, rp)
        return raytrace_tables_fb(packets, T_pair, fields_old, fields_new,
                                  t0, t1, rp, ny, nx, nsubsteps, method)
    return _raytrace_taps(packets, fields_old, fields_new, t0, t1, rp,
                          nsubsteps, method)


def _select_channels(fields, sel, interp):
    """Slice base channels from a field stack; for the bicubic [f|fx|fy|fxy]
    layout the selection is applied within each of the 4 blocks."""
    if interp == "bicubic":
        F = fields.shape[0] // 4
        idx = [b * F + j for b in range(4) for j in sel]
        return fields[jnp.asarray(idx)]
    return fields[jnp.asarray(sel)]


@partial(jax.jit, static_argnames=("rp", "max_steps", "pair", "loop",
                                   "interpret"))
def raytrace_adaptive(
    packets: Packets,
    fields_old,
    fields_new,
    t0,
    t1,
    rp: RayParams,
    rtol: float = 1e-5,
    atol: float = 1e-7,
    max_steps: int = 64,
    init_substeps: int = 4,
    pair: str = "dopri5",
    loop: str = "scan",
    interpret: bool = False,
):
    """Adaptive embedded ray integration: Dormand-Prince 5(4) (default) or
    Fehlberg 7(8) (``pair='rkf78'``, 13 stages — the accuracy class of the
    reference's production adaptive Vern7 path).

    Parity mode for the reference's production GPU path — adaptive Vern7
    over the whole packet batch with one shared step size
    (raytracing/GPURaytracing.jl:111-113,135-137 solves a single batched
    ODEProblem adaptively). Shape-static for XLA: a ``lax.scan`` over
    ``max_steps`` attempt slots; rejected attempts shrink h and retry,
    finished batches no-op. Error control is the standard Hairer mixed
    norm with a PI-less step factor 0.9 (tol/err)^(1/(q+1)) clipped to
    [0.2, 5].

    Returns ``(packets, info)`` where info = dict(t_reached, h_final,
    n_accepted, n_rejected); ``t_reached < t1`` means max_steps was too
    small for the tolerance.

    ``loop='while'`` replaces the fixed-length scan with a
    ``lax.while_loop`` that exits as soon as the shared clock reaches t1 —
    finished attempt slots cost nothing instead of running max_steps no-op
    attempts. Forward-only (while_loop is not reverse-differentiable):
    production throughput mode; keep ``loop='scan'`` under ``jax.grad``.
    With ``pair='dopri5'`` on the patch path each attempt runs as one fused
    Pallas kernel on GPU backends (see _use_fused; ``interpret`` as there).
    """
    _, ny, nx = fields_old.shape
    rp = resolve_gather(rp, packets.x.shape[0], ny, nx)
    span = t1 - t0
    use_patch = _use_patch(rp)
    if use_patch:
        T_pair = build_pair(fields_old, fields_new, rp)
    C, A, BH, BE, exponent = _EMBEDDED_PAIRS[pair]
    fused_att = None
    if (use_patch and loop == "while" and pair == "dopri5"
            and _use_fused(rp, interpret)):
        from ..ops.pallas_ray_step import make_fused_attempt

        fused_att = make_fused_attempt(rp, ny, nx, interpret=interpret)
    # the fused kernel gathers its own taps, so only the plain patch path
    # carries gathered rows between attempts
    carry_rows = use_patch and fused_att is None

    def attempt(p, t, h, sample):
        """One embedded-pair attempt from (p, t) with size h ->
        (p_hi, sum of squared scaled component errors) — the caller turns
        the sum into the Hairer mixed norm, so chunked partial sums
        combine exactly."""
        a0 = (t - t0) / span
        dah = h / span
        ks = []
        for ci, ai in zip(C, A):
            q = _lincomb(p, ks, ai, h) if ai else p
            ks.append(_rhs(q, sample, a0 + ci * dah, rp))
        p5 = _lincomb(p, ks, BH, h)
        # error = h * sum (b_hi - b_lo)_i k_i, componentwise
        zero = Packets(*(jnp.zeros_like(p.x),) * 4, p.sign)
        pe = _lincomb(zero, ks, BE, h)

        def comp_err(e, y5, y):
            sc = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y5))
            return (e / sc) ** 2

        e = (comp_err(pe.x, p5.x, p.x) + comp_err(pe.y, p5.y, p.y)
             + comp_err(pe.k, p5.k, p.k) + comp_err(pe.l, p5.l, p.l))
        return p5, jnp.sum(e)

    n_total = packets.x.shape[0]

    def _err_norm(e_sum):
        return jnp.sqrt(e_sum / (4.0 * n_total))

    csize = (_pick_chunk(n_total, _ray_chunk()) if (carry_rows and
                                                    _ray_chunk()) else 0)
    eps = 1e-9 * jnp.abs(span)

    def body(carry, _):
        p, t, h, nacc, nrej, gathered = carry
        done = t >= t1 - eps
        h_eff = jnp.minimum(h, t1 - t)
        if carry_rows:
            # rejected slots retry from UNCHANGED positions, so the rows
            # gathered for the previous attempt are still exact — only
            # re-gather after an accepted step (no duplicate 1M-row
            # gathers at high rejection rates). The `moved` carry flag
            # drives a true XLA conditional.
            rows, bx, by, moved = gathered
            rows, bx, by = jax.lax.cond(
                moved,
                lambda _: _gather_patch_rows(T_pair, p, rp, ny, nx),
                lambda _: (rows, bx, by),
                None,
            )
            sample = _patch_sampler_from_rows(rows, bx, by, rp)
        elif fused_att is None:
            sample = _make_taps_sampler(fields_old, fields_new, rp)
        h_att = jnp.where(done, h, h_eff)
        if fused_att is not None:
            # fused 7-stage attempt kernel: taps gathered in-kernel, all
            # stages AND the error estimate in registers; per-packet
            # squared-error partial sums come back as the 5th output
            scal = jnp.stack([
                (t - t0) / span, h_att / span, h_att,
                jnp.asarray(rtol, p.x.dtype), jnp.asarray(atol, p.x.dtype)])
            *xykl, esq = fused_att(T_pair, p.x, p.y, p.k, p.l, p.sign, scal)
            p5 = Packets(*xykl, p.sign)
            err = _err_norm(jnp.sum(esq))
        elif csize:
            # packet-chunked attempt (same lever as the fixed-substep path,
            # _ray_chunk): the 7/13-stage math runs per packet chunk; the
            # squared-error partial sums combine into the exact batch norm
            nchunks = n_total // csize

            def one_chunk(args):
                p_c, rows_c, bx_c, by_c = args
                s_c = _patch_sampler_from_rows(rows_c, bx_c, by_c, rp)
                return attempt(p_c, t, h_att, s_c)

            pr = jax.tree_util.tree_map(
                lambda a: a.reshape(nchunks, csize), p)
            p5r, e_sums = jax.lax.map(one_chunk, (
                pr, rows.reshape(nchunks, csize, -1),
                bx.reshape(nchunks, csize), by.reshape(nchunks, csize)))
            p5 = jax.tree_util.tree_map(lambda a: a.reshape(-1), p5r)
            err = _err_norm(jnp.sum(e_sums))
        else:
            p5, e_sum = attempt(p, t, h_att, sample)
            err = _err_norm(e_sum)
        accept = jnp.logical_and(err <= 1.0, jnp.logical_not(done))
        reject = jnp.logical_and(err > 1.0, jnp.logical_not(done))
        p_next = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), p5, p
        )
        t_next = jnp.where(accept, t + h_eff, t)
        fac = jnp.clip(0.9 * (jnp.maximum(err, 1e-10)) ** (-exponent),
                       0.2, 5.0)
        h_next = jnp.where(done, h, jnp.maximum(h_eff * fac, eps))
        if carry_rows:
            gathered = (rows, bx, by, accept)
        return (p_next, t_next, h_next,
                nacc + accept.astype(jnp.int32),
                nrej + reject.astype(jnp.int32), gathered), None

    t0_ = jnp.asarray(t0, packets.x.dtype)
    h0 = jnp.asarray(span / init_substeps, packets.x.dtype)
    zero = jnp.zeros((), jnp.int32)
    if carry_rows:
        W2 = T_pair.shape[1]
        g0 = (jnp.zeros((packets.x.shape[0], W2), jnp.float32),
              jnp.zeros_like(packets.x), jnp.zeros_like(packets.y),
              jnp.asarray(True))
    else:
        g0 = ()
    carry0 = (packets, t0_, h0, zero, zero, g0)
    if loop == "while":
        def cond(state):
            carry, slots = state
            return jnp.logical_and(carry[1] < t1 - eps, slots < max_steps)

        def wbody(state):
            carry, slots = state
            carry, _ = body(carry, None)
            return carry, slots + 1

        (p, t, h, nacc, nrej, _), _ = jax.lax.while_loop(
            cond, wbody, (carry0, jnp.int32(0)))
    else:
        (p, t, h, nacc, nrej, _), _ = jax.lax.scan(
            body, carry0, None, length=max_steps
        )
    return p, dict(t_reached=t, h_final=h, n_accepted=nacc, n_rejected=nrej)


def sample_velocity(packets: Packets, fields, rp: RayParams):
    """(u, v) at packet positions (reference interpolate_velocity!,
    raytracing/GPURaytracing.jl:67-82)."""
    vals = interpolate(
        _select_channels(fields, [0, 1], rp.interp),
        packets.x, packets.y, rp.x0, rp.y0, rp.dx, rp.dy, rp.interp
    )
    return vals[0], vals[1]


def sample_gradients(packets: Packets, fields, rp: RayParams):
    """(ux, uy, vx, vy) at packet positions (reference
    interpolate_gradients!, raytracing/GPURaytracing.jl:84-109); vy = -ux."""
    vals = interpolate(
        _select_channels(fields, [2, 3, 4], rp.interp),
        packets.x, packets.y, rp.x0, rp.y0, rp.dx, rp.dy, rp.interp
    )
    return vals[0], vals[1], vals[2], -vals[0]
