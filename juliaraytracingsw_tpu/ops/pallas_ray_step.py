"""Fused ray-substep kernels for the patch-table ray path (Pallas, Triton).

The plain patch path (rays/patch.py + rays/raytrace.raytrace_tables) splits
one substep into a row-gather from the packed (old|new) pair table, which
writes the gathered ``(N, 2W)`` rows to device memory, and the RK stage
math, which re-reads those rows once per stage and time level. These
kernels fuse both, the way the reference's texture RHS does
(raytracing/GPURaytracing.jl:32-65): each program takes a block of
packets, computes its own packets' cell indices, loads each packet's patch
straight from the pair table by cell index (one vector load per channel
and time level: a (B, n) tile of contiguous row columns), and runs all RK
stages in registers. Only the updated packet components leave the kernel.

Kernels exist for ``FUSED_INTERPS`` (bilinear, bspline). Bicubic's
20-channel corner-data rows run the plain path: a fused bicubic kernel
measured slower end to end on the H100 than the plain path (PERF.md).

- ``make_fused_substep``: one RK4 substep -> ``(x', y', k', l')``.
- ``make_fused_attempt``: one embedded Dormand-Prince 5(4) attempt (the
  adaptive ``loop='while'`` path) -> ``(x5, y5, k5, l5, err)`` where
  ``err`` is the per-packet sum of squared scaled component errors.

Both take ``(T_pair, x, y, k, l, sign, scal)`` with packet components as
``(N,)`` vectors and the traced scalars in ``scal``. ``N`` is padded to a
whole number of blocks here and the padding is sliced off again.

Differentiation: ``make_fused_substep`` carries a custom VJP whose backward
linearises the plain per-stage formulation (rays/raytrace._step over a
row-gather sampler), so gradients flow into the pair table exactly as on
the plain path. The attempt kernel is forward-only (``loop='while'`` is not
reverse-differentiable).

Weight formulas mirror rays/patch.py (same clips, same tap layout index
``o*W + f*ph*pw + jy*pw + jx``); ``substep_jnp`` / ``attempt_jnp`` run the
identical stage code on a plain ``jnp.take`` of the rows and pin the
kernels in tests. ``interpret=True`` runs a kernel in the Pallas
interpreter, for tests on hosts without a GPU.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..rays.patch import PATCH_SHAPES

__all__ = ["FUSED_INTERPS", "attempt_jnp", "make_fused_attempt",
           "make_fused_substep", "substep_jnp"]

FUSED_INTERPS = ("bilinear", "bspline")

_RK4_STAGES = ((0.0, ()), (0.5, (0.5,)), (0.5, (0.0, 0.5)),
               (1.0, (0.0, 0.0, 1.0)))
_RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)

# packets and warps per program of the Triton kernels (64/2 and 256/8
# time the same on the H100 bilinear substep)
BLOCK = 128
NUM_WARPS = 4


def _pieces(n: int):
    """Power-of-two column pieces (offset, width) covering [0, n): Triton
    tiles must have power-of-two sizes (36 = 32 + 4 for bspline)."""
    out, off = [], 0
    for b in reversed(range(n.bit_length())):
        if n >> b & 1:
            out.append((off, 1 << b))
            off += 1 << b
    return tuple(out)


def _tap_coords(off, n, pw):
    """(jy, jx) patch coordinates of row columns [off, off+n) as (1, n)."""
    j = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1) + off
    return (j // pw).astype(jnp.float32), (j % pw).astype(jnp.float32)


def _axis_weight_fn(local, size, lo, interp):
    """``w(jc)``: weights of tap coordinates ``jc`` (1, n) for (B, 1) local
    offsets — rays/patch._axis_weights_* (same clips) as a function of the
    tap coordinate, so a whole (B, n) weight tile is built at once."""
    if interp == "bilinear":
        j0 = jnp.clip(jnp.floor(local), -float(lo), float(size - lo - 2))
        a = local - j0
        t = j0 + lo
        return lambda jc: (jnp.where(jc == t, 1.0 - a, 0.0)
                           + jnp.where(jc == t + 1.0, a, 0.0))
    if interp == "bspline":
        j0 = jnp.clip(jnp.floor(local), -float(lo - 1), float(size - lo - 3))
        a = local - j0
        a2, a3 = a * a, a * a * a
        w4 = ((1.0 - 3.0 * a + 3.0 * a2 - a3) / 6.0,
              (4.0 - 6.0 * a2 + 3.0 * a3) / 6.0,
              (1.0 + 3.0 * a + 3.0 * a2 - 3.0 * a3) / 6.0,
              a3 / 6.0)
        base = j0 + (lo - 1)

        def w(jc):
            out = jnp.where(jc == base, w4[0], 0.0)
            for s_ in range(1, 4):
                out = out + jnp.where(jc == base + float(s_), w4[s_], 0.0)
            return out

        return w
    raise ValueError(f"unsupported fused interp {interp!r}")


def _make_sample(read_block, cfg, interp):
    """``sample(qx, qy, a) -> 5 field values`` reading each channel's patch
    as (B, n) tiles: ``read_block(start, n)`` returns row columns
    [start, start+n) of every packet (a vector load per packet in the
    kernel, a static slice of gathered rows in the twin)."""
    ph, pw, lo, W, dxg, dyg, f, Cg = cfg
    npp = ph * pw
    pieces = _pieces(npp)

    def sample(qx, qy, a):
        wy = _axis_weight_fn((qy / dyg)[:, None], ph, lo, interp)
        wx = _axis_weight_fn((qx / dxg)[:, None], pw, lo, interp)
        vo = [None] * 5
        vn = [None] * 5
        for off, n in pieces:
            jy, jx = _tap_coords(off, n, pw)
            w = wy(jy) * wx(jx)
            for c in range(5):
                col = c * npp + off
                ro = jnp.sum(read_block(col, n) * w, axis=1)
                rn = jnp.sum(read_block(W + col, n) * w, axis=1)
                vo[c] = ro if vo[c] is None else vo[c] + ro
                vn[c] = rn if vn[c] is None else vn[c] + rn
        return [(1.0 - a) * o + a * n_ for o, n_ in zip(vo, vn)]

    return sample


def _make_rhs(sample, sgn, f, Cg):
    def rhs(qx, qy, qk, ql, a):
        u, v, ux, uy, vx = sample(qx, qy, a)
        om = sgn * jnp.sqrt(f * f + Cg * Cg * (qk * qk + ql * ql))
        cg = (Cg * Cg) / om
        return (u + cg * qk, v + cg * ql,
                -(ux * qk + vx * ql), -(uy * qk - ux * ql))

    return rhs


def _stages(rhs, x, y, kk, ll, a0, da, h, C, A):
    """Explicit RK stage slopes for tableau (C, A)."""
    ks = []
    for ci, aij in zip(C, A):
        qx, qy, qk, ql = x, y, kk, ll
        for kprev, aa in zip(ks, aij):
            if aa:
                qx = qx + h * aa * kprev[0]
                qy = qy + h * aa * kprev[1]
                qk = qk + h * aa * kprev[2]
                ql = ql + h * aa * kprev[3]
        ks.append(rhs(qx, qy, qk, ql, a0 + ci * da))
    return ks


def _lincomb(ks, ws, base, h):
    acc = [None] * 4
    for kv, w in zip(ks, ws):
        if w == 0.0:
            continue
        for i in range(4):
            acc[i] = kv[i] * w if acc[i] is None else acc[i] + kv[i] * w
    return [b + h * a for b, a in zip(base, acc)]


def _substep_math(read_block, x, y, kk, ll, sgn, a0, da, h, cfg, interp):
    """One RK4 substep in patch-local coordinates. Positions x/y are
    PRE-SHIFTED to the patch base (x - x0 - bx*dx), so local offsets are
    just q/d."""
    f, Cg = cfg[6], cfg[7]
    rhs = _make_rhs(_make_sample(read_block, cfg, interp), sgn, f, Cg)
    C = tuple(c for c, _ in _RK4_STAGES)
    A = tuple(a for _, a in _RK4_STAGES)
    ks = _stages(rhs, x, y, kk, ll, a0, da, h, C, A)
    return tuple(_lincomb(ks, _RK4_B, (x, y, kk, ll), h))


def _attempt_math(read_block, x, y, kk, ll, sgn, a0, dah, h, rtol, atol,
                  cfg, interp):
    """One embedded Dormand-Prince 5(4) attempt in patch-local coordinates
    (twin of rays/raytrace.raytrace_adaptive's ``attempt``: same tableau,
    same Hairer scaled-error components). Returns the 5th-order solution
    plus the per-packet sum of squared scaled component errors."""
    from ..rays.raytrace import _DP_A, _DP_B, _DP_B4, _DP_C

    f, Cg = cfg[6], cfg[7]
    rhs = _make_rhs(_make_sample(read_block, cfg, interp), sgn, f, Cg)
    ks = _stages(rhs, x, y, kk, ll, a0, dah, h, _DP_C, _DP_A)
    x5, y5, k5, l5 = _lincomb(ks, _DP_B, (x, y, kk, ll), h)
    be = tuple(b - b4 for b, b4 in zip(_DP_B, _DP_B4))
    ex, ey, ek, el = _lincomb(ks, be, (0.0,) * 4, h)

    def comp(e, y_new, y_old):
        sc = atol + rtol * jnp.maximum(jnp.abs(y_old), jnp.abs(y_new))
        r = e / sc
        return r * r

    esum = (comp(ex, x5, x) + comp(ey, y5, y)
            + comp(ek, k5, kk) + comp(el, l5, ll))
    return x5, y5, k5, l5, esum


def _cells(x, y, geo):
    """Base cell (bx, by) as floats and the flat pair-table row index."""
    x0, y0, dxg, dyg, ny, nx = geo
    bx = jnp.floor((x - x0) / dxg)
    by = jnp.floor((y - y0) / dyg)
    cell = (jnp.remainder(by.astype(jnp.int32), ny) * nx
            + jnp.remainder(bx.astype(jnp.int32), nx))
    return bx, by, cell


def _run(math, T_read, x, y, kk, ll, sgn, scal, geo):
    """Shared body of kernels and twins: locate the packets, shift them to
    their patch base, run ``math`` and shift the positions back."""
    x0, y0, dxg, dyg = geo[:4]
    bx, by, cell = _cells(x, y, geo)
    shx = x0 + bx * dxg
    shy = y0 + by * dyg
    out = math(partial(T_read, cell), x - shx, y - shy, kk, ll, sgn, *scal)
    return (out[0] + shx, out[1] + shy) + tuple(out[2:])


def _kernel(x_ref, y_ref, k_ref, l_ref, s_ref, scal_ref, T_ref, *out_refs,
            math, nscal, geo):
    scal = tuple(scal_ref[i] for i in range(nscal))

    def T_read(cell, start, n):
        # one vector load per packet: row columns [start, start+n)
        cols = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1) + start
        return T_ref[cell[:, None], cols].astype(jnp.float32)

    outs = _run(math, T_read, x_ref[...], y_ref[...], k_ref[...],
                l_ref[...], s_ref[...], scal, geo)
    for ref, v in zip(out_refs, outs):
        ref[...] = v


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _pallas(math, nout, nscal, geo, interpret):
    """``f(T, x, y, k, l, sign, scal) -> nout (N,) vectors`` through one
    Triton-route ``pallas_call`` over blocks of ``BLOCK`` packets."""
    block = BLOCK
    kernel = partial(_kernel, math=math, nscal=nscal, geo=geo)

    def call(T, x, y, kk, ll, sgn, scal):
        n = x.shape[0]
        npad = pl.cdiv(n, block) * block
        vecs = [x, y, kk, ll, sgn]
        if npad != n:
            # padding packets sit at the grid origin with sign +1, so the
            # padded lanes stay finite; they are sliced off below
            fill = (geo[0], geo[1], 1.0, 0.0, 1.0)
            vecs = [jnp.pad(v, (0, npad - n), constant_values=c)
                    for v, c in zip(vecs, fill)]
        ns = _pow2(nscal)
        scal = jnp.pad(scal.astype(jnp.float32), (0, ns - nscal))
        vec = pl.BlockSpec((block,), lambda i: (i,))
        outs = pl.pallas_call(
            kernel,
            grid=(npad // block,),
            in_specs=[vec] * 5 + [
                pl.BlockSpec((ns,), lambda i: (0,)),
                pl.BlockSpec(T.shape, lambda i: (0, 0)),
            ],
            out_specs=[vec] * nout,
            out_shape=[jax.ShapeDtypeStruct((npad,), jnp.float32)] * nout,
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
            interpret=interpret,
            name="fused_ray_" + ("attempt" if nout == 5 else "substep"),
        )(*vecs, scal, T)
        return tuple(o[:n] for o in outs)

    return call


def _geometry(rp, ny, nx):
    return (rp.x0, rp.y0, rp.dx, rp.dy, ny, nx)


def _cfg(rp, interp):
    ph, pw, lo = PATCH_SHAPES[interp]
    W = 5 * ph * pw                  # 5 field channels per time level
    return (ph, pw, lo, W, rp.dx, rp.dy, rp.f, rp.Cg)


def _twin(math, T, x, y, kk, ll, sgn, scal, geo):
    rows = jnp.take(T, _cells(x, y, geo)[2], axis=0).astype(jnp.float32)

    def T_read(cell, start, n):
        del cell
        return rows[:, start:start + n]

    return _run(math, T_read, x, y, kk, ll, sgn,
                tuple(scal[i] for i in range(scal.shape[0])), geo)


def _substep_fn(rp, da):
    interp = rp.interp
    cfg = _cfg(rp, interp)

    def math(read_block, x, y, kk, ll, sgn, a0, h):
        return _substep_math(read_block, x, y, kk, ll, sgn, a0, da, h, cfg,
                             interp)

    return math


def _attempt_fn(rp):
    interp = rp.interp
    cfg = _cfg(rp, interp)

    def math(read_block, x, y, kk, ll, sgn, a0, dah, h, rtol, atol):
        return _attempt_math(read_block, x, y, kk, ll, sgn, a0, dah, h, rtol,
                             atol, cfg, interp)

    return math


def substep_jnp(T, x, y, kk, ll, sgn, scal, *, rp, da, ny, nx):
    """Plain-jnp twin of the substep kernel: the same stage code over a
    ``jnp.take`` of the packets' pair rows. ``scal = [a0, h]``."""
    return _twin(_substep_fn(rp, da), T, x, y, kk, ll, sgn, scal,
                 _geometry(rp, ny, nx))


def attempt_jnp(T, x, y, kk, ll, sgn, scal, *, rp, ny, nx):
    """Plain-jnp twin of the attempt kernel.
    ``scal = [a0, dah, h, rtol, atol]``."""
    return _twin(_attempt_fn(rp), T, x, y, kk, ll, sgn, scal,
                 _geometry(rp, ny, nx))


_CACHE: dict = {}


def make_fused_substep(rp, da: float, ny: int, nx: int,
                       interpret: bool = False):
    """Build (and cache) the fused RK4 substep for a RayParams config:
    ``f(T_pair, x, y, k, l, sign, scal=[a0, h]) -> (x', y', k', l')``."""
    key = ("substep", rp, float(da), ny, nx, interpret)
    if key in _CACHE:
        return _CACHE[key]
    geo = _geometry(rp, ny, nx)
    fwd_call = _pallas(_substep_fn(rp, da), 4, 2, geo, interpret)

    @jax.custom_vjp
    def fused(T, x, y, kk, ll, sgn, scal):
        return fwd_call(T, x, y, kk, ll, sgn, scal)

    def fwd(T, x, y, kk, ll, sgn, scal):
        return fused(T, x, y, kk, ll, sgn, scal), (T, x, y, kk, ll, sgn, scal)

    def bwd(res, g):
        # linearise the plain per-stage formulation (row gather + the
        # production patch sampler); it computes the same values, so the
        # two VJPs agree to float round-off
        from ..rays.packets import Packets
        from ..rays.raytrace import _make_patch_sampler, _step

        def plain(T, x, y, kk, ll, sgn, scal):
            p = Packets(x, y, kk, ll, sgn)
            sample = _make_patch_sampler(T, p, rp, ny, nx)
            out = _step(p, sample, scal[0], da, scal[1], rp, "rk4")
            return out.x, out.y, out.k, out.l

        _, vjp = jax.vjp(plain, *res)
        return vjp(tuple(g))

    fused.defvjp(fwd, bwd)
    _CACHE[key] = fused
    return fused


def make_fused_attempt(rp, ny: int, nx: int, interpret: bool = False):
    """Fused DP5(4) attempt for the adaptive ``loop='while'`` path:
    ``f(T_pair, x, y, k, l, sign, scal=[a0, dah, h, rtol, atol])
    -> (x5, y5, k5, l5, err)``. Forward-only (no custom VJP)."""
    key = ("attempt", rp, ny, nx, interpret)
    if key not in _CACHE:
        _CACHE[key] = _pallas(_attempt_fn(rp), 5, 5,
                              _geometry(rp, ny, nx), interpret)
    return _CACHE[key]
