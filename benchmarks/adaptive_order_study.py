"""Step-count study: adaptive DP5(4) vs Fehlberg 7(8).

The reference's production GPU path integrates rays with adaptive Vern7
(raytracing/GPURaytracing.jl:111-113). This study measures, on the
closed-form shear-flow oracle (scipy f64 reference), what a 7th-order
embedded pair actually buys at matched tolerance:

1. SMOOTH analytic RHS (no interpolation): the 7(8) pair reaches the same
   achieved error with 2.5-9x fewer accepted steps — the textbook
   high-order win. Measured (f64, rtol 1e-6..1e-12):

       rtol    dopri5 acc/err      rkf78 acc/err
       1e-06   13 / 4.5e-06         5 / 5.8e-07
       1e-08   34 / 2.5e-08         8 / 3.3e-08
       1e-10   84 / 2.1e-10        13 / 7.4e-10
       1e-12  212 / 1.7e-12        23 / 5.8e-12

2. Through spectrally-prefiltered cubic B-SPLINE fields (C2 — the
   smoothest interpolant in production use anywhere in this framework or
   the reference): the 7(8) estimator is blind to the interpolant's
   third-derivative jumps at cell crossings, so its REAL error floors at
   ~1e-3..1e-4 regardless of rtol while DP5(4) keeps converging:

       rtol    dopri5 acc/err      rkf78 acc/err   (f64, 128^2 grid)
       1e-06   13 / 5.6e-04         5 / 1.5e-02
       1e-08   33 / 5.3e-07         8 / 1.0e-03
       1e-10   82 / 6.1e-10        13 / 1.2e-04

Conclusion (the repo's measured parity stance): order > 5 pays only when
the field interpolation is smoother than the tolerance demands. With C2
B-spline (or C0 bilinear — the reference's own texture path!) fields,
DP5(4) is the correct production pair; ``pair='rkf78'`` /
``ray_method='adaptive7'`` is provided for smooth-field/frozen-analytic
uses where the 7th-order win is real.

Run: JAX_PLATFORMS=cpu python benchmarks/adaptive_order_study.py
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from scipy.integrate import solve_ivp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.spectral import rfft2
from juliaraytracingsw_tpu.rays.packets import Packets
from juliaraytracingsw_tpu.rays.raytrace import (
    _EMBEDDED_PAIRS,
    RayParams,
    fields_from_psih,
    raytrace,
    raytrace_adaptive,
)

F, CG, U0, Q, K0 = 3.0, 1.0, 0.6, 3.0, 5.0
T = 2.0


def rhs(t, z):
    x, y, l = z
    W = np.sqrt(F * F + CG * CG * (K0 * K0 + l * l))
    return np.array([U0 * np.sin(Q * y) + CG * CG * K0 / W,
                     CG * CG * l / W,
                     -U0 * Q * np.cos(Q * y) * K0])


def run_smooth(pair, rtol):
    C, A, BH, BE, ex = _EMBEDDED_PAIRS[pair]
    t, z, h = 0.0, np.array([0.5, 0.3, 1.0]), 0.5
    nacc = nrej = 0
    while t < T - 1e-12 and nacc + nrej < 100000:
        he = min(h, T - t)
        ks = []
        for ci, ai in zip(C, A):
            zq = z + he * sum(a * k for a, k in zip(ai, ks))
            ks.append(rhs(t + ci * he, zq))
        z5 = z + he * sum(b * k for b, k in zip(BH, ks))
        e = he * sum(b * k for b, k in zip(BE, ks))
        sc = rtol * 1e-2 + rtol * np.maximum(np.abs(z), np.abs(z5))
        err = np.sqrt(np.mean((e / sc) ** 2))
        if err <= 1:
            z, t, nacc = z5, t + he, nacc + 1
        else:
            nrej += 1
        h = he * min(5, max(0.2, 0.9 * max(err, 1e-10) ** (-ex)))
    return nacc, nrej, z


def main():
    zT = solve_ivp(rhs, (0, T), [0.5, 0.3, 1.0], rtol=1e-13,
                   atol=1e-14).y[:, -1]
    print("== smooth analytic RHS (f64) ==")
    for rtol in (1e-6, 1e-8, 1e-10, 1e-12):
        row = []
        for pair in ("dopri5", "rkf78"):
            nacc, nrej, z = run_smooth(pair, rtol)
            row.append(f"{pair}: acc={nacc:4d} rej={nrej:3d} "
                       f"err={np.abs(z - zT).max():.2e}")
        print(f"rtol={rtol:.0e}  " + "   ".join(row))

    print("== through C2 B-spline interpolated fields (f64, 128^2) ==")
    g = make_grid(128)
    Y = np.meshgrid(np.asarray(g.x), np.asarray(g.y))[1]
    psih = rfft2(jnp.asarray((U0 / Q) * np.cos(Q * Y), jnp.float64))
    fields = fields_from_psih(psih, g, "bspline")
    rp = RayParams(f=F, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]),
                   dx=g.dx, dy=g.dy, interp="bspline")
    p0 = Packets(x=jnp.asarray([0.5]), y=jnp.asarray([0.3]),
                 k=jnp.asarray([K0]), l=jnp.asarray([1.0]),
                 sign=jnp.asarray([1.0]))
    ref = raytrace(p0, fields, fields, 0.0, T, rp, nsubsteps=20000)
    for rtol in (1e-6, 1e-8, 1e-10):
        row = []
        for pair in ("dopri5", "rkf78"):
            out, info = raytrace_adaptive(
                p0, fields, fields, 0.0, T, rp, rtol=rtol, atol=rtol * 1e-2,
                max_steps=4096, pair=pair)
            err = max(abs(float(out.x[0]) - float(ref.x[0])),
                      abs(float(out.y[0]) - float(ref.y[0])),
                      abs(float(out.l[0]) - float(ref.l[0])))
            row.append(f"{pair}: acc={int(info['n_accepted']):4d} "
                       f"rej={int(info['n_rejected']):3d} err={err:.2e}")
        print(f"rtol={rtol:.0e}  " + "   ".join(row))


if __name__ == "__main__":
    main()
