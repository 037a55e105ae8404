"""Adaptive embedded ray integrator + closed-form shear-flow oracle
(reference production path is adaptive Vern7,
raytracing/GPURaytracing.jl:111-113; oracle notebooks
AnalyticStationaryRaytracing.ipynb / TimeDependentShearFlow.ipynb)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.spectral import rfft2
from juliaraytracingsw_tpu.rays.packets import Packets
from juliaraytracingsw_tpu.rays.raytrace import (
    RayParams,
    fields_from_psih,
    raytrace,
    raytrace_adaptive,
)

F, CG = 3.0, 1.0


def shear_psih(grid, U0=0.5, q=3):
    """Steady unidirectional shear u = U0 sin(q y), v = 0:
    psi = (U0/q) cos(q y)."""
    Y = np.meshgrid(np.asarray(grid.x), np.asarray(grid.y))[1]
    psi = (U0 / q) * np.cos(q * Y)
    return rfft2(jnp.asarray(psi, jnp.float32))


def _rp(g, interp="bspline", **kw):
    return RayParams(f=F, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]),
                     dx=g.dx, dy=g.dy, interp=interp, **kw)


class TestAdaptive:
    def test_matches_fine_fixed_step(self):
        """Through a strongly sheared flow, adaptive DP5(4) at tight rtol
        tracks a very fine fixed-step rk4 reference."""
        g = make_grid(64)
        fields = fields_from_psih(shear_psih(g, U0=0.8), g, "bspline")
        rp = _rp(g)
        p0 = Packets(x=jnp.asarray([0.3, -1.0]), y=jnp.asarray([0.2, 0.7]),
                     k=jnp.asarray([6.0, 4.0]), l=jnp.asarray([0.0, 2.0]),
                     sign=jnp.asarray([1.0, 1.0]))
        T = 2.0
        ref = raytrace(p0, fields, fields, 0.0, T, rp, nsubsteps=2000)
        out, info = raytrace_adaptive(p0, fields, fields, 0.0, T, rp,
                                      rtol=1e-6, atol=1e-8, max_steps=256)
        assert float(info["t_reached"]) >= T - 1e-6
        n_used = int(info["n_accepted"])
        assert 0 < n_used < 2000, "adaptive should beat the fine fixed grid"
        for a, b in zip(out[:4], ref[:4]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-4, atol=2e-4)

    def test_rejection_recovers_from_huge_h0(self):
        g = make_grid(64)
        fields = fields_from_psih(shear_psih(g, U0=0.8), g, "bspline")
        rp = _rp(g)
        p0 = Packets(x=jnp.asarray([0.1]), y=jnp.asarray([0.4]),
                     k=jnp.asarray([6.0]), l=jnp.asarray([0.0]),
                     sign=jnp.asarray([1.0]))
        T = 1.0
        # start with ONE giant substep: must reject and shrink
        out, info = raytrace_adaptive(p0, fields, fields, 0.0, T, rp,
                                      rtol=1e-6, atol=1e-8, max_steps=256,
                                      init_substeps=1)
        assert int(info["n_rejected"]) > 0
        assert float(info["t_reached"]) >= T - 1e-6
        ref = raytrace(p0, fields, fields, 0.0, T, rp, nsubsteps=1000)
        np.testing.assert_allclose(float(out.y[0]), float(ref.y[0]),
                                   rtol=1e-3, atol=1e-4)

    def test_taps_gather_variant(self):
        g = make_grid(32)
        fields = fields_from_psih(shear_psih(g), g, "bilinear")
        rp_p = _rp(g, interp="bilinear", gather="patch")
        rp_t = _rp(g, interp="bilinear", gather="taps")
        p0 = Packets(x=jnp.asarray([0.3]), y=jnp.asarray([0.2]),
                     k=jnp.asarray([6.0]), l=jnp.asarray([1.0]),
                     sign=jnp.asarray([1.0]))
        o1, _ = raytrace_adaptive(p0, fields, fields, 0.0, 0.5, rp_p)
        o2, _ = raytrace_adaptive(p0, fields, fields, 0.0, 0.5, rp_t)
        for a, b in zip(o1[:4], o2[:4]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-5)


class TestRKF78:
    def test_tableau_is_order_7(self):
        """Fixed-step integration of a smooth nonlinear scalar ODE with the
        Fehlberg 7(8) propagated weights self-converges at order >= 7
        (float64 numpy — interpolated ray fields are only C2, so the
        tableau is validated on an analytic RHS)."""
        from juliaraytracingsw_tpu.rays.raytrace import _EMBEDDED_PAIRS

        C, A, BH, BE, _ = _EMBEDDED_PAIRS["rkf78"]

        def rhs(t, y):
            return y * np.cos(t)          # y(t) = exp(sin t)

        def integrate(n):
            y, t, h = 1.0, 0.0, 2.0 / n
            for _ in range(n):
                ks = []
                for ci, ai in zip(C, A):
                    q = y + h * sum(a * k for a, k in zip(ai, ks))
                    ks.append(rhs(t + ci * h, q))
                y += h * sum(b * k for b, k in zip(BH, ks))
                t += h
            return y

        # three-point self-convergence cancels reference-solution error;
        # coarse steps keep the error well above f64 roundoff (the local
        # error of this pair at h=0.25 is already ~1e-12)
        y1, y2, y4 = integrate(2), integrate(4), integrate(8)
        order = np.log2(abs(y1 - y2) / abs(y2 - y4))
        assert order > 6.5, order
        # and it is actually accurate
        np.testing.assert_allclose(y4, np.exp(np.sin(2.0)), rtol=1e-9)

    def test_smooth_rhs_matched_accuracy_fewer_steps(self):
        """On a SMOOTH analytic RHS the 7(8) pair achieves the same accuracy
        as DP5(4) at matched rtol with several-fold fewer accepted steps —
        the step-count study (full sweep:
        benchmarks/adaptive_order_study.py). Run in f64 numpy: the point is
        the tableau/controller, not the interpolation."""
        from scipy.integrate import solve_ivp

        from juliaraytracingsw_tpu.rays.raytrace import _EMBEDDED_PAIRS

        U0, q, k0 = 0.6, 3.0, 5.0

        def rhs(t, z):
            x, y, l = z
            W = np.sqrt(F * F + CG * CG * (k0 * k0 + l * l))
            return np.array([U0 * np.sin(q * y) + CG * CG * k0 / W,
                             CG * CG * l / W,
                             -U0 * q * np.cos(q * y) * k0])

        zT = solve_ivp(rhs, (0, 2.0), [0.5, 0.3, 1.0], rtol=1e-13,
                       atol=1e-14).y[:, -1]

        def run(pair, rtol):
            C, A, BH, BE, ex = _EMBEDDED_PAIRS[pair]
            t, z, h = 0.0, np.array([0.5, 0.3, 1.0]), 0.5
            nacc = nrej = 0
            while t < 2.0 - 1e-12 and nacc + nrej < 10000:
                he = min(h, 2.0 - t)
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
            return nacc, np.abs(z - zT).max()

        n5, e5 = run("dopri5", 1e-8)
        n7, e7 = run("rkf78", 1e-8)
        assert n7 < n5 / 2, (n7, n5)
        assert e7 < 1e-6 and e5 < 1e-6, (e7, e5)

    def test_adaptive7_through_interpolated_fields(self):
        """Through C2 B-spline fields the 7(8) estimator cannot see the
        interpolant's third-derivative jumps, so it accepts far fewer steps
        at the same rtol and its real error floors near the interpolation-
        smoothness limit (measured ~1e-3, benchmarks/adaptive_order_study.py)
        — the measured basis for keeping DP5(4) as the production default.
        The reference's own Vern7-through-bilinear-textures combo has the
        same property more severely (C0 fields)."""
        g = make_grid(128)
        fields = fields_from_psih(shear_psih(g, U0=0.6), g, "bspline")
        rp = _rp(g)
        p0 = Packets(x=jnp.asarray([0.5]), y=jnp.asarray([0.3]),
                     k=jnp.asarray([5.0]), l=jnp.asarray([1.0]),
                     sign=jnp.asarray([1.0]))
        T = 2.0
        ref = raytrace(p0, fields, fields, 0.0, T, rp, nsubsteps=4000)
        out5, info5 = raytrace_adaptive(p0, fields, fields, 0.0, T, rp,
                                        rtol=1e-7, atol=1e-9, max_steps=512)
        out7, info7 = raytrace_adaptive(p0, fields, fields, 0.0, T, rp,
                                        rtol=1e-7, atol=1e-9, max_steps=512,
                                        pair="rkf78")
        assert float(info7["t_reached"]) >= T - 1e-6
        assert int(info7["n_accepted"]) < int(info5["n_accepted"])
        for a, b in zip(out7[:4], ref[:4]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=2e-2)


class TestShearFlowOracle:
    """Steady shear u = U0 sin(q y): ux = vx = 0 exactly, so dk/dt = 0 and
    (y, l) obey the closed 2-variable system dy/dt = s Cg^2 l / W,
    dl/dt = -U0 q cos(q y) k, W = sqrt(f^2 + Cg^2 (k^2 + l^2)) — integrated
    to oracle precision with scipy float64 (the reference's analytic-ray
    notebooks play this role, AnalyticStationaryRaytracing.ipynb)."""

    def test_k_exactly_constant(self):
        g = make_grid(64)
        fields = fields_from_psih(shear_psih(g, U0=0.6), g, "bspline")
        rp = _rp(g)
        p0 = Packets(x=jnp.asarray([0.5]), y=jnp.asarray([0.3]),
                     k=jnp.asarray([5.0]), l=jnp.asarray([1.0]),
                     sign=jnp.asarray([1.0]))
        out, _ = raytrace_adaptive(p0, fields, fields, 0.0, 3.0, rp,
                                   rtol=1e-7, atol=1e-9, max_steps=512)
        np.testing.assert_allclose(float(out.k[0]), 5.0, rtol=1e-5)

    @pytest.mark.parametrize("sign", [1.0, -1.0])
    def test_trajectory_matches_scipy_oracle(self, sign):
        from scipy.integrate import solve_ivp

        U0, q = 0.6, 3.0
        k0, l0, y0, x0 = 5.0, 1.0, 0.3, 0.5
        T = 2.0

        def rhs(t, z):
            x, y, l = z
            W = np.sqrt(F * F + CG * CG * (k0 * k0 + l * l))
            u = U0 * np.sin(q * y)
            return [u + sign * CG * CG * k0 / W,
                    sign * CG * CG * l / W,
                    -U0 * q * np.cos(q * y) * k0]

        sol = solve_ivp(rhs, (0, T), [x0, y0, l0], rtol=1e-11, atol=1e-12,
                        dense_output=True)
        xT, yT, lT = sol.y[:, -1]

        g = make_grid(128)   # fine grid: interpolant ~ exact sin shear
        fields = fields_from_psih(shear_psih(g, U0=U0, q=int(q)), g,
                                  "bspline")
        rp = _rp(g)
        p0 = Packets(x=jnp.asarray([x0]), y=jnp.asarray([y0]),
                     k=jnp.asarray([k0]), l=jnp.asarray([l0]),
                     sign=jnp.asarray([sign]))
        out, info = raytrace_adaptive(p0, fields, fields, 0.0, T, rp,
                                      rtol=1e-7, atol=1e-9, max_steps=512)
        assert float(info["t_reached"]) >= T - 1e-6
        np.testing.assert_allclose(float(out.x[0]), xT, atol=3e-4)
        np.testing.assert_allclose(float(out.y[0]), yT, atol=3e-4)
        np.testing.assert_allclose(float(out.l[0]), lT, atol=3e-3)


def test_while_loop_matches_scan():
    """loop='while' (forward-only early-exit mode) must reproduce the scan
    trajectories and step counts exactly."""
    from juliaraytracingsw_tpu.coupled.initial_conditions import random_band_psih
    from juliaraytracingsw_tpu.core.grid import make_grid
    from juliaraytracingsw_tpu.rays.packets import lattice_packets
    from juliaraytracingsw_tpu.rays.raytrace import (
        RayParams, fields_from_psih, raytrace_adaptive)

    g = make_grid(32)
    psih = random_band_psih(g, np.random.default_rng(2), amp=0.05)
    fo = fields_from_psih(psih, g)
    fn = fields_from_psih(
        random_band_psih(g, np.random.default_rng(3), amp=0.05), g)
    rp = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                   dx=g.dx, dy=g.dy)
    pk = lattice_packets(6, g.Lx, g.Ly, k0=6.0, k_ring=True)
    ps, info_s = raytrace_adaptive(pk, fo, fn, 0.0, 5e-2, rp,
                                   rtol=1e-6, atol=1e-8, max_steps=32)
    pw, info_w = raytrace_adaptive(pk, fo, fn, 0.0, 5e-2, rp,
                                   rtol=1e-6, atol=1e-8, max_steps=32,
                                   loop="while")
    for a, b in zip(ps[:4], pw[:4]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-8)
    assert int(info_s["n_accepted"]) == int(info_w["n_accepted"])
    assert int(info_s["n_rejected"]) == int(info_w["n_rejected"])
    assert float(info_w["t_reached"]) >= 5e-2 * (1 - 1e-6)


def test_chunked_adaptive_matches_unchunked(monkeypatch):
    """The packet-chunked adaptive attempt (JRSW_RAY_CHUNK) combines exact
    per-chunk squared-error partial sums, so step counts are identical and
    trajectories agree to FP roundoff (the error norm's reduction order
    perturbs h in the last ulp)."""
    from juliaraytracingsw_tpu.coupled.initial_conditions import random_band_psih
    from juliaraytracingsw_tpu.core.grid import make_grid
    from juliaraytracingsw_tpu.rays.packets import lattice_packets
    from juliaraytracingsw_tpu.rays.raytrace import (
        RayParams, fields_from_psih, raytrace_adaptive)

    g = make_grid(32)
    fo = fields_from_psih(random_band_psih(g, np.random.default_rng(2),
                                           amp=0.05), g)
    fn = fields_from_psih(random_band_psih(g, np.random.default_rng(3),
                                           amp=0.05), g)
    rp = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                   dx=g.dx, dy=g.dy)
    pk = lattice_packets(64, g.Lx, g.Ly, k0=6.0, k_ring=True)  # 4096
    monkeypatch.setenv("JRSW_RAY_CHUNK", "0")
    jax.clear_caches()
    p0, i0 = raytrace_adaptive(pk, fo, fn, 0.0, 5e-2, rp,
                               rtol=1e-6, atol=1e-8, max_steps=32)
    monkeypatch.setenv("JRSW_RAY_CHUNK", "1024")
    jax.clear_caches()
    try:
        p1, i1 = raytrace_adaptive(pk, fo, fn, 0.0, 5e-2, rp,
                                   rtol=1e-6, atol=1e-8, max_steps=32)
    finally:
        monkeypatch.delenv("JRSW_RAY_CHUNK")
        jax.clear_caches()
    for a, b in zip(p0[:4], p1[:4]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-6, atol=1e-6)
    assert int(i0["n_accepted"]) == int(i1["n_accepted"])
    assert int(i0["n_rejected"]) == int(i1["n_rejected"])
