"""Differentiability tests: finite-difference gradient checks through
interpolation, flow steps, ray integration and the coupled pipeline
(SURVEY.md §7.6). Run in float64 for meaningful FD comparisons."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.spectral import rfft2
from juliaraytracingsw_tpu.core.steppers import zero_clock
from juliaraytracingsw_tpu.coupled.initial_conditions import random_band_psih
from juliaraytracingsw_tpu.models import swqg
from juliaraytracingsw_tpu.models.base import build_stepper, run
from juliaraytracingsw_tpu.rays import interp
from juliaraytracingsw_tpu.rays.packets import Packets, lattice_packets
from juliaraytracingsw_tpu.rays.raytrace import RayParams, fields_from_psih, raytrace


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def fd_check(f, x, seed=0, eps=1e-6, rtol=2e-4):
    """Directional FD vs VJP for a scalar function of a real array."""
    rng = np.random.default_rng(seed)
    d = jnp.asarray(rng.standard_normal(np.shape(x)), jnp.float64)
    g = jax.grad(f)(x)
    analytic = float(jnp.vdot(g, d).real)
    fd = float((f(x + eps * d) - f(x - eps * d)) / (2 * eps))
    assert abs(analytic - fd) <= rtol * max(abs(fd), abs(analytic), 1e-12), (
        analytic, fd,
    )


class TestInterpGradients:
    def test_bilinear_grad_wrt_field(self, rng):
        g = make_grid(16)
        xq = jnp.asarray(rng.uniform(-2, 2, 9))
        yq = jnp.asarray(rng.uniform(-2, 2, 9))

        def f(field):
            out = interp.bilinear(field, xq, yq, float(g.x[0]), float(g.y[0]),
                                  g.dx, g.dy)
            return jnp.sum(out**2)

        fd_check(f, jnp.asarray(rng.standard_normal((2, 16, 16))))

    def test_bspline_grad_wrt_positions(self, rng):
        g = make_grid(32)
        field = jnp.asarray(rng.standard_normal((1, 32, 32)))

        def f(q):
            out = interp.bspline(field, q[:5], q[5:], float(g.x[0]),
                                 float(g.y[0]), g.dx, g.dy)
            return jnp.sum(jnp.sin(out))

        fd_check(f, jnp.asarray(rng.uniform(-2, 2, 10)))


class TestFlowGradients:
    def test_swqg_step_grad_wrt_ic(self, rng):
        g = make_grid(32)
        model = swqg.make_model(g, nu=1e-8, nnu=2)
        init, step = build_stepper(model, "IFMAB3", dt=1e-2)
        psih0 = random_band_psih(g, rng, amp=0.3, dtype=jnp.float64)

        def f(psi_real):
            psih = rfft2(psi_real)
            qh = swqg.pv_from_streamfunction(psih, g, model.params)
            sol, _, _ = run(step, qh, zero_clock(jnp.float64), init(qh), 5)
            return float(0) + jnp.real(jnp.sum(sol * jnp.conj(sol))) * 1e-4

        psi0 = jnp.fft.irfft2(psih0, s=(g.ny, g.nx))
        fd_check(f, psi0, eps=1e-6, rtol=5e-4)


class TestRayGradients:
    def _setup(self, rng, interp_method="bspline"):
        g = make_grid(32)
        psih = random_band_psih(g, rng, amp=0.05, dtype=jnp.float64)
        rp = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                       dx=g.dx, dy=g.dy, interp=interp_method)
        p = lattice_packets(3, g.Lx, g.Ly, k0=6.0, dtype=jnp.float64)
        return g, psih, rp, p

    def test_raytrace_grad_wrt_flow(self, rng):
        g, psih, rp, p = self._setup(rng)

        def f(psi_real):
            fields = fields_from_psih(rfft2(psi_real), g, rp.interp)
            out = raytrace(p, fields, fields, 0.0, 0.5, rp, nsubsteps=8)
            return jnp.mean(out.k**2 + out.l**2)

        psi0 = jnp.fft.irfft2(psih, s=(g.ny, g.nx))
        fd_check(f, psi0, eps=1e-6, rtol=1e-3)

    def test_raytrace_grad_wrt_initial_positions(self, rng):
        g, psih, rp, p = self._setup(rng)
        fields = fields_from_psih(psih, g, rp.interp)

        def f(xy):
            pk = Packets(xy[: p.n], xy[p.n:], p.k, p.l, p.sign)
            out = raytrace(pk, fields, fields, 0.0, 0.5, rp, nsubsteps=8)
            return jnp.mean(out.k**2 + out.l**2)

        fd_check(f, jnp.concatenate([p.x, p.y]), eps=1e-6, rtol=1e-3)

    def test_grad_through_time_blend(self, rng):
        g, psih, rp, p = self._setup(rng)
        psih2 = random_band_psih(g, np.random.default_rng(7), amp=0.05,
                                 dtype=jnp.float64)
        f_new = fields_from_psih(psih2, g, rp.interp)

        def f(psi_real):
            f_old = fields_from_psih(rfft2(psi_real), g, rp.interp)
            out = raytrace(p, f_old, f_new, 0.0, 0.3, rp, nsubsteps=4)
            return jnp.mean(out.x**2 + out.y**2)

        psi0 = jnp.fft.irfft2(psih, s=(g.ny, g.nx))
        fd_check(f, psi0, eps=1e-6, rtol=1e-3)


class TestPatchBackwardFormulation:
    """Two backward formulations exist for the patch fast path (AD table
    transpose is the default — see
    rays/raytrace._patch_bwd_impl). Pin: the default patch backward matches
    the taps-gather path's gradients, and the opt-in JRSW_PATCH_BWD=taps
    custom VJP agrees with both."""

    def _setup(self, rng):
        g = make_grid(32)
        psih = random_band_psih(g, rng, amp=0.05, dtype=jnp.float64)
        psih2 = random_band_psih(g, np.random.default_rng(3), amp=0.05,
                                 dtype=jnp.float64)
        rp = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                       dx=g.dx, dy=g.dy, interp="bilinear")
        p = lattice_packets(4, g.Lx, g.Ly, k0=6.0, dtype=jnp.float64)
        f_old = fields_from_psih(psih, g, rp.interp)
        f_new = fields_from_psih(psih2, g, rp.interp)
        return g, rp, p, f_old, f_new

    def _grads(self, rp, p, f_old, f_new):
        def loss(fo, fn, t1):
            out = raytrace(p, fo, fn, 0.0, t1, rp, nsubsteps=3)
            return jnp.mean(out.k**2 + out.l**2) + jnp.mean(out.x**2)

        return jax.grad(loss, argnums=(0, 1, 2))(f_old, f_new,
                                                 jnp.float64(0.3))

    def test_patch_default_grad_matches_taps(self, rng):
        g, rp, p, f_old, f_new = self._setup(rng)
        g_patch = self._grads(rp, p, f_old, f_new)
        g_taps = self._grads(rp._replace(gather="taps"), p, f_old, f_new)
        # default patch backward is the AD table transpose — same math as
        # the taps path up to FP association
        for a, b in zip(g_patch, g_taps):
            scale = float(jnp.max(jnp.abs(b))) + 1e-30
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=5e-5, atol=1e-7 * scale)

    def test_taps_custom_vjp_backward_agrees(self, rng, monkeypatch):
        g, rp, p, f_old, f_new = self._setup(rng)
        g_tab = self._grads(rp, p, f_old, f_new)     # default: AD transpose
        monkeypatch.setenv("JRSW_PATCH_BWD", "taps")
        jax.clear_caches()
        try:
            g_fb = self._grads(rp, p, f_old, f_new)  # opt-in custom VJP
        finally:
            monkeypatch.delenv("JRSW_PATCH_BWD")
            jax.clear_caches()
        for a, b in zip(g_fb, g_tab):
            scale = float(jnp.max(jnp.abs(b))) + 1e-30
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=5e-5, atol=1e-7 * scale)
