"""Unit tests for the spectral substrate: grid, transforms, filters, steppers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from juliaraytracingsw_tpu.core.filters import make_filter
from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.spectral import (
    enforce_reality,
    irfft2,
    parseval_sum2,
    rfft2,
)
from juliaraytracingsw_tpu.core.steppers import (
    Clock,
    apply_L,
    expm_tables,
    make_etdrk4,
    make_filtered_ab3,
    make_filtered_rk4,
    make_ifab3,
    make_ifrk4,
    zero_clock,
)


def test_grid_wavenumbers():
    g = make_grid(8, Lx=2 * np.pi)
    np.testing.assert_allclose(np.asarray(g.kr), [0, 1, 2, 3, 4])
    np.testing.assert_allclose(np.asarray(g.l), [0, 1, 2, 3, -4, -3, -2, -1])
    assert g.Krsq.shape == (8, 5)
    np.testing.assert_allclose(np.asarray(g.Krsq)[1, 2], 1 + 4)
    assert float(g.invKrsq[0, 0]) == 0.0


def test_spectral_derivative_exact():
    g = make_grid(32)
    X, Y = np.meshgrid(np.asarray(g.x), np.asarray(g.y))
    f = np.sin(3 * X) * np.cos(2 * Y)
    fh = rfft2(jnp.asarray(f, jnp.float32))
    dfdx = irfft2(g.ik * fh, g.nx)
    np.testing.assert_allclose(
        np.asarray(dfdx), 3 * np.cos(3 * X) * np.cos(2 * Y), atol=2e-5
    )
    dfdy = irfft2(g.il * fh, g.nx)
    np.testing.assert_allclose(
        np.asarray(dfdy), -2 * np.sin(3 * X) * np.sin(2 * Y), atol=2e-5
    )


def test_parseval(rng):
    g = make_grid(64)
    f = rng.standard_normal((64, 64)).astype(np.float32)
    fh = rfft2(jnp.asarray(f))
    direct = np.sum(f**2) * g.dx * g.dy
    spectral = float(parseval_sum2(fh, g))
    np.testing.assert_allclose(spectral, direct, rtol=1e-5)


def test_dealias_mask():
    g = make_grid(12, aliased_fraction=1 / 3)
    m = np.asarray(g.dealias_mask)
    # keep |k index| <= (2/3)*6 = 4
    assert m[0, 4] == 1.0 and m[0, 5] == 0.0
    assert m[4, 0] == 1.0 and m[5, 0] == 0.0 and m[12 - 4, 0] == 1.0


def test_enforce_reality_is_projection(rng):
    g = make_grid(16)
    # random complex spectral field, NOT conjugate-symmetric
    sh = (g.nl, g.nkr)
    fh = jnp.asarray(
        rng.standard_normal(sh) + 1j * rng.standard_normal(sh), jnp.complex64
    )
    once = enforce_reality(fh, g)
    twice = enforce_reality(once, g)
    np.testing.assert_allclose(np.asarray(once), np.asarray(twice), atol=1e-6)


def test_filter_shape_and_limits():
    g = make_grid(64)
    filt = np.asarray(make_filter(g))
    assert filt.shape == (64, 33)
    assert filt[0, 0] == 1.0
    # highest wavenumber corner strongly damped
    assert filt[32, 32] < 1e-10


# --- steppers ----------------------------------------------------------------

def _rotation_L():
    """Per-mode 2x2 skew block: d/dt [a,b] = [[0,w],[-w,0]] [a,b]."""
    w = 2.0
    L = np.zeros((2, 2, 4, 3), np.complex128)
    L[0, 1] = w
    L[1, 0] = -w
    return jnp.asarray(L), w


def test_expm_tables_block_rotation():
    L, w = _rotation_L()
    dt = 0.1
    e1, e2 = expm_tables(L, dt)
    R = np.asarray(e1)[:, :, 0, 0]
    expected = np.array(
        [[np.cos(w * dt), np.sin(w * dt)], [-np.sin(w * dt), np.cos(w * dt)]]
    )
    np.testing.assert_allclose(R.real, expected, atol=1e-7)


def test_ifab3_exact_for_linear():
    """With N = 0 the IF stepper integrates the linear system exactly."""
    L, w = _rotation_L()
    dt, nsteps = 0.05, 40
    from juliaraytracingsw_tpu.models.base import run

    init, step = make_ifab3(L, lambda s, t: jnp.zeros_like(s), dt)
    sol = jnp.zeros((2, 4, 3), jnp.complex64).at[0].set(1.0)
    sol, _, _ = run(step, sol, zero_clock(), init(sol), nsteps)
    t = nsteps * dt
    np.testing.assert_allclose(
        complex(sol[0, 0, 0]), np.cos(w * t), atol=1e-5
    )
    np.testing.assert_allclose(
        complex(sol[1, 0, 0]), -np.sin(w * t), atol=1e-5
    )


@pytest.mark.parametrize(
    "maker,min_order",
    [
        # AB3 with the reference's forward-Euler bootstrap (3 Euler steps,
        # utils/IFMAB3.jl:130) is globally 2nd order from the startup error.
        (make_ifab3, 1.7),
        (make_ifrk4, 3.3),
        (make_etdrk4, 3.3),
        (make_filtered_ab3, 1.7),
        (make_filtered_rk4, 3.3),
    ],
)
def test_stepper_convergence_order(maker, min_order):
    """Scalar stiff ODE du/dt = L u + sin(t) u^2; check empirical order
    (float64 so 4th-order errors sit above roundoff)."""
    from juliaraytracingsw_tpu.models.base import run

    jax.config.update("jax_enable_x64", True)
    try:
        L = jnp.full((1, 1), -0.5, jnp.complex128)

        def calcN(u, t):
            return jnp.sin(t) * u * u

        def integrate(dt, nsteps, mk=maker):
            init, step = mk(L, calcN, dt)
            sol = jnp.full((1, 1), 0.3, jnp.complex128)
            sol, _, _ = run(step, sol, zero_clock(jnp.float64), init(sol), nsteps)
            return complex(sol[0, 0])

        # three-point self-convergence (cancels any reference-solution error)
        u1 = integrate(0.1, 80)
        u2 = integrate(0.05, 160)
        u3 = integrate(0.025, 320)
    finally:
        jax.config.update("jax_enable_x64", False)
    e1, e2 = abs(u1 - u2), abs(u2 - u3)
    observed = np.log2(e1 / e2)
    assert observed > min_order, (observed, e1, e2)


def test_apply_L_block_vs_diag():
    L, _ = _rotation_L()
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 4, 3)), jnp.complex64)
    y = apply_L(L.astype(jnp.complex64), x)
    # manual einsum check
    yn = np.einsum("abml,bml->aml", np.asarray(L), np.asarray(x))
    np.testing.assert_allclose(np.asarray(y), yn, atol=1e-6)


def test_dft_backend_matches_fft(monkeypatch):
    """JRSW_FFT=dft (dense DFT-matmul transforms) must match jnp.fft to
    f32 roundoff, both directions, batched and single-field, including
    gradients."""
    import jax

    from juliaraytracingsw_tpu.core import spectral

    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((3, 64, 64)), jnp.float32)
    ref_f = jnp.fft.rfft2(x, axes=(-2, -1))
    ref_i = jnp.fft.irfft2(ref_f, s=(64, 64), axes=(-2, -1))
    monkeypatch.setenv("JRSW_FFT", "dft")
    jax.clear_caches()
    try:
        got_f = jax.jit(spectral.rfft2)(x)
        got_i = jax.jit(lambda s: spectral.irfft2(s, 64))(ref_f)
        g = jax.grad(lambda s: float(0) + jnp.sum(
            spectral.irfft2(s, 64) ** 2))(ref_f)
    finally:
        monkeypatch.delenv("JRSW_FFT")
        jax.clear_caches()
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(ref_f),
                               rtol=1e-5, atol=1e-5 * float(jnp.abs(ref_f).max()))
    np.testing.assert_allclose(np.asarray(got_i), np.asarray(ref_i),
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(np.abs(np.asarray(g))).all()
    # odd / non-square / oversized shapes fall back to jnp.fft untouched
    y = jnp.asarray(rng.standard_normal((31, 33)), jnp.float32)
    monkeypatch.setenv("JRSW_FFT", "dft")
    try:
        out = spectral.rfft2(y)
    finally:
        monkeypatch.delenv("JRSW_FFT")
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(jnp.fft.rfft2(y, axes=(-2, -1))),
                               rtol=1e-5, atol=1e-5)


def test_dft_backend_full_rsw_step(monkeypatch):
    """A full IF-AB3 RSW step under JRSW_FFT=dft matches the FFT path
    (the transforms are the only thing that changed)."""
    import jax

    from juliaraytracingsw_tpu.coupled.driver import derive_nu
    from juliaraytracingsw_tpu.coupled.initial_conditions import band_geo_wave_ic
    from juliaraytracingsw_tpu.core.steppers import zero_clock
    from juliaraytracingsw_tpu.models import rsw
    from juliaraytracingsw_tpu.models.base import build_stepper

    g = make_grid(64)
    dt = 1e-3
    model = rsw.make_model(g, nu=derive_nu(1.0, 64, 4, dt), nnu=4,
                           f=3.0, Cg=1.0)
    sol0 = band_geo_wave_ic(g, np.random.default_rng(2), Kg=(4, 7),
                            Kw=(0, 3), ag=0.3, aw=0.05, f=3.0, Cg=1.0)

    def three_steps():
        init_fn, step_fn = build_stepper(model, "IFMAB3", dt=dt)
        sol, clock, st = sol0, zero_clock(), init_fn(sol0)
        for _ in range(3):
            sol, clock, st = step_fn(sol, clock, st)
        return np.asarray(sol)

    ref = three_steps()
    monkeypatch.setenv("JRSW_FFT", "dft")
    jax.clear_caches()
    try:
        got = three_steps()
    finally:
        monkeypatch.delenv("JRSW_FFT")
        jax.clear_caches()
    np.testing.assert_allclose(got, ref, rtol=2e-4,
                               atol=2e-5 * np.abs(ref).max())
