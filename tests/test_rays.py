"""Ray-tracing tests: interpolation accuracy, analytic ray baselines,
Hamiltonian conservation in steady flow, ensemble resampling."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.spectral import rfft2
from juliaraytracingsw_tpu.rays import interp
from juliaraytracingsw_tpu.rays.dispersion import group_velocity, omega
from juliaraytracingsw_tpu.rays.packets import Packets, lattice_packets
from juliaraytracingsw_tpu.rays.raytrace import (
    RayParams,
    fields_from_psih,
    raytrace,
    sample_velocity,
)
from juliaraytracingsw_tpu.rays.resample import (
    init_birth_death,
    k_cutoff_reset,
    weibull_birth_death,
)


def band_limited_psih(grid, rng, kband=(2, 5), amp=0.05):
    K = np.sqrt(np.asarray(grid.Krsq))
    mask = (K >= kband[0]) & (K <= kband[1])
    phase = rng.uniform(0, 2 * np.pi, K.shape)
    psih = mask * np.exp(1j * phase)
    psi = np.fft.irfft2(psih, s=(grid.ny, grid.nx))
    psi *= amp / max(np.abs(psi).max(), 1e-30)
    return rfft2(jnp.asarray(psi, jnp.float32))


class TestInterp:
    def test_bilinear_exact_at_nodes(self, rng):
        g = make_grid(16)
        f = rng.standard_normal((2, 16, 16)).astype(np.float32)
        xq = np.asarray(g.x)[np.array([0, 3, 15])]
        yq = np.asarray(g.y)[np.array([5, 0, 15])]
        out = interp.bilinear(
            jnp.asarray(f), jnp.asarray(xq), jnp.asarray(yq), float(g.x[0]),
            float(g.y[0]), g.dx, g.dy
        )
        expect = f[:, [5, 0, 15], [0, 3, 15]]
        np.testing.assert_allclose(np.asarray(out), expect, atol=1e-5)

    def test_bilinear_periodic_wrap(self, rng):
        g = make_grid(8)
        f = rng.standard_normal((1, 8, 8)).astype(np.float32)
        # query one full period away
        x = float(g.x[2])
        out1 = interp.bilinear(jnp.asarray(f), jnp.asarray([x]), jnp.asarray([float(g.y[3])]),
                               float(g.x[0]), float(g.y[0]), g.dx, g.dy)
        out2 = interp.bilinear(jnp.asarray(f), jnp.asarray([x + g.Lx]), jnp.asarray([float(g.y[3]) - g.Ly]),
                               float(g.x[0]), float(g.y[0]), g.dx, g.dy)
        np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), atol=1e-5)

    def test_bspline_spectral_accuracy(self, rng):
        """Prefiltered periodic cubic B-spline on a band-limited field is far
        more accurate than bilinear at off-grid points."""
        g = make_grid(64)
        X, Y = np.meshgrid(np.asarray(g.x), np.asarray(g.y))
        f = np.sin(3 * X + 1.0) * np.cos(2 * Y - 0.5)
        fh = rfft2(jnp.asarray(f[None], jnp.float32))
        coeff = jnp.fft.irfft2(
            fh * interp.bspline_prefilter_mask(g), s=(g.ny, g.nx), axes=(-2, -1)
        )
        xq = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
        yq = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
        exact = np.sin(3 * xq + 1.0) * np.cos(2 * yq - 0.5)
        out = interp.bspline(coeff, jnp.asarray(xq), jnp.asarray(yq),
                             float(g.x[0]), float(g.y[0]), g.dx, g.dy)
        err_bspline = np.abs(np.asarray(out)[0] - exact).max()
        out_bl = interp.bilinear(jnp.asarray(f[None], jnp.float32), jnp.asarray(xq),
                                 jnp.asarray(yq), float(g.x[0]), float(g.y[0]), g.dx, g.dy)
        err_bl = np.abs(np.asarray(out_bl)[0] - exact).max()
        assert err_bspline < 5e-4
        assert err_bspline < err_bl / 10

    def test_bicubic_hermite_matches_function(self, rng):
        g = make_grid(64)
        X, Y = np.meshgrid(np.asarray(g.x), np.asarray(g.y))
        f = np.cos(2 * X) * np.sin(3 * Y)
        fx = -2 * np.sin(2 * X) * np.sin(3 * Y)
        fy = 3 * np.cos(2 * X) * np.cos(3 * Y)
        fxy = -6 * np.sin(2 * X) * np.cos(3 * Y)
        xq = rng.uniform(-np.pi, np.pi, 100).astype(np.float32)
        yq = rng.uniform(-np.pi, np.pi, 100).astype(np.float32)
        out = interp.bicubic_hermite(
            *(jnp.asarray(a[None], jnp.float32) for a in (f, fx, fy, fxy)),
            jnp.asarray(xq), jnp.asarray(yq),
            float(g.x[0]), float(g.y[0]), g.dx, g.dy,
        )
        exact = np.cos(2 * xq) * np.sin(3 * yq)
        assert np.abs(np.asarray(out)[0] - exact).max() < 2e-4


class TestRays:
    def test_free_propagation_zero_flow(self):
        g = make_grid(32)
        rp = RayParams(f=1.0, Cg=2.0, x0=float(g.x[0]), y0=float(g.y[0]),
                       dx=g.dx, dy=g.dy)
        zero = jnp.zeros((5, g.ny, g.nx), jnp.float32)
        p = Packets(
            x=jnp.asarray([0.1]), y=jnp.asarray([-0.2]),
            k=jnp.asarray([2.0]), l=jnp.asarray([1.0]), sign=jnp.asarray([1.0]),
        )
        t1 = 0.5
        out = raytrace(p, zero, zero, 0.0, t1, rp, nsubsteps=8)
        cgx, cgy = group_velocity(2.0, 1.0, 1.0, 2.0, 1.0)
        np.testing.assert_allclose(float(out.x[0]), 0.1 + float(cgx) * t1, rtol=1e-5)
        np.testing.assert_allclose(float(out.y[0]), -0.2 + float(cgy) * t1, rtol=1e-5)
        np.testing.assert_allclose(float(out.k[0]), 2.0, rtol=1e-6)

    def test_negative_branch_moves_opposite(self):
        g = make_grid(32)
        rp = RayParams(f=1.0, Cg=2.0, x0=float(g.x[0]), y0=float(g.y[0]),
                       dx=g.dx, dy=g.dy)
        zero = jnp.zeros((5, g.ny, g.nx), jnp.float32)
        p = Packets(jnp.zeros(2), jnp.zeros(2), jnp.full(2, 2.0), jnp.zeros(2),
                    jnp.asarray([1.0, -1.0]))
        out = raytrace(p, zero, zero, 0.0, 0.3, rp, nsubsteps=4)
        assert float(out.x[0]) > 0 and float(out.x[1]) < 0
        np.testing.assert_allclose(float(out.x[0]), -float(out.x[1]), rtol=1e-5)

    @pytest.mark.parametrize("method", ["rk4", "dopri5", "midpoint"])
    def test_hamiltonian_conservation_steady_flow(self, rng, method):
        """Steady flow: Omega = omega(k) + k.u(x) is conserved along rays."""
        g = make_grid(64)
        psih = band_limited_psih(g, rng, amp=0.02)
        rp = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                       dx=g.dx, dy=g.dy, interp="bspline")
        fields = fields_from_psih(psih, g, interp="bspline")
        p = lattice_packets(4, g.Lx, g.Ly, k0=6.0)

        def Omega(pk):
            u, v = sample_velocity(pk, fields, rp)
            return omega(pk.k, pk.l, rp.f, rp.Cg, pk.sign) + pk.k * u + pk.l * v

        O0 = np.asarray(Omega(p))
        out = raytrace(p, fields, fields, 0.0, 5.0, rp, nsubsteps=200, method=method)
        O1 = np.asarray(Omega(out))
        drift = np.abs(O1 - O0) / np.abs(O0)
        assert np.isfinite(np.asarray(out.k)).all()
        assert drift.max() < 2e-3, drift.max()

    def test_bicubic_dispatch_reachable(self, rng):
        """interp='bicubic' is reachable end-to-end: fields_from_psih emits
        the [f|fx|fy|fxy] stack, interpolate() dispatches, raytrace and the
        sampling helpers agree with the bspline path to high accuracy."""
        g = make_grid(64)
        psih = band_limited_psih(g, rng, amp=0.03)
        p = lattice_packets(4, g.Lx, g.Ly, k0=6.0, k_ring=True)
        outs = {}
        for interp_m in ("bicubic", "bspline"):
            rp = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                           dx=g.dx, dy=g.dy, interp=interp_m)
            fields = fields_from_psih(psih, g, interp=interp_m)
            if interp_m == "bicubic":
                assert fields.shape[0] == 20
                u, v = sample_velocity(p, fields, rp)
                assert np.isfinite(np.asarray(u)).all()
            outs[interp_m] = raytrace(p, fields, fields, 0.0, 1.0, rp,
                                      nsubsteps=40)
        for a, b in zip(outs["bicubic"][:4], outs["bspline"][:4]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=5e-3, atol=5e-4)

    @pytest.mark.parametrize("interp", ["bilinear", "bspline", "bicubic"])
    def test_patch_gather_matches_taps(self, rng, interp):
        """The patch-table fast path (one row-gather per substep) must track
        the global-gather oracle through an evolving flow."""
        g = make_grid(64)
        psih0 = band_limited_psih(g, rng, amp=0.05)
        psih1 = band_limited_psih(g, rng, amp=0.05)
        f0 = fields_from_psih(psih0, g, interp=interp)
        f1 = fields_from_psih(psih1, g, interp=interp)
        p = lattice_packets(6, g.Lx, g.Ly, k0=6.0, k_ring=True)
        base = dict(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                    dx=g.dx, dy=g.dy, interp=interp)
        out_p = raytrace(p, f0, f1, 0.0, 0.5,
                         RayParams(**base, gather="patch"), nsubsteps=16)
        out_t = raytrace(p, f0, f1, 0.0, 0.5,
                         RayParams(**base, gather="taps"), nsubsteps=16)
        for a, b in zip(out_p[:4], out_t[:4]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-4, atol=2e-5)

    def test_bf16_table_tracks_f32(self, rng):
        """table_dtype='bfloat16' (half-width gather rows, see
        RayParams.table_dtype) must track the f32 patch path to bf16
        rounding accuracy, and the default must stay bit-identical f32."""
        g = make_grid(64)
        f0 = fields_from_psih(band_limited_psih(g, rng, amp=0.05), g)
        f1 = fields_from_psih(band_limited_psih(g, rng, amp=0.05), g)
        p = lattice_packets(6, g.Lx, g.Ly, k0=6.0, k_ring=True)
        base = dict(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                    dx=g.dx, dy=g.dy)
        out_f32 = raytrace(p, f0, f1, 0.0, 0.5, RayParams(**base),
                           nsubsteps=16)
        out_bf16 = raytrace(p, f0, f1, 0.0, 0.5,
                            RayParams(**base, table_dtype="bfloat16"),
                            nsubsteps=16)
        # positions advect by O(u*t); bf16 stores fields to ~0.4% relative
        for a, b in zip(out_bf16[:4], out_f32[:4]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-2, atol=2e-3)
        # default path unchanged
        out_default = raytrace(p, f0, f1, 0.0, 0.5,
                               RayParams(**base, table_dtype="float32"),
                               nsubsteps=16)
        for a, b in zip(out_default[:4], out_f32[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_bf16_table_trajectory_divergence(self, rng):
        """Divergence bound over a LONG horizon (100 substeps through an
        evolving blend): bf16 table storage rounds fields to ~2^-8 relative,
        so trajectories drift linearly in the field error, not worse
        (promotes bf16 from spot-check to measured)."""
        g = make_grid(64)
        f0 = fields_from_psih(band_limited_psih(g, rng, amp=0.05), g)
        f1 = fields_from_psih(band_limited_psih(g, rng, amp=0.05), g)
        p = lattice_packets(8, g.Lx, g.Ly, k0=6.0, k_ring=True)
        base = dict(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                    dx=g.dx, dy=g.dy)
        out_f32 = raytrace(p, f0, f1, 0.0, 2.0, RayParams(**base),
                           nsubsteps=100)
        out_bf16 = raytrace(p, f0, f1, 0.0, 2.0,
                            RayParams(**base, table_dtype="bfloat16"),
                            nsubsteps=100)
        # field error ~4e-3 relative on |u|~0.05 acting for t=2 -> position
        # error O(4e-4); allow 10x headroom. k/l errors scale with grad*k.
        scale = {0: g.Lx, 1: g.Ly, 2: 6.0, 3: 6.0}
        for i, (a, b) in enumerate(zip(out_bf16[:4], out_f32[:4])):
            err = np.abs(np.asarray(a) - np.asarray(b)).max() / scale[i]
            assert err < 5e-3, (i, err)

    @pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
    def test_patch_gather_gradients_match(self, rng, interp):
        """d(loss)/d(fields) must agree between patch and taps paths (the
        row-gather transposes to a scatter-add; bicubic adds the per-block
        Hermite weight chain)."""
        g = make_grid(32)
        psih = band_limited_psih(g, rng, amp=0.05)
        fields = fields_from_psih(psih, g, interp=interp)
        p = lattice_packets(3, g.Lx, g.Ly, k0=6.0)
        base = dict(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                    dx=g.dx, dy=g.dy, interp=interp)

        def loss(fl, gather):
            rp = RayParams(**base, gather=gather)
            out = raytrace(p, fl, fl, 0.0, 0.2, rp, nsubsteps=4)
            return jnp.mean(out.k ** 2 + out.x ** 2)

        gp = jax.grad(lambda fl: loss(fl, "patch"))(fields)
        gt = jax.grad(lambda fl: loss(fl, "taps"))(fields)
        np.testing.assert_allclose(np.asarray(gp), np.asarray(gt),
                                   rtol=1e-3, atol=1e-6)

    @pytest.mark.parametrize("interp", ["bilinear", "bspline", "bicubic"])
    def test_conv_pair_build_matches_roll(self, rng, interp):
        """JRSW_TABLE_BUILD='conv' (one patch-extraction convolution) must
        produce the exact column layout of the roll-built pair table."""
        from juliaraytracingsw_tpu.rays.patch import (
            build_pair_table_direct,
            build_patch_table,
        )
        from juliaraytracingsw_tpu.rays.raytrace import make_pair_table

        g = make_grid(32)
        f0 = fields_from_psih(band_limited_psih(g, rng, amp=0.05), g,
                              interp=interp)
        f1 = fields_from_psih(band_limited_psih(g, rng, amp=0.05), g,
                              interp=interp)
        A = build_pair_table_direct(f0, f1, interp)
        B = make_pair_table(build_patch_table(f0, interp),
                            build_patch_table(f1, interp))
        assert A.shape == B.shape
        np.testing.assert_allclose(np.asarray(A), np.asarray(B),
                                   rtol=1e-6, atol=1e-7)

    def test_midpoint_convergence_control_and_implicit_grad(self, rng):
        """ray_method='midpoint' solves the implicit system to a residual
        tolerance (not a fixed iteration count) and is differentiable via
        implicit differentiation (lax.custom_root). Checks: (a) maxit=1 vs
        converged solves differ (the while_loop really iterates), (b) the
        converged solve is symplectic-accurate vs a fine rk4 reference,
        (c) gradients through the implicit solve match the rk4 path's to
        integrator-difference accuracy."""
        g = make_grid(64)
        psih = band_limited_psih(g, rng, amp=0.05)
        fields = fields_from_psih(psih, g)
        p = lattice_packets(4, g.Lx, g.Ly, k0=6.0, k_ring=True)
        base = dict(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                    dx=g.dx, dy=g.dy)
        out_conv = raytrace(p, fields, fields, 0.0, 1.0,
                            RayParams(**base, midpoint_rtol=1e-7),
                            nsubsteps=50, method="midpoint")
        out_1it = raytrace(p, fields, fields, 0.0, 1.0,
                           RayParams(**base, midpoint_maxit=1),
                           nsubsteps=50, method="midpoint")
        dx = np.abs(np.asarray(out_conv.x) - np.asarray(out_1it.x)).max()
        assert dx > 1e-7, "solver did not iterate past the first step"
        ref = raytrace(p, fields, fields, 0.0, 1.0, RayParams(**base),
                       nsubsteps=800, method="rk4")
        for a, b in zip(out_conv[:4], ref[:4]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-3, atol=1e-4)

        def loss(fl, method):
            out = raytrace(p, fl, fl, 0.0, 0.2, RayParams(**base),
                           nsubsteps=8, method=method)
            return jnp.mean(out.k**2 + out.x**2)

        gm = jax.grad(lambda fl: loss(fl, "midpoint"))(fields)
        gr = jax.grad(lambda fl: loss(fl, "rk4"))(fields)
        assert np.isfinite(np.asarray(gm)).all()
        gr_np = np.asarray(gr)
        # integrator-order difference bounds the gap; absolute floor set by
        # the gradient scale (near-zero spectral entries differ freely)
        np.testing.assert_allclose(np.asarray(gm), gr_np,
                                   rtol=0.05, atol=2e-3 * np.abs(gr_np).max())

    def test_time_blend_convention(self):
        """At a=0 rays see the OLD field; at a=1 the NEW field (regression
        pin for the reference's inverted alpha, GPURaytracing.jl:33)."""
        from juliaraytracingsw_tpu.rays.raytrace import blend

        old = jnp.full((5, 4, 4), 2.0)
        new = jnp.full((5, 4, 4), -3.0)
        np.testing.assert_allclose(np.asarray(blend(old, new, 0.0)), 2.0)
        np.testing.assert_allclose(np.asarray(blend(old, new, 1.0)), -3.0)
        np.testing.assert_allclose(np.asarray(blend(old, new, 0.25)), 0.75)


class TestResample:
    def test_k_cutoff_reset(self):
        p = Packets(jnp.zeros(3), jnp.zeros(3),
                    jnp.asarray([1.0, 10.0, 3.0]), jnp.asarray([0.0, 10.0, 4.0]),
                    jnp.ones(3))
        out = k_cutoff_reset(p, k_cutoff=5.0, k0=2.0)
        np.testing.assert_allclose(np.asarray(out.k), [1.0, 2.0, 2.0])
        np.testing.assert_allclose(np.asarray(out.l), [0.0, 0.0, 0.0])

    def test_birth_death_cycle(self):
        key = jax.random.PRNGKey(0)
        p = lattice_packets(4, 2 * np.pi, 2 * np.pi, k0=5.0)
        st = init_birth_death(key, p.n, k_shape=1.5, lam=1.0)
        total_born = 0
        for _ in range(50):
            p, st, born = weibull_birth_death(
                p, st, dt=0.1, Lx=2 * np.pi, Ly=2 * np.pi, k0=5.0, lam=1.0
            )
            total_born += int(jnp.sum(born))
        assert total_born > 0
        # reborn packets stay inside the domain
        assert float(jnp.max(jnp.abs(p.x))) <= np.pi + 1e-5


def test_chunked_stage_math_matches(monkeypatch):
    from juliaraytracingsw_tpu.coupled.initial_conditions import random_band_psih
    """JRSW_RAY_CHUNK wraps the substep in lax.map over packet chunks
    (the XLA-only HBM-re-read lever) — trajectories must
    be identical to the unchunked path."""
    import jax

    g = make_grid(32)
    rng = np.random.default_rng(5)
    psih = random_band_psih(g, rng, amp=0.05)
    fields_old = fields_from_psih(psih, g)
    fields_new = fields_from_psih(
        random_band_psih(g, np.random.default_rng(6), amp=0.05), g)
    rp = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                   dx=g.dx, dy=g.dy)
    pk = lattice_packets(8, g.Lx, g.Ly, k0=6.0, k_ring=True)
    base = raytrace(pk, fields_old, fields_new, 0.0, 1e-2, rp, nsubsteps=3)
    monkeypatch.setenv("JRSW_RAY_CHUNK", "16")
    jax.clear_caches()
    try:
        chunked = raytrace(pk, fields_old, fields_new, 0.0, 1e-2, rp,
                           nsubsteps=3)
    finally:
        monkeypatch.delenv("JRSW_RAY_CHUNK")
        jax.clear_caches()
    for a, b in zip(base[:4], chunked[:4]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_resolve_gather_auto_crossover():
    """gather='auto' encodes the patch-vs-taps crossover:
    512^2+1M -> patch, 2048^2+262k -> taps, no flags needed."""
    from juliaraytracingsw_tpu.rays.raytrace import resolve_gather

    rp = RayParams(f=3.0, Cg=1.0, x0=0.0, y0=0.0, dx=0.1, dy=0.1,
                   gather="auto")
    # the anchors rays/raytrace.PATCH_TAPS_CROSSOVER was fitted to
    assert resolve_gather(rp, 1 << 20, 512, 512).gather == "patch"
    assert resolve_gather(rp, 262144, 512, 512).gather == "patch"
    assert resolve_gather(rp, 262144, 2048, 2048).gather == "taps"
    assert resolve_gather(rp, 16384, 512, 512).gather == "taps"
    # explicit modes pass through untouched
    for mode in ("patch", "taps"):
        assert resolve_gather(rp._replace(gather=mode),
                              1, 2048, 2048).gather == mode
    # non-patch-capable interp never resolves to patch
    # (every interp in PATCH_SHAPES is patch-capable; 'auto' with a huge
    # ensemble picks patch only when supported)
    rp_bicubic = rp._replace(interp="bicubic")
    from juliaraytracingsw_tpu.rays.patch import PATCH_SHAPES
    expect = "patch" if "bicubic" in PATCH_SHAPES else "taps"
    assert resolve_gather(rp_bicubic, 1 << 20, 512, 512).gather == expect


def test_raytrace_auto_gather_matches_explicit():
    """raytrace with gather='auto' must integrate identically to the mode
    it resolves to."""
    from juliaraytracingsw_tpu.coupled.initial_conditions import random_band_psih

    g = make_grid(32)
    rng = np.random.default_rng(7)
    fields_old = fields_from_psih(random_band_psih(g, rng, amp=0.05), g)
    fields_new = fields_from_psih(
        random_band_psih(g, np.random.default_rng(8), amp=0.05), g)
    pk = lattice_packets(8, g.Lx, g.Ly, k0=6.0, k_ring=True)  # 64 pk, 1024 cells
    base = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                     dx=g.dx, dy=g.dy)
    auto = raytrace(pk, fields_old, fields_new, 0.0, 1e-2,
                    base._replace(gather="auto"), nsubsteps=2)
    # 64 packets vs 1024 cells -> 8*64 < 1024 -> taps
    taps = raytrace(pk, fields_old, fields_new, 0.0, 1e-2,
                    base._replace(gather="taps"), nsubsteps=2)
    for a, b in zip(auto[:4], taps[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
