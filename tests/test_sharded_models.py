"""Slab-sharded TwoLayerQG / SWQG end-to-end tests on the 8-virtual-device
CPU mesh (generalize the sharded flow path beyond RSW —
the reference's largest production grid is a 2048^2 two-layer QG,
swqg/TwoLayerParameters.jl:5). Each model: sharded step == replicated step,
sharded ray fields == replicated fields, sharded coupled frame == replicated
coupled frame."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.spectral import rfft2
from juliaraytracingsw_tpu.core.steppers import zero_clock
from juliaraytracingsw_tpu.coupled.driver import SimState, derive_nu, make_coupled_frame
from juliaraytracingsw_tpu.models import swqg, twolayerqg
from juliaraytracingsw_tpu.models.base import build_stepper
from juliaraytracingsw_tpu.parallel.mesh import make_mesh, shard_packets
from juliaraytracingsw_tpu.parallel.sharded import ShardedSWQG, ShardedTwoLayerQG
from juliaraytracingsw_tpu.rays.packets import lattice_packets
from juliaraytracingsw_tpu.rays.raytrace import RayParams, fields_from_psih

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")

DT = 1e-3
F0, CG = 3.0, 1.0


def _band_ic(grid, rng, nfields, amp=0.1, kband=8.0):
    """Random band-limited spectral IC with reality symmetry (via rfft2)."""
    phys = rng.standard_normal((nfields, grid.ny, grid.nx)).astype(np.float32)
    sol = rfft2(jnp.asarray(phys))
    lowpass = jnp.exp(-(grid.Krsq / kband**2))
    sol = sol * lowpass * grid.dealias_mask
    scale = amp / (jnp.abs(sol).max() + 1e-30)
    return (sol * scale).astype(jnp.complex64)


def _setup_twolayer(nx=64, seed=7):
    g = make_grid(nx)
    nu = derive_nu(1.0, nx, 4, DT)
    model = twolayerqg.make_model(g, U=0.2, mu=1e-2, nu=nu, nnu=4,
                                  f0=F0, Cg=CG, drho_rho0=0.2)
    sol0 = _band_ic(g, np.random.default_rng(seed), 2, amp=0.5)

    def psih_fn(sol):
        p = twolayerqg.streamfunction_from_pv(sol, g, model.params)
        return 0.5 * (p[0] + p[1])       # barotropic mean streamfunction

    return g, model, sol0, psih_fn


def _setup_swqg(nx=64, seed=11):
    g = make_grid(nx)
    nu = derive_nu(1.0, nx, 4, DT)
    model = swqg.make_model(g, nu=nu, nnu=4, f=F0, Cg=CG)
    sol0 = _band_ic(g, np.random.default_rng(seed), 1, amp=0.5)[0]

    def psih_fn(sol):
        return swqg.streamfunction_from_pv(sol, g, model.params)

    return g, model, sol0, psih_fn


def _compare_steps(g, model, sol0, Sharded, nsteps=10, **kw):
    mesh = make_mesh(8)
    sh = Sharded(g, model.params, mesh, dt=DT, **kw)

    init_r, step_r = build_stepper(model, "IFMAB3", dt=DT)
    sol_r, clock_r, st_r = sol0, zero_clock(), init_r(sol0)
    init_s, step_s = sh.stepper()
    sol_s = sh.shard_solution(sol0)
    clock_s, st_s = zero_clock(), init_s(sol_s)

    for _ in range(nsteps):
        sol_r, clock_r, st_r = step_r(sol_r, clock_r, st_r)
        sol_s, clock_s, st_s = step_s(sol_s, clock_s, st_s)

    a = np.asarray(sol_r)
    b = sh.unshard(sol_s)
    assert a.shape == b.shape
    scale = np.abs(a).max()
    np.testing.assert_allclose(b, a, atol=2e-5 * scale, rtol=2e-4)
    # pad columns stay identically zero
    pad = np.asarray(sol_s)[..., g.nkr:]
    assert pad.size == 0 or np.abs(pad).max() == 0.0
    return sh


@needs_8
class TestShardedTwoLayerQG:
    def test_step_matches_replicated(self):
        g, model, sol0, _ = _setup_twolayer()
        _compare_steps(g, model, sol0, ShardedTwoLayerQG)

    def test_fields_match_replicated(self):
        g, model, sol0, psih_fn = _setup_twolayer()
        mesh = make_mesh(8)
        sh = ShardedTwoLayerQG(g, model.params, mesh, dt=DT)
        want = np.asarray(fields_from_psih(psih_fn(sol0), g))
        got = np.asarray(sh.fields(sh.shard_solution(sol0)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)

    def test_baroclinic_advect_fields(self):
        g, model, sol0, _ = _setup_twolayer()
        mesh = make_mesh(8)
        sh = ShardedTwoLayerQG(g, model.params, mesh, dt=DT,
                               advect="baroclinic")

        def psih_bc(sol):
            p = twolayerqg.streamfunction_from_pv(sol, g, model.params)
            return 0.5 * (p[0] - p[1])   # swqg/TwoLayerRaytracingDriver.jl:232

        want = np.asarray(fields_from_psih(psih_bc(sol0), g))
        got = np.asarray(sh.fields(sh.shard_solution(sol0)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)

    def test_coupled_frame_matches_replicated(self):
        g, model, sol0, psih_fn = _setup_twolayer()
        mesh = make_mesh(8)
        sh = ShardedTwoLayerQG(g, model.params, mesh, dt=DT)
        k0 = float(np.sqrt(3.0) * F0 / CG)
        rp = RayParams(f=F0, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]),
                       dx=g.dx, dy=g.dy)
        packets = lattice_packets(8, g.Lx, g.Ly, k0=k0, k_ring=True)

        init_r, step_r = build_stepper(model, "IFMAB3", dt=DT)
        frame_r = make_coupled_frame(model, step_r, psih_fn, rp, 5,
                                     k_cutoff=100.0 * F0 / CG, k0=k0)
        fields0 = fields_from_psih(psih_fn(sol0), g)
        sim = SimState(sol0, zero_clock(), init_r(sol0), packets, fields0)
        out_r = frame_r(sim)

        init_s, _ = sh.stepper()
        frame_s = sh.make_coupled_frame(rp, 5, k_cutoff=100.0 * F0 / CG,
                                        k0=k0)
        sol_s = sh.shard_solution(sol0)
        pk_s = shard_packets(packets, mesh)
        sol_out, clock_out, _, pk_out = frame_s(sol_s, zero_clock(),
                                                init_s(sol_s), pk_s)

        np.testing.assert_allclose(
            sh.unshard(sol_out), np.asarray(out_r.sol),
            atol=2e-5 * np.abs(np.asarray(out_r.sol)).max(), rtol=2e-4)
        for a, b in zip((pk_out.x, pk_out.y, pk_out.k, pk_out.l),
                        (out_r.packets.x, out_r.packets.y,
                         out_r.packets.k, out_r.packets.l)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=5e-4, atol=5e-5)
        assert int(clock_out.step) == 5

    def test_overlap_frame_matches_sequential(self):
        g, model, sol0, _ = _setup_twolayer()
        mesh = make_mesh(8)
        sh = ShardedTwoLayerQG(g, model.params, mesh, dt=DT)
        k0 = float(np.sqrt(3.0) * F0 / CG)
        rp = RayParams(f=F0, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]),
                       dx=g.dx, dy=g.dy)
        packets = lattice_packets(8, g.Lx, g.Ly, k0=k0, k_ring=True)
        init_s, _ = sh.stepper()
        sol_s = sh.shard_solution(sol0)
        pk_s = shard_packets(packets, mesh)
        frame_seq = sh.make_coupled_frame(rp, 5)
        frame_ovl = sh.make_coupled_frame(rp, 5, overlap=True)
        sol_a, _, _, pk_a = frame_seq(sol_s, zero_clock(), init_s(sol_s), pk_s)
        sol_b, clock_b, _, pk_b = frame_ovl(sol_s, zero_clock(),
                                            init_s(sol_s), pk_s)
        np.testing.assert_array_equal(sh.unshard(sol_a), sh.unshard(sol_b))
        for a, b in zip((pk_a.x, pk_a.y, pk_a.k, pk_a.l),
                        (pk_b.x, pk_b.y, pk_b.k, pk_b.l)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
        assert int(clock_b.step) == 5


@needs_8
class TestShardedSWQG:
    def test_step_matches_replicated(self):
        g, model, sol0, _ = _setup_swqg()
        sh = _compare_steps(g, model, sol0, ShardedSWQG)
        # channel-less layout round-trips
        assert sh.unshard(sh.shard_solution(sol0)).shape == sol0.shape

    def test_fields_match_replicated(self):
        g, model, sol0, psih_fn = _setup_swqg()
        mesh = make_mesh(8)
        sh = ShardedSWQG(g, model.params, mesh, dt=DT)
        want = np.asarray(fields_from_psih(psih_fn(sol0), g))
        got = np.asarray(sh.fields(sh.shard_solution(sol0)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)

    def test_coupled_frame_matches_replicated(self):
        g, model, sol0, psih_fn = _setup_swqg()
        mesh = make_mesh(8)
        sh = ShardedSWQG(g, model.params, mesh, dt=DT)
        k0 = float(np.sqrt(3.0) * F0 / CG)
        rp = RayParams(f=F0, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]),
                       dx=g.dx, dy=g.dy)
        packets = lattice_packets(8, g.Lx, g.Ly, k0=k0, k_ring=True)

        init_r, step_r = build_stepper(model, "IFMAB3", dt=DT)
        frame_r = make_coupled_frame(model, step_r, psih_fn, rp, 5,
                                     k_cutoff=100.0 * F0 / CG, k0=k0)
        fields0 = fields_from_psih(psih_fn(sol0), g)
        sim = SimState(sol0, zero_clock(), init_r(sol0), packets, fields0)
        out_r = frame_r(sim)

        init_s, _ = sh.stepper()
        frame_s = sh.make_coupled_frame(rp, 5, k_cutoff=100.0 * F0 / CG,
                                        k0=k0)
        sol_s = sh.shard_solution(sol0)
        pk_s = shard_packets(packets, mesh)
        sol_out, clock_out, _, pk_out = frame_s(sol_s, zero_clock(),
                                                init_s(sol_s), pk_s)

        np.testing.assert_allclose(
            sh.unshard(sol_out), np.asarray(out_r.sol),
            atol=2e-5 * np.abs(np.asarray(out_r.sol)).max(), rtol=2e-4)
        for a, b in zip((pk_out.x, pk_out.y, pk_out.k, pk_out.l),
                        (out_r.packets.x, out_r.packets.y,
                         out_r.packets.k, out_r.packets.l)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=5e-4, atol=5e-5)
        assert int(clock_out.step) == 5


@needs_8
class TestShardedThomasYamada:
    def _setup(self, nx=64, seed=13):
        from juliaraytracingsw_tpu.models import thomasyamada as ty

        g = make_grid(nx)
        model = ty.make_model(g, nu=1e-18, nnu=4, Ro=0.2)
        sol0 = _band_ic(g, np.random.default_rng(seed), 4, amp=0.3)
        return g, model, sol0

    def test_step_matches_replicated(self):
        from juliaraytracingsw_tpu.parallel.sharded import ShardedThomasYamada

        g, model, sol0 = self._setup()
        _compare_steps(g, model, sol0, ShardedThomasYamada)

    def test_fields_match_replicated(self):
        from juliaraytracingsw_tpu.parallel.sharded import ShardedThomasYamada

        g, model, sol0 = self._setup()
        mesh = make_mesh(8)
        sh = ShardedThomasYamada(g, model.params, mesh, dt=DT)
        psih = -sol0[0] * g.invKrsq        # barotropic streamfunction
        want = np.asarray(fields_from_psih(psih, g))
        got = np.asarray(sh.fields(sh.shard_solution(sol0)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)


@needs_8
class TestShardedMultiLayerQG:
    def _setup(self, nx=64, seed=17, nlayers=3):
        from juliaraytracingsw_tpu.models import multilayerqg as mlqg

        g = make_grid(nx)
        nu = derive_nu(1.0, nx, 4, DT)
        U = tuple(0.2 - 0.2 * j for j in range(nlayers))
        model = mlqg.make_model(g, U=U, beta=0.5, mu=1e-2, nu=nu, nnu=4,
                                Fcoup=tuple(4.0 for _ in range(nlayers - 1)))
        sol0 = _band_ic(g, np.random.default_rng(seed), nlayers, amp=0.4)
        return g, model, sol0

    def test_step_matches_replicated(self):
        from juliaraytracingsw_tpu.parallel.sharded import ShardedMultiLayerQG

        g, model, sol0 = self._setup()
        _compare_steps(g, model, sol0, ShardedMultiLayerQG)

    def test_fields_match_replicated(self):
        from juliaraytracingsw_tpu.models import multilayerqg as mlqg
        from juliaraytracingsw_tpu.parallel.sharded import ShardedMultiLayerQG

        g, model, sol0 = self._setup()
        mesh = make_mesh(8)
        sh = ShardedMultiLayerQG(g, model.params, mesh, dt=DT)
        psih = mlqg.streamfunction_from_pv(sol0, g, model.params)
        w = np.asarray(model.params.delta, np.float32)
        psib = jnp.tensordot(jnp.asarray(w), psih, axes=(0, 0))
        want = np.asarray(fields_from_psih(psib, g))
        got = np.asarray(sh.fields(sh.shard_solution(sol0)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)


@needs_8
class TestShardedRSWVariants:
    """The reference's file-swap RSW variants on the sharded core
    (rsw/{Linborg,Modified,QuadHeightModified}ShallowWater.jl)."""

    def _ic(self, g, seed=23):
        from juliaraytracingsw_tpu.coupled.initial_conditions import band_geo_wave_ic

        return band_geo_wave_ic(g, np.random.default_rng(seed), Kg=(4, 7),
                                Kw=(0, 3), ag=0.2, aw=0.02, f=F0, Cg=CG)

    def test_linborg_step_matches_replicated(self):
        from juliaraytracingsw_tpu.models import linborg
        from juliaraytracingsw_tpu.parallel.sharded_rsw import ShardedLinborg

        g = make_grid(64)
        model = linborg.make_model(g, nu=derive_nu(1.0, 64, 4, DT), nnu=4,
                                   f=F0, Cg=CG)
        _compare_steps(g, model, self._ic(g), ShardedLinborg)

    def test_modified_step_matches_replicated(self):
        from juliaraytracingsw_tpu.models import modified_sw
        from juliaraytracingsw_tpu.parallel.sharded_rsw import ShardedModifiedSW

        g = make_grid(64)
        model = modified_sw.make_model(g, nu=derive_nu(1.0, 64, 4, DT),
                                       nnu=4, f=F0, Cg=CG)
        _compare_steps(g, model, self._ic(g), ShardedModifiedSW)

    def test_quadheight_step_and_fields_match(self):
        from juliaraytracingsw_tpu.core.spectral import irfft2, rfft2
        from juliaraytracingsw_tpu.models import quadheight
        from juliaraytracingsw_tpu.parallel.sharded_rsw import ShardedQuadHeight

        g = make_grid(64)
        model = quadheight.make_model(g, nu=derive_nu(1.0, 64, 4, DT),
                                      nnu=4, f=F0, Cg=CG)
        ic = self._ic(g)
        sol0 = quadheight.set_solution(ic[0], ic[1], ic[2], g)
        sh = _compare_steps(g, model, sol0, ShardedQuadHeight)

        # ray fields: eta recovered from m through an FFT round-trip
        def psih_fn(sol):
            m = irfft2(sol[2], g.nx)
            etah = rfft2(1.0 / m - 1.0)
            qh = g.ik * sol[1] - g.il * sol[0] - F0 * etah
            return -qh / (g.Krsq + F0**2 / CG**2)

        want = np.asarray(fields_from_psih(psih_fn(sol0), g))
        got = np.asarray(sh.fields(sh.shard_solution(sol0)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)


@needs_8
def test_sharded_taps_gather_frame():
    """gather='taps' in the sharded coupled frame (grid >> ensemble regime)
    matches the patch-path trajectories and the replicated taps path."""
    g, model, sol0, psih_fn = _setup_swqg()
    mesh = make_mesh(8)
    from juliaraytracingsw_tpu.parallel.sharded import ShardedSWQG

    sh = ShardedSWQG(g, model.params, mesh, dt=DT)
    k0 = float(np.sqrt(3.0) * F0 / CG)
    rp_t = RayParams(f=F0, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]),
                     dx=g.dx, dy=g.dy, gather="taps")
    packets = lattice_packets(8, g.Lx, g.Ly, k0=k0, k_ring=True)
    init_s, _ = sh.stepper()
    sol_s = sh.shard_solution(sol0)
    pk_s = shard_packets(packets, mesh)
    frame_t = sh.make_coupled_frame(rp_t, 5, k_cutoff=100.0 * F0 / CG, k0=k0)
    _, clock_t, _, pk_t = frame_t(sol_s, zero_clock(), init_s(sol_s), pk_s)
    frame_p = sh.make_coupled_frame(rp_t._replace(gather="patch"), 5,
                                    k_cutoff=100.0 * F0 / CG, k0=k0)
    _, _, _, pk_p = frame_p(sol_s, zero_clock(), init_s(sol_s), pk_s)
    for a, b in zip((pk_t.x, pk_t.y, pk_t.k, pk_t.l),
                    (pk_p.x, pk_p.y, pk_p.k, pk_p.l)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-5, atol=5e-6)
    assert int(clock_t.step) == 5
    # overlap requires patch
    with pytest.raises(ValueError, match="patch"):
        sh.make_coupled_frame(rp_t, 5, overlap=True)
