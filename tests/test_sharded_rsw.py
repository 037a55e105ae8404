"""Slab-sharded RSW end-to-end tests on the 8-virtual-device CPU mesh:
the sharded flow step must match the replicated step,
and the sharded coupled frame (flow + all-gathered fields + DP rays) must
match the replicated coupled frame."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.steppers import zero_clock
from juliaraytracingsw_tpu.coupled.driver import SimState, derive_nu, make_coupled_frame
from juliaraytracingsw_tpu.coupled.initial_conditions import band_geo_wave_ic
from juliaraytracingsw_tpu.models import rsw
from juliaraytracingsw_tpu.models.base import build_stepper
from juliaraytracingsw_tpu.parallel.mesh import make_mesh, shard_packets
from juliaraytracingsw_tpu.parallel.sharded_rsw import ShardedRSW
from juliaraytracingsw_tpu.rays.packets import lattice_packets
from juliaraytracingsw_tpu.rays.raytrace import RayParams, fields_from_psih


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")

F, CG, DT = 3.0, 1.0, 2e-3


def _setup(nx=128, rngseed=1234):
    g = make_grid(nx)
    nu = derive_nu(1.0, nx, 4, DT)
    params_model = rsw.make_model(g, nu=nu, nnu=4, f=F, Cg=CG)
    rng = np.random.default_rng(rngseed)
    sol0 = band_geo_wave_ic(g, rng, Kg=(4, 7), Kw=(0, 3), ag=0.3, aw=0.05,
                            f=F, Cg=CG)
    return g, params_model, sol0


@needs_8
class TestShardedFlow:
    def test_sharded_step_matches_replicated(self):
        g, model, sol0 = _setup()
        mesh = make_mesh(8)
        sh = ShardedRSW(g, model.params, mesh, dt=DT)

        # replicated reference
        init_r, step_r = build_stepper(model, "IFMAB3", dt=DT)
        sol_r, clock_r, st_r = sol0, zero_clock(), init_r(sol0)
        # sharded
        init_s, step_s = sh.stepper()
        sol_s = sh.shard_solution(sol0)
        clock_s, st_s = zero_clock(), init_s(sol_s)

        for _ in range(10):
            sol_r, clock_r, st_r = step_r(sol_r, clock_r, st_r)
            sol_s, clock_s, st_s = step_s(sol_s, clock_s, st_s)

        a = np.asarray(sol_r)
        b = sh.unshard(sol_s)
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, atol=2e-5 * scale, rtol=2e-4)
        # pad columns stay identically zero
        pad = np.asarray(sol_s)[..., g.nkr:]
        assert np.abs(pad).max() == 0.0

    def test_sharded_fields_match_replicated(self):
        g, model, sol0 = _setup()
        mesh = make_mesh(8)
        sh = ShardedRSW(g, model.params, mesh, dt=DT)
        params = model.params

        def psih_fn(sol):
            Kd2 = params.f ** 2 / params.Cg2
            qh = g.ik * sol[1] - g.il * sol[0] - params.f * sol[2]
            return -qh / (g.Krsq + Kd2)

        want = np.asarray(fields_from_psih(psih_fn(sol0), g))
        got = np.asarray(sh.fields(sh.shard_solution(sol0)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)


@needs_8
class TestShardedCoupled:
    def test_sharded_coupled_frame_matches_replicated(self):
        g, model, sol0 = _setup()
        mesh = make_mesh(8)
        sh = ShardedRSW(g, model.params, mesh, dt=DT)
        params = model.params
        k0 = float(np.sqrt(3.0) * F / CG)
        rp = RayParams(f=F, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]),
                       dx=g.dx, dy=g.dy)
        packets = lattice_packets(8, g.Lx, g.Ly, k0=k0, k_ring=True)

        # replicated coupled frame
        def psih_fn(sol):
            Kd2 = params.f ** 2 / params.Cg2
            qh = g.ik * sol[1] - g.il * sol[0] - params.f * sol[2]
            return -qh / (g.Krsq + Kd2)

        init_r, step_r = build_stepper(model, "IFMAB3", dt=DT)
        frame_r = make_coupled_frame(model, step_r, psih_fn, rp, 5,
                                     k_cutoff=100.0 * F / CG, k0=k0)
        fields0 = fields_from_psih(psih_fn(sol0), g)
        sim = SimState(sol0, zero_clock(), init_r(sol0), packets, fields0)
        out_r = frame_r(sim)

        # sharded coupled frame: sharded flow state + DP packets
        init_s, _ = sh.stepper()
        frame_s = sh.make_coupled_frame(rp, 5, k_cutoff=100.0 * F / CG, k0=k0)
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
def test_overlap_frame_matches_sequential():
    """The pipelined (overlap=True) coupled frame advances rays through the
    SAME field pairs as the sequential frame — identical trajectories."""
    g, model, sol0 = _setup()
    mesh = make_mesh(8)
    sh = ShardedRSW(g, model.params, mesh, dt=DT)
    k0 = float(np.sqrt(3.0) * F / CG)
    rp = RayParams(f=F, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]),
                   dx=g.dx, dy=g.dy)
    packets = lattice_packets(8, g.Lx, g.Ly, k0=k0, k_ring=True)
    init_s, _ = sh.stepper()
    sol_s = sh.shard_solution(sol0)
    pk_s = shard_packets(packets, mesh)

    frame_seq = sh.make_coupled_frame(rp, 5, k_cutoff=100.0 * F / CG, k0=k0)
    frame_ovl = sh.make_coupled_frame(rp, 5, k_cutoff=100.0 * F / CG, k0=k0,
                                      overlap=True)
    sol_a, clock_a, _, pk_a = frame_seq(sol_s, zero_clock(), init_s(sol_s),
                                        pk_s)
    sol_b, clock_b, _, pk_b = frame_ovl(sol_s, zero_clock(), init_s(sol_s),
                                        pk_s)
    np.testing.assert_array_equal(sh.unshard(sol_a), sh.unshard(sol_b))
    for a, b in zip((pk_a.x, pk_a.y, pk_a.k, pk_a.l),
                    (pk_b.x, pk_b.y, pk_b.k, pk_b.l)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)
    assert int(clock_b.step) == 5 and np.isclose(float(clock_a.t),
                                                 float(clock_b.t))


@needs_8
def test_fused_kernel_partitions_over_mesh():
    """The fused Pallas substep runs per packet shard (shard_map over the
    8-device packet axis) inside the sharded coupled frame — interpret
    mode stands in for the Triton kernel on CPU meshes (same pallas_call
    under the same shard_map), and trajectories must match the default
    path."""
    g, model, sol0 = _setup(nx=64)
    mesh = make_mesh(8)
    sh = ShardedRSW(g, model.params, mesh, dt=DT)
    k0 = float(np.sqrt(3.0) * F / CG)
    rp = RayParams(f=F, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]),
                   dx=g.dx, dy=g.dy)
    packets = shard_packets(
        lattice_packets(8, g.Lx, g.Ly, k0=k0, k_ring=True), mesh)
    init_s, _ = sh.stepper()
    sol_s = sh.shard_solution(sol0)

    frame_base = sh.make_coupled_frame(rp, 3, k_cutoff=100.0 * F / CG, k0=k0)
    _, _, _, pk_base = jax.block_until_ready(
        frame_base(sol_s, zero_clock(), init_s(sol_s), packets))

    frame_f = sh.make_coupled_frame(rp, 3, k_cutoff=100.0 * F / CG, k0=k0,
                                    interpret=True)
    _, _, _, pk_f = jax.block_until_ready(
        frame_f(sol_s, zero_clock(), init_s(sol_s), packets))

    for a, b in zip((pk_f.x, pk_f.y, pk_f.k, pk_f.l),
                    (pk_base.x, pk_base.y, pk_base.k, pk_base.l)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
