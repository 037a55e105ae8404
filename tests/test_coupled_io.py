"""Coupled driver, rolling IO, checkpoints, ICs, config tests."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from juliaraytracingsw_tpu.config.params import (
    RSWRaytracingConfig,
    apply_overrides,
    load_sweep_table,
)
from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.spectral import irfft2, rfft2
from juliaraytracingsw_tpu.coupled.driver import (
    CoupledDriver,
    derive_dt,
    derive_nu,
)
from juliaraytracingsw_tpu.coupled.initial_conditions import (
    band_geo_wave_ic,
    front_ic,
    random_band_psih,
    upsample_snapshot,
)
from juliaraytracingsw_tpu.io.output import SequencedReader, SequencedWriter
from juliaraytracingsw_tpu.models import rsw
from juliaraytracingsw_tpu.rays.packets import lattice_packets
from juliaraytracingsw_tpu.rays.raytrace import RayParams


def make_rsw_driver(tmp_path, g, with_outputs=True, frozen=False, **extra):
    f, Cg = 3.0, 1.0
    dt = 2e-3
    nu = derive_nu(1.0, g.nx, 4, dt)
    model = rsw.make_model(g, nu=nu, nnu=4, f=f, Cg=Cg)
    params = model.params

    def psih_fn(sol):
        Kd2 = params.f**2 / params.Cg2
        qh = g.ik * sol[1] - g.il * sol[0] - params.f * sol[2]
        return -qh / (g.Krsq + Kd2)

    rp = RayParams(f=f, Cg=Cg, x0=float(g.x[0]), y0=float(g.y[0]),
                   dx=g.dx, dy=g.dy)
    drv = CoupledDriver(
        model=model, psih_fn=psih_fn, rp=rp, dt=dt,
        k_cutoff=100.0 * f / Cg, k0=np.sqrt((2 * f) ** 2 - f**2) / Cg,
        frozen_flow=frozen,
        snapshot_writer=SequencedWriter(str(tmp_path / "rsw"), max_writes=3)
        if with_outputs else None,
        packet_writer=SequencedWriter(str(tmp_path / "packets"), max_writes=4)
        if with_outputs else None,
        diagnostics={
            "kinetic_energy": lambda s, g_, p: rsw.kinetic_energy(s, g_),
            "potential_energy": lambda s, g_, p: rsw.potential_energy(s, g_, p),
        },
        log_fn=lambda *a: None,
        **extra,
    )
    return drv


class TestCoupledDriver:
    def test_end_to_end_with_outputs(self, tmp_path, rng):
        g = make_grid(64)
        drv = make_rsw_driver(tmp_path, g)
        sol0 = band_geo_wave_ic(g, rng, Kg=(4, 6), Kw=(0, 3), ag=0.3,
                                aw=0.05, f=3.0, Cg=1.0)
        packets = lattice_packets(4, g.Lx, g.Ly, k0=drv.k0, k_ring=True)
        drv.init(sol0, packets)
        drv.spinup(20)
        drv.run(n_frames=8, flow_steps_per_frame=3)
        drv.save_diagnostics(str(tmp_path / "diagnostics.h5"))
        drv.close()

        # snapshots rolled into multiple files (8 frames, max_writes=3)
        files = sorted(p for p in os.listdir(tmp_path) if p.startswith("rsw."))
        assert len(files) >= 3, files
        reader = SequencedReader(str(tmp_path / "rsw"))
        steps = reader.steps()
        assert len(steps) == 8
        sol = reader.read(f"snapshots/sol/{steps[-1]}")
        assert sol.shape == (3, 64, 33) and np.isfinite(sol).all()

        preader = SequencedReader(str(tmp_path / "packets"))
        psteps = preader.steps("p/x")
        assert len(psteps) == 8
        x = preader.read(f"p/x/{psteps[-1]}")
        gdata = preader.read(f"p/g/{psteps[-1]}")
        assert x.shape == (16, 2) and gdata.shape == (16, 4)
        assert np.isfinite(x).all() and np.isfinite(gdata).all()

        import h5py
        with h5py.File(tmp_path / "diagnostics.h5", "r") as f:
            ke = f["kinetic_energy"][()]
            assert ke.shape == (8,) and np.isfinite(ke).all()

    def test_nan_abort(self, tmp_path, rng):
        g = make_grid(32)
        drv = make_rsw_driver(tmp_path, g, with_outputs=False)
        sol0 = band_geo_wave_ic(g, rng, Kg=(4, 6), Kw=(0, 3), ag=0.3,
                                aw=0.05, f=3.0, Cg=1.0)
        bad = sol0.at[0, 0, 0].set(jnp.nan)
        drv.init(bad, lattice_packets(2, g.Lx, g.Ly, k0=5.0))
        with pytest.raises(FloatingPointError):
            drv.spinup(5)

    def test_frozen_flow_leaves_solution_unchanged(self, tmp_path, rng):
        g = make_grid(32)
        drv = make_rsw_driver(tmp_path, g, with_outputs=False, frozen=True)
        sol0 = band_geo_wave_ic(g, rng, Kg=(4, 6), Kw=(0, 3), ag=0.3,
                                aw=0.05, f=3.0, Cg=1.0)
        packets = lattice_packets(4, g.Lx, g.Ly, k0=5.0)
        drv.init(sol0, packets)
        drv.run(n_frames=3, flow_steps_per_frame=5)
        np.testing.assert_array_equal(np.asarray(drv.sim.sol), np.asarray(sol0))
        # clock advanced, packets moved
        assert float(drv.sim.clock.t) > 0
        assert np.abs(np.asarray(drv.sim.packets.x) - np.asarray(packets.x)).max() > 0

    def test_checkpoint_bit_exact_resume(self, tmp_path, rng):
        g = make_grid(32)
        drv = make_rsw_driver(tmp_path, g, with_outputs=False)
        sol0 = band_geo_wave_ic(g, rng, Kg=(4, 6), Kw=(0, 3), ag=0.3,
                                aw=0.05, f=3.0, Cg=1.0)
        drv.init(sol0, lattice_packets(4, g.Lx, g.Ly, k0=5.0))
        drv.run(n_frames=3, flow_steps_per_frame=2)
        ckpt = str(tmp_path / "state.npz")
        drv.checkpoint(ckpt)
        drv.run(n_frames=3, flow_steps_per_frame=2)
        ref_sol = np.asarray(drv.sim.sol)
        ref_x = np.asarray(drv.sim.packets.x)

        # fresh driver: restore mid-state (incl. AB3 history) and re-run
        drv2 = make_rsw_driver(tmp_path, g, with_outputs=False)
        drv2.init(sol0, lattice_packets(4, g.Lx, g.Ly, k0=5.0))
        drv2.restore(ckpt)
        drv2.run(n_frames=3, flow_steps_per_frame=2)
        np.testing.assert_array_equal(np.asarray(drv2.sim.sol), ref_sol)
        np.testing.assert_array_equal(np.asarray(drv2.sim.packets.x), ref_x)


class TestBirthDeathProduction:
    def test_coupled_run_with_births(self, tmp_path, rng):
        """Birth/death wired into the coupled frame: short lifetimes force
        rebirths; population telemetry written; reborn packets carry k0
        (BirthDeathPackets.ipynb cells 1-4 -> production)."""
        g = make_grid(32)
        drv = make_rsw_driver(tmp_path, g, birth_death=True, bd_lam=0.02,
                              bd_k_shape=1.5)
        sol0 = band_geo_wave_ic(g, rng, Kg=(4, 6), Kw=(0, 3), ag=0.3,
                                aw=0.05, f=3.0, Cg=1.0)
        drv.init(sol0, lattice_packets(4, g.Lx, g.Ly, k0=5.0, k_ring=True))
        assert drv.sim.bd is not None
        drv.run(n_frames=6, flow_steps_per_frame=4)
        drv.close()
        births = int(drv.sim.bd.births)
        assert births > 0, "no rebirths with mean lifetime << run length"
        # telemetry recorded
        preader = SequencedReader(str(tmp_path / "packets"))
        steps = preader.steps("p/births")
        assert len(steps) == 6
        assert int(preader.read(f"p/births/{steps[-1]}")) == births

    def test_checkpoint_resumes_stochastic_stream(self, tmp_path, rng):
        """Checkpoint/resume is bit-exact INCLUDING the birth/death PRNG key:
        the resumed run reproduces the original rebirth sequence."""
        g = make_grid(32)
        kw = dict(with_outputs=False, birth_death=True, bd_lam=0.05)
        drv = make_rsw_driver(tmp_path, g, **kw)
        sol0 = band_geo_wave_ic(g, rng, Kg=(4, 6), Kw=(0, 3), ag=0.3,
                                aw=0.05, f=3.0, Cg=1.0)
        pk = lattice_packets(4, g.Lx, g.Ly, k0=5.0, k_ring=True)
        drv.init(sol0, pk)
        drv.run(n_frames=3, flow_steps_per_frame=2)
        ckpt = str(tmp_path / "bd_state.npz")
        drv.checkpoint(ckpt)
        drv.run(n_frames=4, flow_steps_per_frame=2)
        ref_x = np.asarray(drv.sim.packets.x)
        ref_births = int(drv.sim.bd.births)
        ref_key = np.asarray(drv.sim.bd.key)

        drv2 = make_rsw_driver(tmp_path, g, **kw)
        drv2.init(sol0, pk)
        drv2.restore(ckpt)
        drv2.run(n_frames=4, flow_steps_per_frame=2)
        np.testing.assert_array_equal(np.asarray(drv2.sim.packets.x), ref_x)
        assert int(drv2.sim.bd.births) == ref_births
        np.testing.assert_array_equal(np.asarray(drv2.sim.bd.key), ref_key)

    def test_restore_rejects_mismatched_structure(self, tmp_path, rng):
        """Loading a checkpoint written with a structurally different state
        (birth/death ON) into a driver without it must raise, not restore
        silently wrong (treedef verified on load)."""
        g = make_grid(32)
        sol0 = band_geo_wave_ic(g, rng, Kg=(4, 6), Kw=(0, 3), ag=0.3,
                                aw=0.05, f=3.0, Cg=1.0)
        pk = lattice_packets(4, g.Lx, g.Ly, k0=5.0, k_ring=True)
        drv = make_rsw_driver(tmp_path, g, with_outputs=False,
                              birth_death=True, bd_lam=0.05)
        drv.init(sol0, pk)
        drv.run(n_frames=1, flow_steps_per_frame=2)
        ckpt = str(tmp_path / "bd_only.npz")
        drv.checkpoint(ckpt)

        drv2 = make_rsw_driver(tmp_path, g, with_outputs=False)
        drv2.init(sol0, pk)
        with pytest.raises(ValueError, match="structure|leaves"):
            drv2.restore(ckpt)


class TestICs:
    def test_band_geo_wave_amplitudes(self, rng):
        g = make_grid(64)
        f, Cg = 3.0, 1.0
        sol = band_geo_wave_ic(g, rng, Kg=(10, 13), Kw=(2, 5), ag=1.5,
                               aw=0.1, f=f, Cg=Cg)
        u = irfft2(sol[0], g.nx)
        v = irfft2(sol[1], g.nx)
        speed = np.asarray(jnp.sqrt(u**2 + v**2))
        # total speed should be near ag (geo dominates), within reason
        assert 0.8 < speed.max() < 2.5
        # reality: state survives an irfft/rfft round trip
        back = rfft2(irfft2(sol, g.nx))
        scale = float(jnp.max(jnp.abs(sol)))
        np.testing.assert_allclose(np.asarray(back), np.asarray(sol),
                                   atol=1e-6 * scale)

    def test_front_ic_finite_and_normalised(self, rng):
        g = make_grid(64)
        sol = front_ic(g, rng, n_waves=5, aw=0.2, f=3.0, Cg=1.0)
        u = irfft2(sol[0], g.nx)
        v = irfft2(sol[1], g.nx)
        speed = np.asarray(jnp.sqrt(u**2 + v**2))
        np.testing.assert_allclose(speed.max(), 0.2, rtol=1e-3)

    def test_upsample_roundtrip(self, rng):
        g_small = make_grid(32)
        g_big = make_grid(64)
        psih = random_band_psih(g_small, rng, kband=(2, 6), amp=1.0)
        snap = np.asarray(jnp.stack([psih, 2 * psih, -psih]))
        up = upsample_snapshot(snap, g_big)
        # physical field must match the original on the coarse points
        f_small = np.asarray(irfft2(jnp.asarray(snap[0]), g_small.nx))
        f_big = np.asarray(irfft2(up[0], g_big.nx))
        np.testing.assert_allclose(f_big[::2, ::2], f_small, atol=1e-4)

    def test_derive_dt_nu_formulas(self):
        assert derive_dt(0.1, 2.0, 0.01) == pytest.approx(5e-4)
        nu = derive_nu(1.0, 512, 4, 1e-3)
        kmax = 512 / 2 - 1
        assert nu == pytest.approx(2 * np.pi / 512 / kmax**8 / 1e-3)


class TestConfig:
    def test_sweep_table_and_overrides(self, tmp_path):
        table = tmp_path / "params.txt"
        table.write_text(
            "ArrayTaskID ag aw\n"
            "1 1.5 0.1\n"
            "2 2.0 0.2\n"
        )
        rows = load_sweep_table(str(table))
        assert rows[1]["ag"] == "2.0"
        cfg = RSWRaytracingConfig()
        cfg = apply_overrides(cfg, {"ic.ag": rows[1]["ag"], "domain.nx": 64})
        assert cfg.ic.ag == 2.0 and cfg.domain.nx == 64

    def test_packet_config_k0(self):
        cfg = RSWRaytracingConfig()
        k0 = cfg.packets.k0(cfg.f)
        assert k0 == pytest.approx(np.sqrt((2 * 3.0) ** 2 - 9.0) / 1.0)
