"""Thomas-Yamada experiment driver: two-phase coarse->fine run.

Functional re-design of the reference thomasyamada/TYdriver.jl:111-231:

- phase 1 ("startup"): coarse-dt problem integrates the eigenbasis-projected
  random IC (or a restart snapshot) through the stiff initial transient,
  writing a ``startup`` output file and wave/geo + barotropic energy
  diagnostics (TYdriver.jl:122-179);
- handoff: a fine-dt problem continues from the startup state and clock
  (TYdriver.jl:181-191 — the reference also moves GPU->CPU here; here the
  same jitted step simply gets a new dt table);
- phase 2: main loop with per-frame enforce_reality + rolling outputs +
  diagnostics (TYdriver.jl:208-228).

Per-frame diagnostics record wave/geo energies (TYdriver.jl:152-155) through
``wave_geostrophic_energy`` and ``barotropic_energy``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spectral import enforce_reality
from ..core.steppers import zero_clock
from ..core.transfer import to_host
from ..io.output import SequencedWriter, save_problem
from ..models import thomasyamada
from ..models.base import build_stepper, run

__all__ = ["TYRunConfig", "run_thomasyamada",
           "run_thomasyamada_sharded", "ty_restart_solution"]


@dataclass
class TYRunConfig:
    nx: int = 128
    Lx: float = 2.0 * np.pi
    nu: float = 3.5e-25
    nnu: int = 8
    Ro: float = 0.2
    stepper: str = "ETDRK4"
    # two-phase stepping (TYdriver.jl / Parameters: startup_dt >> dt)
    startup_dt: float = 5e-3
    startup_nsteps: int = 200
    startup_nsubs: int = 50
    dt: float = 1e-3
    nsteps: int = 1000
    nsubs: int = 50
    # IC bands/amplitudes (set_initial_condition, TYdriver.jl:35-91)
    k0g_range: tuple = (2.0, 6.0)
    k0w_range: tuple = (0.0, 4.0)
    at: float = 0.1
    ag: float = 0.1
    aw: float = 0.05
    seed: int = 5678
    # restart (TYdriver.jl:28-33 set_initial_condition_from_file)
    restart_file: str | None = None
    restart_key: str = "snapshots/sol"
    restart_frame: int | None = None   # default: last frame
    # output
    out_dir: str = "."
    base_filename: str = "ty"
    max_writes: int = 300
    diag_freq_frames: int = 1
    log_fn: callable = print


def ty_restart_solution(path: str, key: str = "snapshots/sol",
                        frame: int | None = None):
    """Load a (4, nl, nkr) TY state from a finished run
    (set_initial_condition_from_file, TYdriver.jl:28-33)."""
    from ..io.output import SequencedReader

    reader = SequencedReader(path)
    steps = reader.steps(key)
    step = steps[-1] if frame is None else frame
    from ..core.transfer import to_device

    return to_device(np.asarray(reader.load(step, key), np.complex64)), step


def _phase(model, cfg: TYRunConfig, sol, clock, dt, nsteps, nsubs, writer,
           diags, label, start_wall):
    """One stepping phase: jitted nsubs-chunks with reality enforcement,
    diagnostics and rolling writes between chunks."""
    grid = model.grid
    init_fn, step_fn = build_stepper(model, cfg.stepper, dt)
    state = init_fn(sol)

    @jax.jit
    def chunk(sol, clock, state):
        sol, clock, state = run(step_fn, sol, clock, state, nsubs)
        return enforce_reality(sol, grid), clock, state

    # jitted so the complex numpy eigenbases embed as executable constants
    @jax.jit
    def wave_geo_diag(sol):
        return thomasyamada.wave_geostrophic_energy(sol, grid)

    frames = max(int(round(nsteps / nsubs)), 1)
    for j in range(frames):
        sol, clock, state = chunk(sol, clock, state)
        solh = to_host(sol)
        if not np.isfinite(solh).all():
            raise FloatingPointError(
                f"TY {label}: NaN/Inf at t={float(clock.t):.3f}"
            )
        if j % cfg.diag_freq_frames == 0:
            wave, geo = wave_geo_diag(sol)
            diags["t"].append(float(clock.t))
            diags["wave_ke"].append(float(wave[0]))
            diags["wave_pe"].append(float(wave[1]))
            diags["geo_ke"].append(float(geo[0]))
            diags["geo_pe"].append(float(geo[1]))
            diags["barotropic"].append(
                float(thomasyamada.barotropic_energy(sol, grid))
            )
        if writer is not None:
            step = int(clock.step)
            writer.write_frame(step, sol=solh)
            writer.write(f"snapshots/t/{step}", float(clock.t))
        # CFL log from the baroclinic/barotropic max speeds (TYdriver.jl:166-171)
        u = thomasyamada_speeds(sol, grid)
        cfl = float(dt * u / min(grid.dx, grid.dy))
        cfg.log_fn(
            f"[{label}] step {int(clock.step):06d}, t: {float(clock.t):.2f}, "
            f"cfl: {cfl:.4f}, wall: {(time.time() - start_wall) / 60:.2f} min"
        )
    return sol, clock


def thomasyamada_speeds(sol, grid):
    """max(|ut|, |vt|, |uc|, |vc|) for the CFL log."""
    from ..core.spectral import irfft2

    zth, uch, vch = sol[0], sol[1], sol[2]
    psith = -zth * grid.invKrsq
    uth = -grid.il * psith
    vth = grid.ik * psith
    phys = irfft2(jnp.stack([uth, vth, uch, vch]), grid.nx)
    return float(jnp.max(jnp.abs(phys)))


def run_thomasyamada(cfg: TYRunConfig):
    """Full two-phase TY experiment; returns (sol, clock, diagnostics)."""
    from ..core.grid import make_grid
    from .initial_conditions import ty_initial_condition

    grid = make_grid(cfg.nx, Lx=cfg.Lx)
    model = thomasyamada.make_model(grid, nu=cfg.nu, nnu=cfg.nnu, Ro=cfg.Ro)
    start_wall = time.time()

    if cfg.restart_file:
        sol, step0 = ty_restart_solution(cfg.restart_file, cfg.restart_key,
                                         cfg.restart_frame)
        cfg.log_fn(f"restarted from {cfg.restart_file} frame {step0}")
    else:
        rng = np.random.default_rng(cfg.seed)
        sol = ty_initial_condition(grid, rng, cfg.k0g_range, cfg.k0w_range,
                                   cfg.at, cfg.ag, cfg.aw)
    clock = zero_clock()
    diags = {k: [] for k in ("t", "wave_ke", "wave_pe", "geo_ke", "geo_pe",
                             "barotropic")}

    os.makedirs(cfg.out_dir, exist_ok=True)
    # phase 1: coarse dt startup, its own output file (TYdriver.jl:141-179)
    startup_writer = SequencedWriter(
        os.path.join(cfg.out_dir, "startup"), cfg.max_writes
    )
    save_problem(startup_writer, grid, model.params, cfg.startup_dt)
    sol, clock = _phase(model, cfg, sol, clock, cfg.startup_dt,
                        cfg.startup_nsteps, cfg.startup_nsubs,
                        startup_writer, diags, "startup", start_wall)
    startup_writer.close()
    cfg.log_fn("Startup finished")

    # handoff: fine-dt problem continues from the startup state + clock
    # (TYdriver.jl:181-191)
    writer = SequencedWriter(
        os.path.join(cfg.out_dir, cfg.base_filename), cfg.max_writes
    )
    save_problem(writer, grid, model.params, cfg.dt)
    sol, clock = _phase(model, cfg, sol, clock, cfg.dt, cfg.nsteps,
                        cfg.nsubs, writer, diags, "main", start_wall)
    writer.close()

    # diagnostics file (savediagnostic, TYdriver.jl:229-230)
    import h5py

    with h5py.File(os.path.join(cfg.out_dir, "diagnostics.h5"), "w") as f:
        for k, v in diags.items():
            f[k] = np.asarray(v)
    return sol, clock, diags


def _phase_sharded(sh, cfg: TYRunConfig, sol_sh, clock, dt, nsteps, nsubs,
                   writer, diags, label, start_wall):
    """Sharded twin of ``_phase``: jitted nsubs-chunks of the slab-sharded
    IF-AB3 step, with host-side reality enforcement, diagnostics and rolling
    writes between chunks. ``sh`` is a ShardedThomasYamada built with this
    phase's dt (the handoff re-bootstraps AB3 history exactly like the
    reference's new-problem handoff, TYdriver.jl:181-191)."""
    from ..core.spectral import enforce_reality
    from ..core.transfer import to_device

    grid = sh.grid
    init_fn, step_fn = sh.stepper()
    state = init_fn(sol_sh)

    @jax.jit
    def chunk(sol, clock, state):
        (sol, clock, state), _ = jax.lax.scan(
            lambda c, _: (step_fn(*c), None), (sol, clock, state),
            None, length=nsubs)
        return sol, clock, state

    @jax.jit
    def wave_geo_diag(sol):
        return thomasyamada.wave_geostrophic_energy(sol, grid)

    @jax.jit
    def reality(sol):
        return enforce_reality(sol, grid)

    frames = max(int(round(nsteps / nsubs)), 1)
    for j in range(frames):
        sol_sh, clock, state = chunk(sol_sh, clock, state)
        solh = sh.unshard(sol_sh)
        if not np.isfinite(solh).all():
            raise FloatingPointError(
                f"TY {label} (sharded): NaN/Inf at t={float(clock.t):.3f}")
        # reality enforcement on the replicated pull, then re-shard (the
        # conjugate-symmetry sanitizer runs once per frame, matching the
        # replicated driver's per-chunk cadence)
        sol_dev = to_device(solh)
        sol_dev = reality(sol_dev)
        sol_sh = sh.shard_solution(sol_dev)
        if j % cfg.diag_freq_frames == 0:
            wave, geo = wave_geo_diag(sol_dev)
            diags["t"].append(float(clock.t))
            diags["wave_ke"].append(float(wave[0]))
            diags["wave_pe"].append(float(wave[1]))
            diags["geo_ke"].append(float(geo[0]))
            diags["geo_pe"].append(float(geo[1]))
            diags["barotropic"].append(
                float(thomasyamada.barotropic_energy(sol_dev, grid)))
        if writer is not None:
            step = int(clock.step)
            writer.write_frame(step, sol=solh)
            writer.write(f"snapshots/t/{step}", float(clock.t))
        u = thomasyamada_speeds(sol_dev, grid)
        cfl = float(dt * u / min(grid.dx, grid.dy))
        cfg.log_fn(
            f"[{label}] step {int(clock.step):06d}, t: {float(clock.t):.2f}, "
            f"cfl: {cfl:.4f}, wall: {(time.time() - start_wall) / 60:.2f} min"
            f" [sharded x{sh.mesh.shape[sh.axis]}]")
    return sol_sh, clock


def run_thomasyamada_sharded(cfg: TYRunConfig, mesh):
    """Two-phase TY run on the slab-sharded model (the
    sharded TY core gets the same proven CLI entry point as RSW/2LQG).

    Same structure as ``run_thomasyamada`` with each phase stepped by a
    ``ShardedThomasYamada`` built for that phase's dt; the stepper is the
    sharded IF-AB3 (the reference's ETDAB3 scheme class) regardless of
    cfg.stepper — the replicated path keeps ETDRK4 parity."""
    from ..core.grid import make_grid
    from ..core.steppers import zero_clock
    from ..models.thomasyamada import TYParams
    from ..parallel.sharded import ShardedThomasYamada
    from .initial_conditions import ty_initial_condition

    grid = make_grid(cfg.nx, Lx=cfg.Lx)
    params = TYParams(nu=cfg.nu, nnu=cfg.nnu, Ro=cfg.Ro)
    start_wall = time.time()

    if cfg.restart_file:
        sol, step0 = ty_restart_solution(cfg.restart_file, cfg.restart_key,
                                         cfg.restart_frame)
        cfg.log_fn(f"restarted from {cfg.restart_file} frame {step0}")
    else:
        rng = np.random.default_rng(cfg.seed)
        sol = ty_initial_condition(grid, rng, cfg.k0g_range, cfg.k0w_range,
                                   cfg.at, cfg.ag, cfg.aw)
    clock = zero_clock()
    diags = {k: [] for k in ("t", "wave_ke", "wave_pe", "geo_ke", "geo_pe",
                             "barotropic")}

    os.makedirs(cfg.out_dir, exist_ok=True)
    sh_coarse = ShardedThomasYamada(grid, params, mesh, dt=cfg.startup_dt)
    startup_writer = SequencedWriter(
        os.path.join(cfg.out_dir, "startup"), cfg.max_writes)
    save_problem(startup_writer, grid, params, cfg.startup_dt)
    sol_sh = sh_coarse.shard_solution(sol)
    sol_sh, clock = _phase_sharded(
        sh_coarse, cfg, sol_sh, clock, cfg.startup_dt, cfg.startup_nsteps,
        cfg.startup_nsubs, startup_writer, diags, "startup", start_wall)
    startup_writer.close()
    cfg.log_fn("Startup finished")

    sh = ShardedThomasYamada(grid, params, mesh, dt=cfg.dt)
    writer = SequencedWriter(
        os.path.join(cfg.out_dir, cfg.base_filename), cfg.max_writes)
    save_problem(writer, grid, params, cfg.dt)
    sol_sh = sh.shard_solution(sh_coarse.unshard(sol_sh))
    sol_sh, clock = _phase_sharded(
        sh, cfg, sol_sh, clock, cfg.dt, cfg.nsteps, cfg.nsubs,
        writer, diags, "main", start_wall)
    writer.close()

    import h5py

    with h5py.File(os.path.join(cfg.out_dir, "diagnostics.h5"), "w") as f:
        for k, v in diags.items():
            f[k] = np.asarray(v)
    return sh.unshard(sol_sh), clock, diags
