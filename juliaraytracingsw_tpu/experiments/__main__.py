"""CLI for the experiment drivers.

Subcommands mirror the reference entry points:

    rsw                RSW turbulence + packet ensemble, --model selects
                       the {rsw,linborg,modified,quadheight} variant
                       (rsw/RSWMain.jl, rsw/RSWRaytracingMain.jl ->
                       RaytracingDriver)
    swqg               SWQG turbulence + packets (swqg/SWQGMain.jl,
                       swqg/RaytracingDriver.jl)
    twolayer           TwoLayerQG + packets; --baroclinic selects the
                       baroclinic advecting flow; --ic-file consumes
                       simulation ICs (swqg/TwoLayerDriver.jl,
                       TwoLayerRaytracingDriver.jl, raytracing/
                       TwoLayerRaytracing.jl)
    twolayer-simulation  spin-up runs writing IC files
                       (simulation/TwoLayerSimulation.jl)
    single-wave        enveloped single-wave injection experiment
                       (rsw/SingleWaveRSWRaytracingDriver.jl)
    thomasyamada       Thomas-Yamada run (thomasyamada/TYdriver.jl)
    steady-raytracing  packets through a frozen snapshot
                       (raytracing/SteadyRaytracing.jl)
    sweep / omega-k / omega-k-plot / b-parameter / analyze
                       orchestration + offline analysis

Common flow per run: derive dt from CFL tune, derive hyperviscosity, build
model + driver, spinup, coupled frames with rolling outputs + diagnostics.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--L", type=float, default=2 * np.pi)
    p.add_argument("--cfltune", type=float, default=0.1)
    p.add_argument("--nutune", type=float, default=1.0)
    p.add_argument("--nnu", type=int, default=4)
    p.add_argument("--umax-estimate", type=float, default=2.0,
                   help="velocity scale for the CFL-derived dt")
    p.add_argument("--stepper", default="IFMAB3")
    p.add_argument("--use-filter", action="store_true")
    p.add_argument("--spinup-T", type=float, default=10.0)
    p.add_argument("--T", type=float, default=20.0)
    p.add_argument("--output-dt", type=float, default=1.0)
    p.add_argument("--max-writes", type=int, default=300)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--base-filename", default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--platform", default=None,
                   help="force jax platform (e.g. cpu)")
    p.add_argument("--distributed", action="store_true",
                   help="bring up jax.distributed from the scheduler "
                        "environment (SLURM/MPI/JRSW_* vars; "
                        "parallel/launcher.resolve_cluster) before building "
                        "the model")
    p.add_argument("--sharded", action="store_true",
                   help="kr-column-shard the flow state across all visible "
                        "devices (parallel/sharded.py slab FFTs + "
                        "all_to_all; packets data-parallel) — the "
                        "multi-chip production path for 1024^2+ grids; "
                        "requires ny %% n_devices == 0")
    p.add_argument("--checkpoint", default=None,
                   help="write a resumable checkpoint here at the end")
    p.add_argument("--restore", default=None,
                   help="resume from a checkpoint file")
    p.add_argument("--live", type=int, default=0, metavar="N",
                   help="refresh a live dashboard (<out-dir>/live.html) "
                        "every N frames (headless stand-in for the "
                        "reference's Makie Observables window, "
                        "TwoLayerSimulation.jl:44-70)")


def _add_packets(p: argparse.ArgumentParser):
    p.add_argument("--sqrt-npackets", type=int, default=16)
    p.add_argument("--omega0-over-f", type=float, default=2.0)
    p.add_argument("--k-ring", action="store_true", default=True)
    p.add_argument("--ray-substeps", type=int, default=1)
    p.add_argument("--ray-method", default="rk4",
                   choices=["rk4", "dopri5", "midpoint", "adaptive",
                            "adaptive7"],
                   help="'adaptive' = embedded Dormand-Prince 5(4) with "
                        "error control (GPURaytracing.jl Vern7 parity); "
                        "'adaptive7' = Fehlberg 7(8), the Vern7 order class "
                        "(see benchmarks/adaptive_order_study.py before "
                        "using it through interpolated fields)")
    p.add_argument("--ray-rtol", type=float, default=1e-5)
    p.add_argument("--ray-atol", type=float, default=1e-7)
    p.add_argument("--ray-max-steps", type=int, default=32)
    p.add_argument("--interp", default="bilinear",
                   choices=["bilinear", "bspline", "bicubic"])
    p.add_argument("--gather", default="auto",
                   choices=["auto", "patch", "taps"],
                   help="ray interpolation strategy: 'auto' (default) "
                        "picks per run from the patch-vs-taps crossover "
                        "(rays/raytrace.resolve_gather: patch iff "
                        "8*packets >= grid cells); 'patch' (pair-table "
                        "gather, for production-sized ensembles) or 'taps' "
                        "(per-stage tap gathers — for grids much larger "
                        "than the ensemble, because any patch path pays a "
                        "grid-sized table build per step)")
    p.add_argument("--table-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the gathered ray pair table; "
                        "bfloat16 halves the table's bytes at ~2^-8 "
                        "relative rounding of stored field values — "
                        "divergence bounded by tests/test_rays.py::"
                        "test_bf16_table_trajectory_divergence")
    p.add_argument("--frozen-flow", action="store_true")
    p.add_argument("--birth-death", action="store_true",
                   help="Weibull birth/death ensemble resampling "
                        "(Notebooks/BirthDeathPackets.ipynb)")
    p.add_argument("--bd-k-shape", type=float, default=1.5,
                   help="Weibull shape parameter of packet lifetimes")
    p.add_argument("--bd-lam", type=float, default=10.0,
                   help="Weibull scale (mean lifetime) of packets")


def _setup(args):
    from ..utils.compile_cache import setup_compile_cache

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    setup_compile_cache()
    if getattr(args, "distributed", False):
        from ..parallel.launcher import initialize_from_env

        spec = initialize_from_env()
        print(f"distributed: {spec.source} "
              f"process {spec.process_id}/{spec.num_processes}", flush=True)
    from ..coupled.driver import derive_dt, derive_nu
    from ..core.grid import make_grid

    grid = make_grid(args.nx, Lx=args.L)
    dt = derive_dt(args.cfltune, args.umax_estimate, grid.dx)
    nu = derive_nu(args.nutune, args.nx, args.nnu, dt)
    rng = np.random.default_rng(args.seed)
    return grid, dt, nu, rng


def _writers(args, default_base):
    from ..io.output import SequencedWriter

    base = args.base_filename or default_base
    snap = SequencedWriter(os.path.join(args.out_dir, base), args.max_writes)
    pkts = SequencedWriter(os.path.join(args.out_dir, "packets"),
                           args.max_writes)
    return snap, pkts


def _run_coupled(args, model, psih_fn, rp, sol0, packets, f, Cg,
                 diagnostics, default_base):
    from ..coupled.driver import CoupledDriver

    grid = model.grid
    dt = args.dt
    snap_w, pkt_w = _writers(args, default_base)
    drv = CoupledDriver(
        model=model, psih_fn=psih_fn, rp=rp, dt=dt, stepper=args.stepper,
        use_filter=args.use_filter,
        ray_substeps=args.ray_substeps, ray_method=args.ray_method,
        ray_opts=dict(rtol=args.ray_rtol, atol=args.ray_atol,
                      max_steps=args.ray_max_steps)
        if args.ray_method in ("adaptive", "adaptive7") else None,
        k_cutoff=100.0 * f / Cg,
        k0=float(np.sqrt((args.omega0_over_f * f) ** 2 - f * f) / Cg),
        frozen_flow=args.frozen_flow,
        birth_death=args.birth_death, bd_k_shape=args.bd_k_shape,
        bd_lam=args.bd_lam, bd_seed=args.seed,
        snapshot_writer=snap_w, packet_writer=pkt_w,
        diagnostics=diagnostics,
    )
    if getattr(args, "live", 0):
        from ..utils.live import LiveDashboard

        drv.live = LiveDashboard(args.out_dir, title=default_base,
                                 every=args.live)
    clock0 = None
    if getattr(args, "clock_t0", None):
        import jax.numpy as jnp

        from ..core.steppers import Clock

        clock0 = Clock(jnp.asarray(args.clock_t0, jnp.float32),
                       jnp.zeros((), jnp.int32))
    drv.init(sol0, packets, clock=clock0)
    if args.restore:
        drv.restore(args.restore)
    spinup_steps = int(args.spinup_T / dt)
    drv.spinup(spinup_steps)
    frames = max(int((args.T - args.spinup_T) / args.output_dt), 1)
    steps_per_frame = max(int(args.output_dt / dt), 1)
    drv.run(frames, steps_per_frame)
    drv.save_diagnostics(os.path.join(args.out_dir, "diagnostics.h5"))
    if args.checkpoint:
        drv.checkpoint(args.checkpoint)
    drv.close()
    print(f"done: t={float(drv.sim.clock.t):.3f}, "
          f"{frames} frames -> {args.out_dir}")


def _run_coupled_sharded(args, sh, rp, sol0, packets, f, Cg, diagnostics,
                         default_base, model):
    """Host loop for ``--sharded`` runs: kr-column-sharded flow frames with
    data-parallel packets (parallel/sharded.py), mirroring CoupledDriver's
    spinup / frames / outputs / NaN-guard / logging essentials."""
    import time

    import h5py
    import jax
    import jax.numpy as jnp

    from ..core.steppers import zero_clock
    from ..io.output import save_problem
    from ..parallel.mesh import shard_packets
    from ..rays.raytrace import sample_gradients, sample_velocity

    unsupported = [n for n, v in [("--frozen-flow", args.frozen_flow),
                                  ("--birth-death", args.birth_death)] if v]
    if unsupported:
        raise SystemExit(f"--sharded does not support {' '.join(unsupported)}"
                         " (use the replicated driver for those)")
    if args.ray_method not in ("rk4", "dopri5", "midpoint"):
        raise SystemExit("--sharded supports --ray-method rk4|dopri5|midpoint")

    grid, dt = model.grid, args.dt
    k0 = float(np.sqrt((args.omega0_over_f * f) ** 2 - f * f) / Cg)
    snap_w, pkt_w = _writers(args, default_base)
    save_problem(snap_w, grid, model.params, dt)
    pkt_w.write("params/f0", rp.f)
    pkt_w.write("params/Cg", rp.Cg)
    pkt_w.write("params/dt", dt)
    pkt_w.write("params/N", packets.n)
    pkt_w.write("params/omega_sign", np.asarray(packets.sign))

    init_fn, step_fn = sh.stepper()
    sol = sh.shard_solution(sol0)
    clock, state = zero_clock(), init_fn(sol)
    pk = shard_packets(packets, sh.mesh)

    def ckpt_tree():
        # host-side, UNSHARDED state pytree: checkpoints are portable
        # across mesh sizes (re-sharded on restore); AB3 history included
        # (bit-exact resume, io/checkpoint.py)
        return {"sol": sh.unshard(sol), "clock": clock,
                "N1": sh.unshard(state.N1), "N2": sh.unshard(state.N2),
                "packets": pk}

    if args.restore:
        from ..core.steppers import AB3State
        from ..core.transfer import to_host
        from ..io.checkpoint import load_checkpoint

        tree = load_checkpoint(args.restore, ckpt_tree())
        sol = sh.shard_solution(to_host(tree["sol"]))
        clock = tree["clock"]
        state = AB3State(sh.shard_solution(to_host(tree["N1"])),
                         sh.shard_solution(to_host(tree["N2"])))
        pk = shard_packets(tree["packets"], sh.mesh)
        print(f"restored {args.restore}: t={float(clock.t):.3f} "
              f"step={int(clock.step)}")
    t_wall = time.time()

    def check_nan(where):
        if not np.isfinite(sh.unshard(sol)).all():
            snap_w.flush(); pkt_w.flush()
            raise FloatingPointError(f"solution is NaN/Inf at {where}")

    # flow-only spinup in jitted scan chunks
    spinup_steps = int(args.spinup_T / dt)
    done = 0
    while done < spinup_steps:
        n = min(500, spinup_steps - done)

        @jax.jit
        def spin(sol, clock, state, _n=n):
            (sol, clock, state), _ = jax.lax.scan(
                lambda c, x: (step_fn(*c), None), (sol, clock, state),
                None, length=_n)
            return sol, clock, state

        sol, clock, state = spin(sol, clock, state)
        done += n
        check_nan("spinup")

    frames = max(int((args.T - args.spinup_T) / args.output_dt), 1)
    steps_per_frame = max(int(args.output_dt / dt), 1)
    frame = sh.make_coupled_frame(rp, steps_per_frame,
                                  ray_substeps=args.ray_substeps,
                                  ray_method=args.ray_method,
                                  k_cutoff=100.0 * f / Cg, k0=k0)
    diag_times, diag_series = [], {n: [] for n in (diagnostics or {})}
    for i in range(frames):
        sol, clock, state, pk = frame(sol, clock, state, pk)
        check_nan(f"frame {i}")
        sol_host = sh.unshard(sol)
        fields = sh.fields(sol)
        step = int(clock.step)
        diag_times.append(float(clock.t))
        from ..core.transfer import to_device

        sol_dev = to_device(sol_host)
        for name, fn in (diagnostics or {}).items():
            diag_series[name].append(
                np.asarray(fn(sol_dev, grid, model.params)))
        u, v = sample_velocity(pk, fields, rp)
        gx = sample_gradients(pk, fields, rp)
        pkt_w.write_packets(
            step, float(clock.t),
            x=np.stack([np.asarray(pk.x), np.asarray(pk.y)], 1),
            k=np.stack([np.asarray(pk.k), np.asarray(pk.l)], 1),
            u=np.stack([np.asarray(u), np.asarray(v)], 1),
            g=np.stack([np.asarray(a) for a in gx], 1),
        )
        snap_w.write_frame(step, sol=sol_host)
        snap_w.write(f"snapshots/t/{step}", float(clock.t))
        umax = float(jnp.max(jnp.abs(fields[:2])))
        print(f"step: {step:06d}, t: {float(clock.t):.2f}, "
              f"cfl: {dt * umax / min(grid.dx, grid.dy):.2e}, "
              f"wall: {(time.time() - t_wall) / 60:.2f} min "
              f"[sharded x{sh.mesh.shape[sh.axis]}]")
    with h5py.File(os.path.join(args.out_dir, "diagnostics.h5"), "w") as fh:
        fh["t"] = np.asarray(diag_times)
        for name, series in diag_series.items():
            fh[name] = np.asarray(series)
    if args.checkpoint:
        from ..io.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, ckpt_tree())
        print(f"checkpoint -> {args.checkpoint}")
    snap_w.close(); pkt_w.close()
    print(f"done: t={float(clock.t):.3f}, {frames} frames -> {args.out_dir}")


def cmd_rsw(args):
    """RSW turbulence (+ packets) with selectable model variant — the
    framework's replacement for the reference's file-swap configuration
    (rsw/rsw-driver.sbatch copies {Linborg,Modified,QuadHeight}ShallowWater.jl
    over RotatingShallowWater.jl)."""
    from ..coupled.initial_conditions import band_geo_wave_ic, front_ic
    from ..models import linborg, modified_sw, quadheight, rsw
    from ..rays.packets import lattice_packets
    from ..rays.raytrace import RayParams, resolve_gather
    from ..core.spectral import rfft2, irfft2
    import jax.numpy as jnp

    grid, dt, nu, rng = _setup(args)
    args.dt = dt
    f, Cg = args.f_over_cg * args.cg, args.cg
    factory = {"rsw": rsw, "linborg": linborg, "modified": modified_sw,
               "quadheight": quadheight}[args.model]
    model = factory.make_model(grid, nu=nu, nnu=args.nnu, f=f, Cg=Cg)
    params = model.params

    if args.ic == "front":
        sol0 = front_ic(grid, rng, n_waves=10, aw=args.aw, f=f, Cg=Cg)
    else:
        sol0 = band_geo_wave_ic(grid, rng, Kg=tuple(args.Kg),
                                Kw=tuple(args.Kw), ag=args.ag, aw=args.aw,
                                f=f, Cg=Cg)

    if args.model == "quadheight":
        # prognostic m = 1/(1+eta): convert the (u, v, eta) IC
        # (QuadHeightModifiedShallowWater.jl:337-344 set_solution!)
        sol0 = quadheight.set_solution(sol0[0], sol0[1], sol0[2], grid)

        def psih_fn(sol):
            # recover eta = 1/m - 1, then PV-inversion streamfunction
            m = irfft2(sol[2], grid.nx)
            etah = rfft2(1.0 / m - 1.0)
            Kd2 = f * f / (Cg * Cg)
            qh = grid.ik * sol[1] - grid.il * sol[0] - f * etah
            return -qh / (grid.Krsq + Kd2)

        diags = {
            "kinetic_energy": lambda s, g, p: quadheight.kinetic_energy(s, g),
            "potential_energy":
                lambda s, g, p: quadheight.potential_energy(s, g, p),
        }
    else:
        def psih_fn(sol):
            Kd2 = f * f / (Cg * Cg)
            qh = grid.ik * sol[1] - grid.il * sol[0] - f * sol[2]
            return -qh / (grid.Krsq + Kd2)

        diags = {
            "kinetic_energy": lambda s, g, p: rsw.kinetic_energy(s, g),
            "potential_energy": lambda s, g, p: rsw.potential_energy(s, g, p),
        }

    rp = RayParams(f=f, Cg=Cg, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=args.interp,
                   table_dtype=args.table_dtype, gather=args.gather)
    rp = resolve_gather(rp, args.sqrt_npackets ** 2, grid.ny, grid.nx)
    packets = lattice_packets(
        args.sqrt_npackets, grid.Lx, grid.Ly,
        k0=float(np.sqrt((args.omega0_over_f * f) ** 2 - f * f) / Cg),
        k_ring=args.k_ring,
    ) if args.with_packets else lattice_packets(1, grid.Lx, grid.Ly, k0=1.0)

    if args.sharded:
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded_rsw import (
            ShardedLinborg, ShardedModifiedSW, ShardedQuadHeight, ShardedRSW)

        scls = {"rsw": ShardedRSW, "linborg": ShardedLinborg,
                "modified": ShardedModifiedSW,
                "quadheight": ShardedQuadHeight}[args.model]
        sh = scls(grid, params, make_mesh(), dt=dt, interp=args.interp)
        _run_coupled_sharded(args, sh, rp, sol0, packets, f, Cg, diags,
                             args.model if args.model != "rsw" else "rsw",
                             model)
        return
    _run_coupled(args, model, psih_fn, rp, sol0, packets, f, Cg, diags,
                 args.model if args.model != "rsw" else "rsw")


def cmd_swqg(args):
    from ..coupled.initial_conditions import random_band_psih
    from ..models import swqg
    from ..rays.packets import lattice_packets
    from ..rays.raytrace import RayParams, resolve_gather

    grid, dt, nu, rng = _setup(args)
    args.dt = dt
    f, Cg = args.f, args.cg
    model = swqg.make_model(grid, nu=nu, nnu=args.nnu, f=f, Cg=Cg)
    psih0 = random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag)
    sol0 = swqg.pv_from_streamfunction(psih0, grid, model.params)

    psih_fn = lambda s: swqg.streamfunction_from_pv(s, grid, model.params)
    rp = RayParams(f=f, Cg=Cg, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=args.interp,
                   table_dtype=args.table_dtype, gather=args.gather)
    rp = resolve_gather(rp, args.sqrt_npackets ** 2, grid.ny, grid.nx)
    packets = lattice_packets(
        args.sqrt_npackets, grid.Lx, grid.Ly,
        k0=float(np.sqrt((args.omega0_over_f * f) ** 2 - f * f) / Cg),
        k_ring=args.k_ring,
    )
    diags = {
        "energy": lambda s, g, p: swqg.energy(s, g, p),
        "enstrophy": lambda s, g, p: swqg.enstrophy(s, g, p),
    }
    if args.sharded:
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded import ShardedSWQG

        sh = ShardedSWQG(grid, model.params, make_mesh(), dt=dt,
                         interp=args.interp)
        _run_coupled_sharded(args, sh, rp, sol0, packets, f, Cg, diags,
                             "swqg", model)
        return
    _run_coupled(args, model, psih_fn, rp, sol0, packets, f, Cg, diags, "swqg")


def _run_multilayer(args, grid, dt, nu, rng, f, Cg, U, mu):
    """n-layer (>2) path of the ``twolayer`` command: the general
    MultiLayerQG model (models/multilayerqg, the GeophysicalFlows
    MultiLayerQG equivalent the reference drivers build problems from) with
    data-parallel packets advected by the depth-weighted barotropic mean
    streamfunction; ``--sharded`` runs it on ShardedMultiLayerQG."""
    from ..coupled.initial_conditions import random_band_psih
    from ..models import multilayerqg as mlqg
    from ..rays.packets import lattice_packets
    from ..rays.raytrace import RayParams, resolve_gather
    import jax
    import jax.numpy as jnp

    if args.ic_file:
        raise SystemExit("--ic-file is two-layer-only (its reference layout "
                         "stores exactly two layers)")
    if args.baroclinic:
        raise SystemExit("--baroclinic is two-layer-only; the n-layer path "
                         "advects with the depth-weighted barotropic mean")
    n = args.nlayers
    # equal-depth n-layer generalisation of TwoLayerQG's coupling
    # F = 2 f0^2/(Cg^2 drho/rho0) (swqg/TwoLayerQG.jl:23-30): shear spread
    # linearly from +U to -U, F/2 per interface
    F = 2.0 * f * f / (Cg * Cg) / args.drho_rho0
    Us = tuple(float(u) for u in np.linspace(U, -U, n))
    model = mlqg.make_model(grid, U=Us, beta=0.0, mu=mu, nu=nu,
                            nnu=args.nnu, Fcoup=tuple(F / 2.0 for _ in
                                                      range(n - 1)))
    psih0 = jnp.stack([
        random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag)
        for _ in range(n)])
    sol0 = mlqg.pv_from_streamfunction(psih0, grid, model.params)
    w = np.asarray(model.params.delta, np.float32)

    def psih_fn(s):
        psih = mlqg.streamfunction_from_pv(s, grid, model.params)
        return jnp.tensordot(jnp.asarray(w), psih, axes=(0, 0),
                             precision=jax.lax.Precision.HIGHEST)

    rp = RayParams(f=f, Cg=Cg, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=args.interp,
                   table_dtype=args.table_dtype, gather=args.gather)
    rp = resolve_gather(rp, args.sqrt_npackets ** 2, grid.ny, grid.nx)
    packets = lattice_packets(
        args.sqrt_npackets, grid.Lx, grid.Ly,
        k0=float(np.sqrt((args.omega0_over_f * f) ** 2 - f * f) / Cg),
        k_ring=args.k_ring,
    )
    diags = {
        "kinetic_energy": lambda s, g, p: np.asarray(
            mlqg.kinetic_energy(s, g, p)),
        "potential_energy": lambda s, g, p: np.asarray(
            mlqg.potential_energy(s, g, p)),
    }
    if args.sharded:
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded import ShardedMultiLayerQG

        sh = ShardedMultiLayerQG(grid, model.params, make_mesh(), dt=dt,
                                 interp=args.interp)
        _run_coupled_sharded(args, sh, rp, sol0, packets, f, Cg, diags,
                             f"{n}Lqg", model)
        return
    _run_coupled(args, model, psih_fn, rp, sol0, packets, f, Cg, diags,
                 f"{n}Lqg")


def cmd_twolayer(args):
    from ..coupled.driver import derive_nu
    from ..coupled.initial_conditions import random_band_psih
    from ..models import twolayerqg
    from ..rays.packets import lattice_packets
    from ..rays.raytrace import RayParams, resolve_gather
    import jax.numpy as jnp

    grid, dt, nu, rng = _setup(args)
    args.dt = dt
    f, Cg = args.f, args.cg
    U, mu = args.U, args.mu
    if args.nlayers > 2:
        return _run_multilayer(args, grid, dt, nu, rng, f, Cg, U, mu)
    psih0 = None
    if args.ic_file:
        # production chain parity: TwoLayerSimulation writes the IC file,
        # TwoLayerRaytracing consumes psih + params + dt from it
        # (raytracing/TwoLayerRaytracing.jl:162-182)
        from ..io.jld2 import load_twolayer_ic

        psih_np, t0, params, dt_file = load_twolayer_ic(args.ic_file)
        Uf = np.asarray(params.get("U", U))
        if Uf.ndim and Uf.size == 2 and not np.isclose(Uf[0], -Uf[1]):
            # the equal-depth TwoLayerQG model assumes layer velocities
            # (+U, -U); a genuine asymmetric reference U vector would be
            # silently misconfigured by the max|U| collapse
            print(f"WARNING: IC file stores asymmetric layer velocities "
                  f"U={Uf.tolist()}; this model supports only (+U, -U) and "
                  f"adopts max|U| — results will differ from the reference",
                  file=sys.stderr)
        U = float(np.max(np.abs(Uf))) if Uf.ndim else float(Uf)
        mu = float(params.get("μ", mu))
        # adopt the file's dt and resume the clock at the stored t — the
        # reference chain does both (TwoLayerRaytracing.jl:168 reads
        # clock/dt; the run continues the spun-up trajectory). nu is
        # CFL-dt-derived in _setup, so re-derive it for the adopted dt.
        dt = args.dt = float(dt_file)
        nu = derive_nu(args.nutune, args.nx, args.nnu, dt)
        args.clock_t0 = float(t0)
        bfield = np.asarray(params.get("b", ()))
        if bfield.size == 2 and bfield[0] != 0:
            args.drho_rho0 = float((bfield[0] - bfield[1]) / bfield[0])
        print(f"IC file {args.ic_file}: t0={t0:.3f} U={U} mu={mu} "
              f"dt={dt} drho_rho0={args.drho_rho0} (file values adopted)")
        # the loaded spectrum goes through the transfer helper
        from ..core.transfer import to_device

        psih0 = to_device(psih_np, jnp.complex64)
        if psih0.shape != (2, grid.ny, grid.nkr):
            raise SystemExit(
                f"IC psih shape {psih0.shape} does not match grid "
                f"(2, {grid.ny}, {grid.nkr}) — pass the matching --nx")
    model = twolayerqg.make_model(grid, U=U, mu=mu, nu=nu,
                                  nnu=args.nnu, f0=f, Cg=Cg,
                                  drho_rho0=args.drho_rho0)
    if psih0 is None:
        psih0 = jnp.stack([
            random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag),
            random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag),
        ])
    sol0 = twolayerqg.pv_from_streamfunction(psih0, grid, model.params)

    sgn = -1.0 if args.baroclinic else 1.0

    def psih_fn(s):
        psih = twolayerqg.streamfunction_from_pv(s, grid, model.params)
        # barotropic (psi1+psi2)/2 or baroclinic (psi1-psi2)/2 advection
        # (raytracing/TwoLayerRaytracing.jl:122, swqg/TwoLayerRaytracingDriver.jl:232)
        return 0.5 * (psih[0] + sgn * psih[1])

    rp = RayParams(f=f, Cg=Cg, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=args.interp,
                   table_dtype=args.table_dtype, gather=args.gather)
    rp = resolve_gather(rp, args.sqrt_npackets ** 2, grid.ny, grid.nx)
    packets = lattice_packets(
        args.sqrt_npackets, grid.Lx, grid.Ly,
        k0=float(np.sqrt((args.omega0_over_f * f) ** 2 - f * f) / Cg),
        k_ring=args.k_ring,
    )
    diags = {
        "kinetic_energy": lambda s, g, p: np.asarray(
            twolayerqg.kinetic_energy(s, g, p)),
        "potential_energy": lambda s, g, p: twolayerqg.potential_energy(s, g, p),
    }
    if args.sharded:
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded import ShardedTwoLayerQG

        sh = ShardedTwoLayerQG(
            grid, model.params, make_mesh(), dt=dt, interp=args.interp,
            advect="baroclinic" if args.baroclinic else "barotropic")
        _run_coupled_sharded(args, sh, rp, sol0, packets, f, Cg, diags,
                             "2Lqg", model)
        return
    _run_coupled(args, model, psih_fn, rp, sol0, packets, f, Cg, diags, "2Lqg")


def cmd_thomasyamada(args):
    """Two-phase Thomas-Yamada run (TYdriver.jl:111-231): eigenbasis-
    projected random IC (or restart-from-file), coarse-dt startup, fine-dt
    main phase, per-frame wave/geo energy diagnostics."""
    from ..utils.compile_cache import setup_compile_cache

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    setup_compile_cache()
    from ..coupled.ty_driver import TYRunConfig, run_thomasyamada
    from ..models import thomasyamada
    from ..core.grid import make_grid

    grid = make_grid(args.nx, Lx=args.L)
    stepper = args.stepper if args.stepper != "IFMAB3" else "ETDRK4"
    dt = args.ty_dt
    cfg = TYRunConfig(
        nx=args.nx, Lx=args.L, nu=args.ty_nu, nnu=args.ty_nnu, Ro=args.Ro,
        stepper=stepper,
        startup_dt=dt * args.startup_dt_factor,
        startup_nsteps=int(args.startup_T / (dt * args.startup_dt_factor)),
        startup_nsubs=max(int(args.output_dt / (dt * args.startup_dt_factor)), 1),
        dt=dt,
        nsteps=int(args.T / dt),
        nsubs=max(int(args.output_dt / dt), 1),
        k0g_range=tuple(args.Kg), k0w_range=tuple(args.Kw),
        at=args.at, ag=args.ag, aw=args.aw, seed=args.seed,
        restart_file=args.restart_file, restart_frame=args.restart_frame,
        out_dir=args.out_dir, base_filename=args.base_filename or "ty",
        max_writes=args.max_writes,
    )
    if args.sharded:
        from ..coupled.ty_driver import run_thomasyamada_sharded
        from ..parallel.mesh import make_mesh

        sol, clock, diags = run_thomasyamada_sharded(cfg, make_mesh())
    else:
        sol, clock, diags = run_thomasyamada(cfg)
    # final-energy readout under jit with the state embedded as a HOST
    # numpy constant (core/transfer.py policy)
    import jax
    from ..core.transfer import to_host

    sol_np = np.ascontiguousarray(to_host(sol))
    ke, pe = jax.jit(lambda: thomasyamada.baroclinic_energy(sol_np, grid))()
    print(f"done: t={float(clock.t):.3f} baroclinic KE={float(ke):.4g} "
          f"PE={float(pe):.4g} wave KE={diags['wave_ke'][-1]:.4g} "
          f"geo KE={diags['geo_ke'][-1]:.4g}")


def cmd_steady_raytracing(args):
    """Packets through a frozen flow snapshot (raytracing/SteadyRaytracing.jl)."""
    from ..coupled.initial_conditions import random_band_psih
    from ..io.output import SequencedWriter
    from ..models import swqg
    from ..rays.packets import lattice_packets
    from ..rays.raytrace import (RayParams, fields_from_psih, raytrace,
                                 resolve_gather, sample_velocity)

    grid, dt, nu, rng = _setup(args)
    f, Cg = args.f, args.cg
    if args.snapshot_file:
        from ..io.jld2 import load_array

        psih_np = load_array(args.snapshot_file, args.snapshot_key)
        from ..core.transfer import to_device

        psih = to_device(psih_np.astype(np.complex64))
    else:
        psih = random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag)
    # time-rescaled packet clock: rays run on tspan scaled by s with
    # Cg -> Cg/s (packetVelocityScale, SteadyRaytracing.jl:120-129,203-204 —
    # s = Fr * Cg / rms_U tunes the advection/dispersion ratio)
    s = args.packet_velocity_scale
    rp = RayParams(f=f, Cg=Cg / s, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=args.interp,
                   table_dtype=args.table_dtype, gather=args.gather)
    rp = resolve_gather(rp, args.sqrt_npackets ** 2, grid.ny, grid.nx)
    fields = fields_from_psih(psih, grid, args.interp)
    packets = lattice_packets(
        args.sqrt_npackets, grid.Lx, grid.Ly,
        k0=float(np.sqrt((args.omega0_over_f * f) ** 2 - f * f) / Cg),
        k_ring=args.k_ring,
    )
    writer = SequencedWriter(os.path.join(args.out_dir, "packets"),
                             args.max_writes)
    nframes = max(int(args.T / args.output_dt), 1)
    sub = max(int(round(s * args.output_dt / dt)), 1)
    t = 0.0
    for i in range(nframes):
        packets = raytrace(packets, fields, fields, s * t,
                           s * (t + args.output_dt),
                           rp, nsubsteps=sub, method=args.ray_method)
        t += args.output_dt
        u, v = sample_velocity(packets, fields, rp)
        writer.write_packets(
            i, t,
            x=np.stack([np.asarray(packets.x), np.asarray(packets.y)], 1),
            k=np.stack([np.asarray(packets.k), np.asarray(packets.l)], 1),
            u=np.stack([np.asarray(u), np.asarray(v)], 1),
        )
    writer.close()
    print(f"done: {nframes} packet frames, t={t:.2f}")


def cmd_twolayer_simulation(args):
    """Spin-up runs producing IC files for raytracing
    (simulation/TwoLayerSimulation.jl:13-143, FreelyEvolvingSimulation.jl)."""
    import h5py
    import jax.numpy as jnp

    from ..coupled.initial_conditions import random_band_psih
    from ..core.steppers import zero_clock
    from ..core.transfer import to_host
    from ..models import twolayerqg
    from ..models.base import build_stepper, run

    grid, dt, nu, rng = _setup(args)
    model = twolayerqg.make_model(grid, U=args.U, mu=args.mu, nu=nu,
                                  nnu=args.nnu, f0=args.f, Cg=args.cg,
                                  drho_rho0=args.drho_rho0)
    psih0 = jnp.stack([
        random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag),
        random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag),
    ])
    sol = twolayerqg.pv_from_streamfunction(psih0, grid, model.params)
    stepper = "FilteredAB3" if args.stepper == "IFMAB3" and args.freely_evolving \
        else args.stepper
    init_fn, step_fn = build_stepper(model, stepper, dt,
                                     use_filter=args.use_filter)
    state = init_fn(sol)
    clock = zero_clock()
    nsteps = int(args.T / dt)
    chunk = max(nsteps // 10, 1)
    done = 0

    # jit the chunk: inside jit the closed-over complex expm tables embed
    # in the executable instead of being transferred eagerly
    import functools

    import jax

    @functools.partial(jax.jit, static_argnames=("k",))
    def run_chunk(sol, clock, state, k):
        return run(step_fn, sol, clock, state, k)

    while done < nsteps:
        k = min(chunk, nsteps - done)
        sol, clock, state = run_chunk(sol, clock, state, k=k)
        done += k
        ke = twolayerqg.kinetic_energy(sol, grid, model.params)
        print(f"t={float(clock.t):8.2f} KE=({float(ke[0]):.4g}, "
              f"{float(ke[1]):.4g})", flush=True)
    psih = twolayerqg.streamfunction_from_pv(sol, grid, model.params)
    os.makedirs(args.out_dir, exist_ok=True)
    # initial_condition_%dx%d_U=%.2f naming (TwoLayerSimulation.jl:137-143),
    # written in the reference consumption layout (snapshots/ψh + params
    # struct + clock/dt, TwoLayerRaytracing.jl:162-182) so
    # `twolayer --ic-file` closes the production chain; the convenience
    # ic/qh group is appended for direct PV restarts.
    from ..io.jld2_fixture import write_twolayer_ic

    path = os.path.join(
        args.out_dir,
        f"initial_condition_{grid.nx}x{grid.ny}_U={args.U:.2f}.h5",
    )
    # params struct carries the run's ACTUAL configuration: equal-depth
    # layers (the model's assumption), f-plane beta=0, and buoyancies
    # whose contrast encodes drho_rho0 ((b1-b2)/b1, the GeophysicalFlows
    # convention) — so the reference-style @unpack reads true values
    write_twolayer_ic(path, to_host(psih), dt=dt, t=float(clock.t),
                      step=int(clock.step), f0=args.f, beta=0.0,
                      b=(1.0, 1.0 - args.drho_rho0), H=(0.5, 0.5),
                      U=(args.U, -args.U), mu=args.mu)
    with h5py.File(path, "a") as f:
        # convenience keys consumed by utils.twolayer_helpers
        # .load_two_layer_state (default key 'ic/psih') and PV restarts
        f["ic/psih"] = to_host(psih)
        f["ic/qh"] = to_host(sol)
        for name, val in (("Cg", args.cg), ("nx", grid.nx), ("Lx", grid.Lx)):
            f[f"params_extra/{name}"] = val
    print(f"wrote {path}")


def cmd_single_wave(args):
    """Single wave-packet-in-envelope RSW experiment
    (rsw/SingleWaveRSWRaytracingDriver.jl:154-299): spin up RSW turbulence,
    replace the wave part of the state with one enveloped plane wave, and
    co-evolve the resolved wave with a small ray-traced packet ensemble
    launched from the envelope centre."""
    import jax.numpy as jnp

    from ..coupled.initial_conditions import band_geo_wave_ic
    from ..coupled.single_wave import inject_single_wave
    from ..models import rsw
    from ..rays.packets import Packets
    from ..rays.raytrace import RayParams, resolve_gather

    grid, dt, nu, rng = _setup(args)
    args.dt = dt
    f, Cg = args.f_over_cg * args.cg, args.cg
    model = rsw.make_model(grid, nu=nu, nnu=args.nnu, f=f, Cg=Cg)

    sol0 = band_geo_wave_ic(grid, rng, Kg=tuple(args.Kg), Kw=(0, 0),
                            ag=args.ag, aw=0.0, f=f, Cg=Cg)

    def psih_fn(sol):
        Kd2 = f * f / (Cg * Cg)
        qh = grid.ik * sol[1] - grid.il * sol[0] - f * sol[2]
        return -qh / (grid.Krsq + Kd2)

    rp = RayParams(f=f, Cg=Cg, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=args.interp,
                   table_dtype=args.table_dtype, gather=args.gather)
    rp = resolve_gather(rp, 2, grid.ny, grid.nx)
    k0 = float(np.asarray(grid.kr)[args.k0_idx])
    l0 = float(np.asarray(grid.l)[args.l0_idx])
    # rays launched at the envelope centre, carrying the injected wavevector,
    # one per dispersion branch (SingleWaveRSWRaytracingDriver.jl:107-121)
    packets = Packets(
        x=jnp.asarray([args.wave_x0, args.wave_x0], jnp.float32),
        y=jnp.asarray([args.wave_y0, args.wave_y0], jnp.float32),
        k=jnp.asarray([k0, k0], jnp.float32),
        l=jnp.asarray([l0, l0], jnp.float32),
        sign=jnp.asarray([1.0, -1.0], jnp.float32),
    )
    diags = {
        "kinetic_energy": lambda s, g, p: rsw.kinetic_energy(s, g),
        "potential_energy": lambda s, g, p: rsw.potential_energy(s, g, p),
    }

    from ..coupled.driver import CoupledDriver

    snap_w, pkt_w = _writers(args, "single_wave")
    drv = CoupledDriver(
        model=model, psih_fn=psih_fn, rp=rp, dt=dt, stepper=args.stepper,
        use_filter=args.use_filter, ray_substeps=args.ray_substeps,
        ray_method=args.ray_method, k_cutoff=100.0 * f / Cg, k0=k0,
        snapshot_writer=snap_w, packet_writer=pkt_w, diagnostics=diags,
    )
    drv.init(sol0, packets)
    if args.restore:
        drv.restore(args.restore)
    drv.spinup(int(args.spinup_T / dt))
    # inject after spinup into the geostrophic part (:87-105)
    drv.sim = drv.sim._replace(sol=inject_single_wave(
        drv.sim.sol, grid, model.params, x0=args.wave_x0, y0=args.wave_y0,
        k0_idx=args.k0_idx, l0_idx=args.l0_idx, env_size=args.env_size,
        aw=args.aw))
    frames = max(int((args.T - args.spinup_T) / args.output_dt), 1)
    drv.run(frames, max(int(args.output_dt / dt), 1))
    drv.save_diagnostics(os.path.join(args.out_dir, "diagnostics.h5"))
    if args.checkpoint:
        drv.checkpoint(args.checkpoint)
    drv.close()
    print(f"done: t={float(drv.sim.clock.t):.3f}, {frames} frames")


def cmd_sweep(args):
    """Run an experiment over every row of a sweep table — the framework's
    replacement for SLURM job arrays + awk lookups (SURVEY.md §2.5)."""
    import shlex
    import subprocess

    from ..config.params import load_sweep_table
    from ..parallel.launcher import card_slots

    rows = load_sweep_table(args.table)
    if args.task is None and (
            "SLURM_ARRAY_TASK_ID" in os.environ
            or "JRSW_SWEEP_INDEX" in os.environ):
        # under a SLURM job array each task picks its own row, exactly like
        # the reference's awk lookup of parameters.txt
        from ..parallel.launcher import sweep_row_from_env

        sel = [sweep_row_from_env(rows)]
    else:
        sel = rows if args.task is None else [rows[args.task - 1]]
    # one card per child, concurrency capped at the visible cards
    slots = card_slots(args.max_parallel)
    free = list(range(len(slots)))
    procs: list[tuple[str, subprocess.Popen, int]] = []

    def _drain(limit):
        while len(procs) >= limit:
            tid, p, slot = procs.pop(0)
            free.append(slot)
            if p.wait() != 0:
                raise SystemExit(f"sweep task {tid} failed rc={p.returncode}")

    for i, row in enumerate(sel):
        task_id = row.get("ArrayTaskID", str(i + 1))
        out_dir = os.path.join(args.out_dir, f"task_{task_id}")
        extra = []
        for key, val in row.items():
            if key == "ArrayTaskID":
                continue
            extra += [f"--{key.replace('_', '-')}", val]
        cmd = [sys.executable, "-m", "juliaraytracingsw_tpu.experiments",
               args.experiment, "--out-dir", out_dir] + extra + \
            shlex.split(args.extra_args)
        print("sweep task", task_id, ":", " ".join(cmd), flush=True)
        _drain(len(slots))
        slot = free.pop(0)
        env = dict(os.environ)
        if slots[slot] is not None:
            env["CUDA_VISIBLE_DEVICES"] = slots[slot]
        procs.append((task_id, subprocess.Popen(cmd, env=env), slot))
    _drain(1)


def cmd_omega_k(args):
    """Sharded offline omega-k analysis over a finished run directory —
    entry point parity with swqg/fourier-analysis/FourierSWQG.jl:116-125
    (k-range from task id) and rsw/fourier-analysis/FourierRSW.jl:176-190;
    the --task/--ntasks pair replaces the reference's 64-256-task SLURM
    arrays over wavenumber (fourier-job.sbatch)."""
    import h5py

    from ..analysis.omega_k import (
        clean_fft,
        collect_time_series,
        count_snapshots,
        hann,
        snapshot_shape,
    )
    from ..core.grid import make_grid
    from ..io.output import SequencedReader
    from ..models.rsw import RSWParams
    from ..models.wave_vortex import balanced_wave_bases

    if args.fanout > 0:
        # multi-process fan-out over the k range via the sweep launcher
        # (the reference's fourier-job.sbatch arrays)
        from ..parallel.launcher import launch_sweep

        base_cmd = [sys.executable, "-m", "juliaraytracingsw_tpu.experiments",
                    "omega-k", args.run_dir, "--base", args.base,
                    "--model", args.model, "--out-dir", args.out_dir,
                    "--ntasks", str(args.fanout),
                    # --mem-cap-gb reads as a TOTAL cap: each child sizes its
                    # sub-blocks to cap/N so N concurrent children stay under it
                    "--mem-cap-gb", str(args.mem_cap_gb / args.fanout),
                    "--stft-window", str(args.stft_window)]
        if not args.decompose:
            base_cmd.append("--no-decompose")
        rows = [{"task": i + 1} for i in range(args.fanout)]
        # omega-k tasks are pure numpy/h5py — keep N concurrent children off
        # the GPU (they must not reserve card memory)
        rcs = launch_sweep(base_cmd, rows,
                           os.path.join(args.out_dir, "_logs"),
                           max_parallel=args.fanout, out_flag=None,
                           env_extra={"JAX_PLATFORMS": "cpu"})
        bad = [i + 1 for i, rc in enumerate(rcs) if rc != 0]
        if bad:
            raise SystemExit(f"omega-k fan-out tasks failed: {bad}")
        print(f"fan-out of {args.fanout} omega-k tasks complete")
        return

    reader = SequencedReader(os.path.join(args.run_dir, args.base))
    nx = int(reader.read("grid/nx"))
    Lx = float(reader.read("grid/Lx"))
    grid = make_grid(nx, Lx=Lx)
    nkr = grid.nkr

    # k-range for this task (FourierSWQG.jl:117-121: job_size = max_K/ntasks)
    job = max(nkr // args.ntasks, 1)
    k_lo = (args.task - 1) * job
    k_hi = nkr if args.task == args.ntasks else min(args.task * job, nkr)
    print(f"task {args.task}/{args.ntasks}: k rows [{k_lo}, {k_hi})")

    if args.model == "ty":
        from ..models.thomasyamada import ty_bases

        # full-grid eigenbases computed ONCE; sub-blocks slice them.
        # Row count for cap sizing: 6 series rows + 3 complex-U rows +
        # ~3 rows of FFT/windowing temporaries
        ty_full = [np.asarray(b) for b in ty_bases(grid)]
        n_vars = 12
    elif args.decompose:
        f0 = float(reader.read("params/f"))
        Cg2 = float(reader.read("params/Cg2"))
        params = RSWParams(nu=0.0, nnu=4, f=f0, Cg2=Cg2)
        Cg = float(np.sqrt(Cg2))
        bases_full = [np.asarray(b)
                      for b in balanced_wave_bases(grid, params)]
        n_vars = 5   # c0/cp/cm + psit + FFT temporary headroom
    else:
        shape = snapshot_shape(reader)
        n_vars = int(shape[0]) if shape else 3   # state channel count

    def make_extract(lo, hi):
        """Extract + complex-row builders for one k sub-block [lo, hi)."""
        complex_rows = {}
        if args.model == "ty":
            # Thomas-Yamada rows: barotropic (ut, vt) from zeta_t, wave/geo-
            # projected baroclinic (ug, vg, uw, vw), and complex U = u + i v
            # whose one-sided FFT separates +/- frequency branches
            # (thomasyamada/TY_k_omega.jl:78-107)
            invK = np.asarray(grid.invKrsq)[:, lo:hi]
            kr_b = np.asarray(grid.kr)[None, lo:hi]
            ell = np.asarray(grid.l)[:, None]
            Phi0, Phip, Phim = (b[:, :, lo:hi] for b in ty_full)

            def extract(snap):
                blk = snap[:, :, lo:hi]
                psit = -blk[0] * invK
                bc = blk[1:4]
                c0 = np.sum(bc * np.conj(Phi0), axis=0)
                cp = np.sum(bc * np.conj(Phip), axis=0)
                cm = np.sum(bc * np.conj(Phim), axis=0)
                Gh = c0[None] * Phi0
                Wh = cp[None] * Phip + cm[None] * Phim
                return {
                    "ut": -1j * ell * psit, "vt": 1j * kr_b * psit,
                    "ug": Gh[0], "vg": Gh[1], "uw": Wh[0], "vw": Wh[1],
                }

            complex_rows = {
                "U_balanced": lambda s: (s["ut"] + s["ug"])
                + 1j * (s["vt"] + s["vg"]),
                "U_wave": lambda s: s["uw"] + 1j * s["vw"],
                "U_total": lambda s: (s["ut"] + s["ug"] + s["uw"])
                + 1j * (s["vt"] + s["vg"] + s["vw"]),
            }
        elif args.decompose:
            bases = [b[:, :, lo:hi] for b in bases_full]
            ikb = 1j * np.asarray(grid.kr)[None, lo:hi]    # (1, block)
            ilb = 1j * np.asarray(grid.l)[:, None]         # (nl, 1)
            Kd2 = f0 * f0 / Cg2
            invKKd = 1.0 / (np.asarray(grid.Krsq)[:, lo:hi] + Kd2)

            def extract(snap):
                # eigen-coefficient rows c0/c+/c- for the k sub-block
                # (FourierRSW.jl:76-162 stores these per k_x row; projection
                # contracts (u, v, Cg eta) against conj(Phi), RSWUtils.jl:48-54)
                # plus the geostrophic streamfunction row psit = -qh/(K^2+Kd^2)
                # consumed by the b-parameter chain (compute_b_parameter.jl)
                blk = snap[:, :, lo:hi]
                state = np.stack([blk[0], blk[1], Cg * blk[2]])
                out = {name: np.sum(state * np.conj(Phi), axis=0)
                       for name, Phi in zip(("c0", "cp", "cm"), bases)}
                qh = ikb * blk[1] - ilb * blk[0] - f0 * blk[2]
                out["psit"] = -qh * invKKd
                return out
        else:
            def extract(snap):
                return {"sol": snap[..., lo:hi]}

        return extract, complex_rows

    # Bounded-memory streaming: the task's k range is
    # processed in sub-blocks sized so the collected (T, ny, block) series
    # of all variables fit --mem-cap-gb; each sub-block is one extra pass
    # over the snapshot files — the same trade the reference makes per-k
    # (FourierRSW.jl:176-190 re-reads every file in every one of its
    # 64-256 array tasks), but with the pass count driven by the cap.
    T_est = count_snapshots(reader)
    if T_est < 4:
        raise SystemExit("not enough snapshots for a time FFT")
    bytes_per_col = T_est * grid.ny * 16 * max(n_vars, 1)
    cap = int(args.mem_cap_gb * 2**30)
    block = max(1, min(k_hi - k_lo, cap // max(bytes_per_col, 1)))
    n_blocks = -(-(k_hi - k_lo) // block)
    if n_blocks > 1:
        print(f"mem cap {args.mem_cap_gb} GB -> {n_blocks} sub-blocks of "
              f"<= {block} k rows ({T_est} snapshots)")

    os.makedirs(args.out_dir, exist_ok=True)
    nwritten = 0
    for lo in range(k_lo, k_hi, block):
        hi = min(lo + block, k_hi)
        extract, complex_rows = make_extract(lo, hi)
        t, series = collect_time_series(reader, extract)
        if len(t) < 4:
            raise SystemExit("not enough snapshots for a time FFT")
        w = hann(len(t))
        wsh = w.reshape((len(t),)
                        + (1,) * (series[next(iter(series))].ndim - 1))
        # window-only FFT so the +/- frequency asymmetry of the complex
        # velocity survives (TY_k_omega.jl:105-107)
        u_ffts = {name: np.fft.fft(wsh * fn(series), axis=0)
                  for name, fn in complex_rows.items()}
        for ki in range(lo, hi):
            # per-k file layout radial_data_k=%03d (FourierSWQG.jl:109-112)
            path = os.path.join(args.out_dir, f"radial_data_k={ki:03d}.h5")
            with h5py.File(path, "w") as out:
                out["t"] = t
                out["k"] = float(np.asarray(grid.kr)[ki])
                for name, d in series.items():
                    out[name] = clean_fft(t, d[..., ki - lo], w)
                for name, Uf in u_ffts.items():
                    out[name] = Uf[..., ki - lo]
                if args.stft_window:
                    # sliding-window variant (ShortTimeFourierSWQG.jl:74-117)
                    from ..analysis.omega_k import stft_omega_k

                    for name, d in series.items():
                        centers, st_om, spec = stft_omega_k(
                            t, d[..., ki - lo], args.stft_window)
                        out[f"stft/{name}"] = spec
                    out["stft/centers"] = centers
                    out["stft/omega"] = st_om
            nwritten += 1
    print(f"wrote {nwritten} per-k files -> {args.out_dir}")


def cmd_omega_k_plot(args):
    """Assemble per-k omega-k files into radially-binned (omega, K)
    heatmaps of the wave/vortex power classes — the reference's
    MakeOmegaKPlots role (analysis/Notebooks/MakeOmegaKPlots.jl:22-71).
    Writes ``omega_k_radial.h5`` (C0/Cp/Cm power + axes) and one heatmap
    PNG per class."""
    import h5py

    from ..analysis.figures import plot_omega_k_heatmap
    from ..analysis.omega_k import assemble_radial_omega_k
    from ..core.grid import make_grid
    from ..io.output import SequencedReader

    reader = SequencedReader(os.path.join(args.run_dir, args.base))
    grid = make_grid(int(reader.read("grid/nx")),
                     Lx=float(reader.read("grid/Lx")))
    names = tuple(args.names.split(","))
    omega, radii, power = assemble_radial_omega_k(
        args.omega_dir, grid, names=names)
    # inertia-gravity dispersion overlay omega = sqrt(f^2 + Cg^2 K^2),
    # drawn on the WAVE classes only (cp/cm/U_wave — the geostrophic
    # branch lives at omega~0; MakeOmegaKPlots.jl draws it over C+/C-)
    dispersion = None
    try:
        f0 = float(reader.read("params/f"))
        Cg2 = float(reader.read("params/Cg2"))
        dispersion = lambda K: np.sqrt(f0 * f0 + Cg2 * K * K)
    except KeyError:
        pass   # non-RSW run layouts carry no f/Cg2 params
    wave_classes = {"cp", "cm", "U_wave"}
    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir, "omega_k_radial.h5")
    with h5py.File(out_path, "w") as f:
        f["omega"] = omega
        f["K"] = radii
        for name, p in power.items():
            f[name] = p
    for name, p in power.items():
        plot_omega_k_heatmap(
            omega, radii, p, args.out_dir, name=f"omega_k_{name}.png",
            title=f"{name} power",
            dispersion=dispersion if name in wave_classes else None)
    print(f"assembled {len(power)} classes -> {out_path}")


def cmd_b_parameter(args):
    """Ray-diffusivity b-parameter from the per-k omega-k output — the
    reference's compute_b_parameter.jl chain: psi-correlation spectrum
    C(omega, q) from the stored psit rows, WKB resonance integral D11(k),
    quadratic fit b (k/Kd)^2."""
    import glob
    import re

    import h5py

    from ..analysis.b_parameter import compute_D11, fit_b, psi_correlation
    from ..core.grid import make_grid
    from ..io.output import SequencedReader

    reader = SequencedReader(os.path.join(args.run_dir, args.base))
    grid = make_grid(int(reader.read("grid/nx")),
                     Lx=float(reader.read("grid/Lx")))
    f0 = float(reader.read("params/f"))
    Cg = float(np.sqrt(float(reader.read("params/Cg2"))))
    Kd = f0 / Cg

    psit_by_k, t = {}, None
    for path in sorted(glob.glob(
            os.path.join(args.omega_dir, "radial_data_k=*.h5"))):
        ki = int(re.search(r"k=(\d+)", os.path.basename(path)).group(1))
        with h5py.File(path, "r") as f:
            if "psit" not in f:
                continue
            if t is None:
                t = f["t"][()]
            psit_by_k[ki] = f["psit"][()]
    if not psit_by_k:
        raise SystemExit(
            f"no psit rows found in {args.omega_dir} — run omega-k with "
            "--decompose first")
    omegas, C = psi_correlation(psit_by_k, t, grid)
    k, D11 = compute_D11(omegas, C, grid, f0, Kd,
                         n_points=min(args.n_points, grid.nkr * 4))
    b = fit_b(k, D11, Kd)
    out_path = os.path.join(args.omega_dir, "b_parameter.h5")
    with h5py.File(out_path, "w") as f:
        f["k"] = k
        f["D11"] = D11
        f["b"] = b
        f["Kd"] = Kd
    print(f"b = {b:.6e} (Kd={Kd:.3f}, {len(psit_by_k)} k rows) -> {out_path}")


def cmd_analyze(args):
    """Offline analysis suite over one or more finished run directories."""
    if len(args.run_dir) > 1:
        from ..analysis.suite import analyze_runs

        reports, idx = analyze_runs(args.run_dir, base=args.base,
                                    out_dir=args.figures_dir or "figures")
        for rep in reports:
            print(f"report: {rep.run_id} Ro={rep.rossby:.3f} "
                  f"Fr={rep.froude:.3f}")
        print(f"index: {idx}")
        return
    from ..analysis.suite import analyze_run

    rep, figs = analyze_run(args.run_dir[0], base=args.base,
                            out_dir=args.figures_dir)
    print(f"report: {rep.run_id} Ro={rep.rossby:.3f} Fr={rep.froude:.3f} "
          f"figures={sorted(figs)}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="juliaraytracingsw_tpu.experiments")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("rsw", help="RSW turbulence (+ optional packets)")
    _add_common(p); _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f-over-cg", type=float, default=3.0)
    p.add_argument("--model", default="rsw",
                   choices=["rsw", "linborg", "modified", "quadheight"],
                   help="shallow-water variant (replaces the reference's "
                        "file-swap of *ShallowWater.jl)")
    p.add_argument("--ic", default="band", choices=["band", "front"])
    p.add_argument("--Kg", type=float, nargs=2, default=(10, 13))
    p.add_argument("--Kw", type=float, nargs=2, default=(0, 5))
    p.add_argument("--ag", type=float, default=1.5)
    p.add_argument("--aw", type=float, default=0.1)
    p.add_argument("--with-packets", action="store_true", default=True)
    p.set_defaults(fn=cmd_rsw)

    p = sub.add_parser("swqg", help="SWQG turbulence + packets")
    _add_common(p); _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f", type=float, default=3.0)
    p.add_argument("--Kg", type=float, nargs=2, default=(10, 13))
    p.add_argument("--ag", type=float, default=0.5)
    p.set_defaults(fn=cmd_swqg)

    p = sub.add_parser("twolayer", help="TwoLayerQG turbulence + packets")
    _add_common(p); _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f", type=float, default=3.0)
    p.add_argument("--U", type=float, default=0.2)
    p.add_argument("--mu", type=float, default=0.5)
    p.add_argument("--drho-rho0", type=float, default=0.2)
    p.add_argument("--Kg", type=float, nargs=2, default=(2, 6))
    p.add_argument("--ag", type=float, default=0.01)
    p.add_argument("--baroclinic", action="store_true",
                   help="advect packets with the baroclinic streamfunction")
    p.add_argument("--nlayers", type=int, default=2,
                   help=">2 switches to the general MultiLayerQG model "
                        "(equal depths, shear spread +U..-U, F/2 per "
                        "interface); packets ride the depth-weighted "
                        "barotropic mean; works with --sharded "
                        "(ShardedMultiLayerQG)")
    p.add_argument("--ic-file", default=None,
                   help="two-layer IC file (snapshots/ψh + params + "
                        "clock/dt layout, TwoLayerRaytracing.jl:162-182)")
    p.set_defaults(fn=cmd_twolayer)

    p = sub.add_parser("thomasyamada",
                       help="two-phase Thomas-Yamada run (TYdriver.jl)")
    _add_common(p)
    p.add_argument("--Ro", type=float, default=0.2)
    p.add_argument("--ty-nu", type=float, default=3.5e-25)
    p.add_argument("--ty-nnu", type=int, default=8)
    p.add_argument("--ty-dt", type=float, default=1e-3,
                   help="fine (main-phase) time step")
    p.add_argument("--startup-dt-factor", type=float, default=5.0,
                   help="coarse startup dt = factor * dt (TYdriver two-phase)")
    p.add_argument("--startup-T", type=float, default=1.0,
                   help="model time integrated in the coarse startup phase")
    p.add_argument("--Kg", type=float, nargs=2, default=(2, 6),
                   help="geostrophic IC band k0g_range")
    p.add_argument("--Kw", type=float, nargs=2, default=(0, 4),
                   help="wave IC band k0w_range")
    p.add_argument("--at", type=float, default=0.1,
                   help="barotropic streamfunction amplitude")
    p.add_argument("--ag", type=float, default=0.1)
    p.add_argument("--aw", type=float, default=0.05)
    p.add_argument("--restart-file", default=None,
                   help="resume from a finished run's snapshot base path")
    p.add_argument("--restart-frame", type=int, default=None)
    p.set_defaults(fn=cmd_thomasyamada)

    p = sub.add_parser("steady-raytracing",
                       help="packets through a frozen snapshot")
    _add_common(p); _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f", type=float, default=3.0)
    p.add_argument("--Kg", type=float, nargs=2, default=(2, 6))
    p.add_argument("--ag", type=float, default=0.2)
    p.add_argument("--snapshot-file", default=None)
    p.add_argument("--snapshot-key", default="snapshots/sol/0")
    p.add_argument("--packet-velocity-scale", type=float, default=1.0,
                   help="time-rescaled packet clock s: tspan *= s, Cg /= s "
                        "(SteadyRaytracing.jl:120-129)")
    p.set_defaults(fn=cmd_steady_raytracing)

    p = sub.add_parser("twolayer-simulation",
                       help="spin-up producing IC files (TwoLayerSimulation.jl)")
    _add_common(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f", type=float, default=3.0)
    p.add_argument("--U", type=float, default=0.2)
    p.add_argument("--mu", type=float, default=0.5)
    p.add_argument("--drho-rho0", type=float, default=0.2)
    p.add_argument("--Kg", type=float, nargs=2, default=(2, 6))
    p.add_argument("--ag", type=float, default=0.01)
    p.add_argument("--freely-evolving", action="store_true",
                   help="unforced/undamped variant (FreelyEvolvingSimulation.jl)")
    p.set_defaults(fn=cmd_twolayer_simulation)

    p = sub.add_parser("single-wave",
                       help="single wave packet in envelope + one ray "
                            "(SingleWaveRSWRaytracingDriver.jl)")
    _add_common(p); _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f-over-cg", type=float, default=3.0)
    p.add_argument("--Kg", type=float, nargs=2, default=(10, 13))
    p.add_argument("--ag", type=float, default=0.5)
    p.add_argument("--aw", type=float, default=0.1)
    p.add_argument("--wave-x0", type=float, default=0.0)
    p.add_argument("--wave-y0", type=float, default=0.0)
    p.add_argument("--k0-idx", type=int, default=10)
    p.add_argument("--l0-idx", type=int, default=0)
    p.add_argument("--env-size", type=float, default=0.5)
    p.set_defaults(fn=cmd_single_wave)

    p = sub.add_parser("sweep", help="parameter sweep over a table "
                                     "(replaces SLURM job arrays)")
    p.add_argument("experiment")
    p.add_argument("table")
    p.add_argument("--task", type=int, default=None,
                   help="run only this 1-based task id")
    p.add_argument("--out-dir", default="sweep")
    p.add_argument("--extra-args", default="")
    p.add_argument("--max-parallel", type=int, default=1,
                   help="run up to this many sweep tasks concurrently")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("omega-k",
                       help="sharded omega-k analysis over a run dir "
                            "(fourier-analysis job arrays)")
    p.add_argument("run_dir")
    p.add_argument("--base", default="rsw")
    p.add_argument("--model", default="rsw", choices=["rsw", "ty"],
                   help="ty: TY wave/geo rows + complex-U +/- separation "
                        "(TY_k_omega.jl:99-107)")
    p.add_argument("--task", type=int, default=1, help="1-based task id")
    p.add_argument("--ntasks", type=int, default=1)
    p.add_argument("--decompose", action="store_true", default=True,
                   help="store wave/geo eigen-coefficients c0/c+/c-")
    p.add_argument("--no-decompose", dest="decompose", action="store_false")
    p.add_argument("--out-dir", default="omega_k")
    p.add_argument("--mem-cap-gb", type=float, default=8.0,
                   help="stream the task's k range in sub-blocks sized so "
                        "collected time series fit this many GB")
    p.add_argument("--stft-window", type=int, default=0,
                   help="also store sliding-window STFT spectra of each "
                        "row with this window length "
                        "(ShortTimeFourierSWQG.jl)")
    p.add_argument("--fanout", type=int, default=0,
                   help="run the full analysis locally as N concurrent "
                        "omega-k task processes (replaces --task/--ntasks; "
                        "launcher-backed, like the reference's 64-256-task "
                        "fourier-job.sbatch arrays)")
    p.set_defaults(fn=cmd_omega_k)

    p = sub.add_parser("omega-k-plot",
                       help="assemble per-k omega-k files into radial "
                            "(omega, K) heatmaps (MakeOmegaKPlots)")
    p.add_argument("run_dir")
    p.add_argument("--base", default="rsw")
    p.add_argument("--omega-dir", default="omega_k")
    p.add_argument("--names", default="c0,cp,cm",
                   help="comma-separated dataset names to assemble")
    p.add_argument("--out-dir", default="omega_k")
    p.set_defaults(fn=cmd_omega_k_plot)

    p = sub.add_parser("b-parameter",
                       help="ray-diffusivity b from omega-k psit rows "
                            "(compute_b_parameter.jl)")
    p.add_argument("run_dir")
    p.add_argument("--base", default="rsw")
    p.add_argument("--omega-dir", default="omega_k")
    p.add_argument("--n-points", type=int, default=176)
    p.set_defaults(fn=cmd_b_parameter)

    p = sub.add_parser("analyze", help="offline analysis suite over run dirs")
    p.add_argument("run_dir", nargs="+")
    p.add_argument("--base", default="rsw")
    p.add_argument("--figures-dir", default=None)
    p.set_defaults(fn=cmd_analyze)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
