"""Smoke test of the main path on one NVIDIA GPU (``--four``: four GPUs).

``python chip_smoke.py`` drives the README quick-start deployment through
``CoupledDriver``: 512^2 rotating shallow water (IF-AB3, f = 3, Cg = 1,
dt = 1e-3) coupled to ``lattice_packets(1024, ...)`` = 1,048,576 WKB
packets, bilinear interpolation with float32 pair tables, no writers.
Phases, in order; any failure raises and the script exits non-zero:

  a. device and card (fails without a GPU; never falls back to the CPU)
  b. complex64 host -> device -> host round trip (reported only)
  c. 100 IF-AB3 flow steps on the card against the same run on the CPU
     backend, with ``apply_L`` pinned to HIGHEST and at default precision
  d. 512^2 inviscid energy drift over 1000 steps
  e. the coupled main path: spin-up + 3 frames of 100 flow steps
  f. the fused Pallas ray kernels against the plain per-stage path at
     1M packets (bilinear / bspline x f32 / bf16 tables, and the adaptive
     DP5(4) attempt kernel; bicubic has no kernel and runs the plain
     path), and a 65,536-packet subset against the taps oracle on the CPU
  g. value_and_grad through one coupled hero step (the kernel's VJP)
  h. compiled memory of the coupled frame and peak device memory

``python chip_smoke.py --four`` instead runs only the sharded production
path on four cards: ``ShardedTwoLayerQG`` at 2048^2 with 262,144 packets
sharded over a 4-card ``'packets'`` mesh, plain and ``overlap=True``
frames, each compared with the same frame on card 0 alone.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def say(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    say(f"  ok: {what}")


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def phase_device(n_expected):
    import jax

    say("[a] device and card")
    devs = jax.devices()
    d0 = devs[0]
    say(f"  jax: platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    if d0.platform != "gpu":
        raise SystemExit(f"FAILED: no GPU (jax.devices()[0].platform is "
                         f"{d0.platform!r}); this smoke test never falls "
                         "back to the CPU")
    check(len(devs) >= n_expected, f"{n_expected} GPU(s) visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    for line in card:
        say(f"  card: {line}")
    return d0


def phase_complex_transfer(dev):
    import jax

    say("[b] complex64 host -> device -> host round trip")
    x = (np.arange(12, dtype=np.float32)
         + 1j * np.arange(12, 0, -1, dtype=np.float32)).astype(np.complex64)
    try:
        back = np.asarray(jax.device_put(x, dev))
        say(f"  complex64 round trip: "
            f"{'exact' if np.array_equal(back, x) else 'MISMATCH'}")
    except Exception as e:  # reported, not a failure (ROADMAP 3.4)
        say(f"  complex64 round trip unsupported: {type(e).__name__}: {e}")


def _flow_run(hero, nsteps, device):
    import jax

    from juliaraytracingsw_tpu.core.steppers import zero_clock
    from juliaraytracingsw_tpu.coupled.hero import DT
    from juliaraytracingsw_tpu.models.base import build_stepper, run

    with jax.default_device(device):
        init_fn, step_fn = build_stepper(hero.model, "IFMAB3", dt=DT)
        sol = jax.device_put(hero.sol0, device)
        out = jax.jit(lambda s: run(step_fn, s, zero_clock(), init_fn(s),
                                    nsteps)[0])(sol)
        return np.asarray(out)


# measured 5.2e-8 on the H100 (cuFFT vs the CPU's FFT, float32 round-off
# over 100 steps); 1e-6 leaves 20x headroom yet fails a TF32 contraction
# (~1e-4 and up), which the default 1e-4 would let through
FLOW_TOL = 1e-6


def phase_flow(hero, dev):
    import jax
    import jax.numpy as jnp

    from juliaraytracingsw_tpu.core import steppers

    say("[c] 100 IF-AB3 steps of 512^2 RSW: card vs CPU backend (float32, "
        "jnp.fft)")
    cpu = jax.devices("cpu")[0]
    ref = _flow_run(hero, 100, cpu)
    err_pinned = rel_l2(_flow_run(hero, 100, dev), ref)
    pinned = steppers.apply_L

    def apply_L_default(L, sol):
        if L.ndim == sol.ndim + 1:
            return jnp.einsum("ab...,b...->a...", L, sol)
        return L * sol

    steppers.apply_L = apply_L_default
    try:
        jax.clear_caches()
        err_default = rel_l2(_flow_run(hero, 100, dev), ref)
    finally:
        steppers.apply_L = pinned
        jax.clear_caches()
    say(f"  rel L2 error vs CPU: apply_L HIGHEST {err_pinned:.3e}, "
        f"default precision {err_default:.3e} (bound {FLOW_TOL:.0e})")
    check(err_pinned < FLOW_TOL, f"flow agrees with the CPU to {FLOW_TOL:.0e}")


def phase_energy():
    say("[d] 512^2 inviscid energy drift, 1000 steps")
    from benchmarks.hw_validation.physics_anchors import anchor_energy_drift

    check(anchor_energy_drift(), "energy drift below DRIFT_TOL")


def make_driver(hero):
    from juliaraytracingsw_tpu.coupled.driver import CoupledDriver
    from juliaraytracingsw_tpu.coupled.hero import DT

    drv = CoupledDriver(model=hero.model, psih_fn=hero.psih_fn, rp=hero.rp,
                        dt=DT, k_cutoff=100.0 * hero.k0, k0=hero.k0,
                        log_fn=lambda m: say(f"  {m}"))
    drv.init(hero.sol0, hero.packets)
    return drv


def phase_coupled(hero):
    say(f"[e] coupled main path: CoupledDriver, 512^2 RSW + "
        f"{hero.packets.n:,} packets ({hero.rp.interp}, {hero.rp.gather}, "
        f"{hero.rp.table_dtype} tables)")
    drv = make_driver(hero)
    t0 = time.perf_counter()
    drv.spinup(200)
    drv.run(n_frames=1, flow_steps_per_frame=100)     # compiles the frame
    say(f"  spin-up + first frame (compile) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    drv.run(n_frames=3, flow_steps_per_frame=100)
    wall = time.perf_counter() - t0
    say(f"  3 frames x 100 coupled steps: {wall:.2f} s wall (driver loop, "
        "not a benchmark)")
    p = drv.sim.packets
    for name in ("x", "y", "k", "l"):
        check(bool(np.isfinite(np.asarray(getattr(p, name))).all()),
              f"packet {name} finite")
    kmag = np.hypot(np.asarray(p.k), np.asarray(p.l))
    spread = float(kmag.std() / hero.k0)
    say(f"  |k|: mean {kmag.mean():.4f} (k0 {hero.k0:.4f}), "
        f"std/k0 {spread:.3e}")
    check(spread > 1e-3, "|k| spreads from k0 (refraction)")
    return drv


RAY_TOL = 1e-5     # kernel vs plain path on the same table: FP association
ORACLE_TOL = 1e-4  # patch path vs taps oracle (CPU), one flow interval


def _trace(hero, rp, fo, fn, packets, fused, nsub=1, method="rk4"):
    import jax

    from juliaraytracingsw_tpu.coupled.hero import DT
    from juliaraytracingsw_tpu.rays.raytrace import build_pair, raytrace_tables

    os.environ["JRSW_FUSED"] = "auto" if fused else "off"
    try:
        jax.clear_caches()
        T = build_pair(fo, fn, rp)
        out = raytrace_tables(packets, T, 0.0, DT, rp, hero.grid.ny,
                              hero.grid.nx, nsub, method)
        return np.stack([np.asarray(a) for a in out[:4]])
    finally:
        del os.environ["JRSW_FUSED"]


def _state_err(a, b, Lx):
    """Max relative error over (x, y) in domain units and (k, l)."""
    dpos = np.abs(a[:2] - b[:2]).max() / Lx
    dk = (np.abs(a[2:] - b[2:]).max()
          / max(np.abs(b[2:]).max(), 1e-30))
    return float(max(dpos, dk))


def phase_kernels(hero, drv):
    import jax

    from juliaraytracingsw_tpu.coupled.hero import DT
    from juliaraytracingsw_tpu.models.base import build_stepper
    from juliaraytracingsw_tpu.ops.pallas_ray_step import FUSED_INTERPS
    from juliaraytracingsw_tpu.rays.patch import PATCH_SHAPES
    from juliaraytracingsw_tpu.rays.raytrace import (_use_fused,
                                                     fields_from_psih,
                                                     raytrace,
                                                     raytrace_adaptive)

    say("[f] fused ray kernels vs the plain per-stage path "
        f"({hero.packets.n:,} packets, one flow interval)")
    sol0 = drv.sim.sol
    _, step_fn = build_stepper(hero.model, "IFMAB3", dt=DT)
    sol1, _, _ = jax.jit(step_fn)(sol0, drv.sim.clock, drv.sim.stepper_state)
    packets = drv.sim.packets
    Lx = hero.grid.Lx
    check(not _use_fused(hero.rp._replace(interp="bicubic")),
          "bicubic runs the plain path (no fused kernel)")
    for interp in FUSED_INTERPS:
        fo = fields_from_psih(hero.psih_fn(sol0), hero.grid, interp)
        fn = fields_from_psih(hero.psih_fn(sol1), hero.grid, interp)
        ph, pw, _ = PATCH_SHAPES[interp]
        width = 2 * 5 * ph * pw
        plain32 = None
        for dt_ in ("float32", "bfloat16"):
            rp = hero.rp._replace(interp=interp, table_dtype=dt_)
            t0 = time.perf_counter()
            kern = _trace(hero, rp, fo, fn, packets, fused=True)
            t_k = time.perf_counter() - t0
            plain = _trace(hero, rp, fo, fn, packets, fused=False)
            plain32 = plain if dt_ == "float32" else plain32
            err = _state_err(kern, plain, Lx)
            say(f"  {interp:8s} 2W={width:3d} {dt_:8s}: kernel vs plain "
                f"{err:.2e} (tol {RAY_TOL:.0e}); first call {t_k:.1f} s")
            check(err < RAY_TOL and np.isfinite(kern).all(),
                  f"{interp} {dt_} kernel matches the plain path")
            if dt_ == "bfloat16":
                # bound of tests/test_rays.py::
                # test_bf16_table_trajectory_divergence
                scale = np.array([Lx, Lx, hero.k0, hero.k0])[:, None]
                dev_ = float((np.abs(kern - plain32) / scale).max())
                say(f"  {interp:8s} bf16 kernel vs f32 plain: {dev_:.2e} "
                    "(tol 5e-3)")
                check(dev_ < 5e-3, f"{interp} bf16 divergence bounded")
        if interp == "bilinear":
            fo_b, fn_b = fo, fn

    # adaptive DP5(4) attempt kernel (loop='while')
    opts = dict(rtol=1e-3, atol=1e-6, max_steps=16, init_substeps=1,
                loop="while")
    outs = {}
    for mode in ("auto", "off"):
        os.environ["JRSW_FUSED"] = mode
        try:
            jax.clear_caches()
            out, info = raytrace_adaptive(packets, fo_b, fn_b, 0.0, DT,
                                          hero.rp, **opts)
            outs[mode] = (np.stack([np.asarray(a) for a in out[:4]]),
                          int(info["n_accepted"]), int(info["n_rejected"]))
        finally:
            del os.environ["JRSW_FUSED"]
    err = _state_err(outs["auto"][0], outs["off"][0], Lx)
    say(f"  adaptive DP5(4) attempt kernel vs plain: {err:.2e} "
        f"(tol {RAY_TOL:.0e}); accepted/rejected kernel "
        f"{outs['auto'][1]}/{outs['auto'][2]}, plain "
        f"{outs['off'][1]}/{outs['off'][2]}")
    check(err < RAY_TOL and outs["auto"][1:] == outs["off"][1:],
          "adaptive attempt kernel matches the plain path")

    # 65,536-packet subset against the taps oracle on the CPU
    cpu = jax.devices("cpu")[0]
    sub = jax.tree_util.tree_map(lambda a: np.asarray(a)[:65536], packets)
    rp_taps = hero.rp._replace(gather="taps")
    with jax.default_device(cpu):
        oracle = raytrace(
            jax.device_put(sub, cpu), jax.device_put(np.asarray(fo_b), cpu),
            jax.device_put(np.asarray(fn_b), cpu), 0.0, DT, rp_taps)
        oracle = np.stack([np.asarray(a) for a in oracle[:4]])
    kern_b = _trace(hero, hero.rp, fo_b, fn_b, packets, fused=True)
    err = _state_err(kern_b[:, :65536], oracle, Lx)
    say(f"  kernel (bilinear f32) vs taps oracle on CPU, 65,536 packets: "
        f"{err:.2e} (tol {ORACLE_TOL:.0e})")
    check(err < ORACLE_TOL, "kernel matches the taps oracle")


def phase_gradient(hero, drv):
    import jax
    import jax.numpy as jnp

    from juliaraytracingsw_tpu.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu.coupled.hero import DT
    from juliaraytracingsw_tpu.models.base import build_stepper
    from juliaraytracingsw_tpu.rays.raytrace import fields_from_psih

    say("[g] value_and_grad through one coupled hero step (kernel VJP)")
    init_fn, step_fn = build_stepper(hero.model, "IFMAB3", dt=DT)
    frame = make_coupled_frame(hero.model, step_fn, hero.psih_fn, hero.rp, 1)
    sim = drv.sim

    @jax.jit
    def loss_and_grad(sol):
        def loss(s):
            fields = fields_from_psih(hero.psih_fn(s), hero.grid,
                                      hero.rp.interp)
            out = frame(SimState(s, sim.clock, init_fn(s), sim.packets,
                                 fields))
            return jnp.mean(out.packets.k ** 2 + out.packets.l ** 2)

        return jax.value_and_grad(loss)(sol)

    val, g = loss_and_grad(sim.sol)
    gn = float(jnp.linalg.norm(g))
    say(f"  loss {float(val):.6f}, |grad| {gn:.3e}")
    check(np.isfinite(float(val)) and np.isfinite(gn) and gn > 0,
          "gradient finite and non-zero")


def phase_memory(drv, dev):
    say("[h] memory")
    frame = drv._get_frame("coupled", 100)
    mem = frame.lower(drv.sim).compile().memory_analysis()
    if mem is not None:
        say(f"  coupled frame (100 steps) compiled: "
            f"args {mem.argument_size_in_bytes / 2**30:.3f} GiB, "
            f"outputs {mem.output_size_in_bytes / 2**30:.3f} GiB, "
            f"temps {mem.temp_size_in_bytes / 2**30:.3f} GiB, "
            f"code {mem.generated_code_size_in_bytes / 2**20:.1f} MiB")
    stats = dev.memory_stats() or {}
    say(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use', 0) / 2**30:.3f}"
        f" GiB of {stats.get('bytes_limit', 0) / 2**30:.1f} GiB")


def run_one():
    from juliaraytracingsw_tpu.coupled.hero import make_hero

    dev = phase_device(1)
    phase_complex_transfer(dev)
    hero = make_hero()
    check(hero.rp.gather == "patch", "gather='auto' resolves to patch")
    phase_flow(hero, dev)
    phase_energy()
    drv = phase_coupled(hero)
    phase_kernels(hero, drv)
    phase_gradient(hero, drv)
    phase_memory(drv, dev)
    return dev


SHARD_TOL = 1e-4   # 4-card slab FFTs vs 1 card: FP association only
FOUR_NX, FOUR_SQRT_PACKETS, FOUR_STEPS = 2048, 512, 10


def run_four():
    import jax
    import jax.numpy as jnp

    from juliaraytracingsw_tpu.core.grid import make_grid
    from juliaraytracingsw_tpu.core.spectral import rfft2
    from juliaraytracingsw_tpu.core.steppers import zero_clock
    from juliaraytracingsw_tpu.coupled.driver import derive_nu
    from juliaraytracingsw_tpu.coupled.hero import CG, DT, F
    from juliaraytracingsw_tpu.models import twolayerqg
    from juliaraytracingsw_tpu.parallel.mesh import make_mesh, shard_packets
    from juliaraytracingsw_tpu.parallel.sharded import ShardedTwoLayerQG
    from juliaraytracingsw_tpu.rays.packets import lattice_packets
    from juliaraytracingsw_tpu.rays.raytrace import RayParams

    dev = phase_device(4)
    nx, steps = FOUR_NX, FOUR_STEPS
    say(f"[four] ShardedTwoLayerQG {nx}^2 + {FOUR_SQRT_PACKETS ** 2:,} "
        f"packets, {steps} coupled steps: 4-card 'packets' mesh vs card 0 "
        "alone")
    grid = make_grid(nx)
    model = twolayerqg.make_model(grid, U=0.2, mu=1e-2,
                                  nu=derive_nu(1.0, nx, 4, DT), nnu=4)
    rng = np.random.default_rng(7)
    phys = rng.standard_normal((2, nx, nx)).astype(np.float32)
    sol0 = rfft2(jnp.asarray(phys)) * grid.dealias_mask
    sol0 = (0.3 * sol0 * jnp.exp(-grid.Krsq / 20.0 ** 2)
            / jnp.abs(sol0).max()).astype(jnp.complex64)
    k0 = float(np.sqrt(3.0) * F / CG)
    packets = lattice_packets(FOUR_SQRT_PACKETS, grid.Lx, grid.Ly, k0=k0,
                              k_ring=True)
    rp = RayParams(f=F, Cg=CG, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy)

    # overlap=True gives trajectories identical to the sequential frame
    # (tests/test_sharded_rsw.py), so both 4-card frames are compared with
    # the one sequential frame on card 0
    results = {}
    for overlap, ncards in ((False, 1), (False, 4), (True, 4)):
        mesh = make_mesh(ncards)
        sh = ShardedTwoLayerQG(grid, model.params, mesh, dt=DT)
        init_s, _ = sh.stepper()
        frame = sh.make_coupled_frame(rp, steps, overlap=overlap)
        sol_s = sh.shard_solution(sol0)
        pk = shard_packets(packets, mesh)
        args = (sol_s, zero_clock(), init_s(sol_s), pk)
        jax.block_until_ready(frame(*args))                  # compile
        t0 = time.perf_counter()
        sol_o, _, _, pk_o = jax.block_until_ready(frame(*args))
        wall = time.perf_counter() - t0
        results[(overlap, ncards)] = (
            sh.unshard(sol_o),
            np.stack([np.asarray(a) for a in pk_o[:4]]))
        say(f"  overlap={overlap} cards={ncards}: frame {wall:.3f} s "
            f"({steps / wall:.1f} coupled steps/s)")
    s1, p1 = results[(False, 1)]
    for overlap in (False, True):
        s4, p4 = results[(overlap, 4)]
        e_flow = rel_l2(np.stack([s4.real, s4.imag]),
                        np.stack([s1.real, s1.imag]))
        e_rays = _state_err(p4, p1, grid.Lx)
        say(f"  overlap={overlap}: 4 cards vs 1 card: flow rel L2 "
            f"{e_flow:.2e}, packets {e_rays:.2e} (tol {SHARD_TOL:.0e})")
        check(e_flow < SHARD_TOL and e_rays < SHARD_TOL
              and np.isfinite(p4).all(),
              f"sharded frame (overlap={overlap}) matches card 0 alone")
    return dev


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded path")
    args = ap.parse_args()
    from juliaraytracingsw_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    t0 = time.perf_counter()
    dev = run_four() if args.four else run_one()
    say(f"all phases passed in {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
