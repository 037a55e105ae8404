"""Single-GPU benchmark on the flagship configuration.

Prints the device and card, per-cell lines on stderr, and ONE JSON line on
stdout: ``{"metric": ..., "value": N, "unit": ..., "device": {...}}``.
Fails without a GPU; it never falls back to the CPU.

Headline metric: ray-steps/s on the hero config — 512^2 RSW turbulence
coupled to a 1M-packet WKB ray ensemble (coupled/hero.py) with bfloat16
pair tables; a full-f32 row (hero_f32) is always recorded alongside. bf16
tables upcast the gathered values to f32 before any stage math, so the only
error is ~2^-8 relative rounding of the stored field values; the trajectory
divergence is bounded by
tests/test_rays.py::test_bf16_table_trajectory_divergence.

Every metric is the MIN over trials of an iters-call average, and the
trial spread (max-min)/min is printed beside it. Extra cells: flow-only
steps/s at 512^2 and 1024^2, bspline/bicubic heroes, the 262k ensemble,
1024^2 coupled, birth/death, adaptive DP5(4), 2048^2 two-layer QG flow,
one differentiable hero step, and the gradient through 100 coupled steps.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def _timeit(call, warmup=2, iters=3, trials=3):
    """(min-of-trials mean seconds, relative spread across trials)."""
    import jax

    out = None
    for _ in range(warmup):
        out = call()
    jax.block_until_ready(out)
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = call()
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / iters)
    tmin = min(times)
    return tmin, (max(times) - tmin) / tmin


def main():
    from juliaraytracingsw_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    from juliaraytracingsw_tpu.core.grid import make_grid
    from juliaraytracingsw_tpu.core.spectral import rfft2
    from juliaraytracingsw_tpu.core.steppers import zero_clock
    from juliaraytracingsw_tpu.coupled.driver import (
        SimState, derive_nu, make_coupled_frame)
    from juliaraytracingsw_tpu.coupled.hero import DT, make_hero
    from juliaraytracingsw_tpu.models import twolayerqg
    from juliaraytracingsw_tpu.models.base import build_stepper, run
    from juliaraytracingsw_tpu.rays.raytrace import (
        fields_from_psih, raytrace, raytrace_adaptive)
    from juliaraytracingsw_tpu.rays.resample import init_birth_death

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; jax.devices()[0] is {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()))
    print(f"# device: {device}; card: {card.strip()}", file=sys.stderr)

    results = {}

    def record(tag, value, spread, desc):
        results[tag] = value
        print(f"# {desc} (spread {spread * 100:.1f}%)", file=sys.stderr)

    # --- flow-only spectral steps/s at 512^2 and 1024^2 ---------------------
    steps_per_call = 200
    for nx in (512, 1024):
        h = make_hero(nx=nx, sqrt_packets=2)
        init_fn, step_fn = build_stepper(h.model, "IFMAB3", dt=DT)
        chunk = jax.jit(lambda s: run(step_fn, s, zero_clock(), init_fn(s),
                                      steps_per_call))
        t, sp = _timeit(lambda: chunk(h.sol0), iters=4)
        record(f"rsw{nx}_flow_steps_per_s", steps_per_call / t, sp,
               f"rsw {nx}^2 flow: {steps_per_call / t:.1f} steps/s")

    # --- hero family: RSW + packets coupled ---------------------------------
    flow_steps = 5

    def hero(sqrtp, interp, tag, table_dtype="bfloat16", nx=512,
             birth_death=False, ray_method="rk4", ray_opts=None, trials=3):
        h = make_hero(nx=nx, sqrt_packets=sqrtp, interp=interp,
                      table_dtype=table_dtype, gather="patch")
        init_fn, step_fn = build_stepper(h.model, "IFMAB3", dt=DT)
        bd_cfg = dict(k_shape=1.5, lam=10.0) if birth_death else None
        frame = make_coupled_frame(h.model, step_fn, h.psih_fn, h.rp,
                                   flow_steps, ray_method=ray_method,
                                   k_cutoff=100.0 * h.k0, k0=h.k0,
                                   birth_death=bd_cfg, ray_opts=ray_opts)
        fields0 = fields_from_psih(h.psih_fn(h.sol0), h.grid, h.rp.interp)
        bd = (init_birth_death(jax.random.PRNGKey(0), h.packets.n)
              if birth_death else None)
        sim = SimState(h.sol0, zero_clock(), init_fn(h.sol0), h.packets,
                       fields0, bd)
        t, sp = _timeit(lambda: frame(sim), trials=trials)
        rays_per_s = h.packets.n * flow_steps / t
        results[f"{tag}_coupled_steps_per_s"] = flow_steps / t
        record(f"{tag}_rays_per_s", rays_per_s, sp,
               f"{tag}: {rays_per_s:.3e} ray-steps/s, "
               f"{flow_steps / t:.2f} coupled steps/s")
        return rays_per_s, h

    rays_per_s, h512 = hero(1024, "bilinear", "hero")
    hero(1024, "bilinear", "hero_f32", table_dtype="float32")
    hero(1024, "bspline", "hero_bspline")
    hero(1024, "bicubic", "hero_bicubic", trials=2)
    hero(512, "bilinear", "ensemble262k")
    hero(512, "bilinear", "hero1024", nx=1024, trials=2)
    hero(512, "bilinear", "hero_bd", birth_death=True, trials=2)
    # the reference's production path is ADAPTIVE Vern7 at
    # DifferentialEquations' defaults reltol=1e-3/abstol=1e-6
    # (GPURaytracing.jl:111-113,135-137); embedded DP5(4), forward-only
    # while_loop so finished slots cost nothing
    adaptive_opts = dict(rtol=1e-3, atol=1e-6, max_steps=16,
                         init_substeps=1, loop="while")
    hero(1024, "bilinear", "hero_adaptive", ray_method="adaptive",
         ray_opts=adaptive_opts, trials=2)
    f0_ = fields_from_psih(h512.psih_fn(h512.sol0), h512.grid, "bilinear")
    _, info = raytrace_adaptive(h512.packets, f0_, f0_, 0.0, DT, h512.rp,
                                **adaptive_opts)
    print(f"# hero_adaptive: {int(info['n_accepted'])} accepted / "
          f"{int(info['n_rejected'])} rejected attempts per flow interval",
          file=sys.stderr)

    # --- 2048^2 two-layer QG flow (the reference's LARGEST production grid,
    # swqg/TwoLayerParameters.jl:5) ------------------------------------------
    grid2k = make_grid(2048)
    model2k = twolayerqg.make_model(grid2k, U=0.2, mu=1e-2,
                                    nu=derive_nu(1.0, 2048, 4, DT), nnu=4)
    init2k, step2k = build_stepper(model2k, "IFMAB3", dt=DT)
    phys2k = np.random.default_rng(7).standard_normal(
        (2, 2048, 2048)).astype(np.float32)
    sol2k = rfft2(jnp.asarray(phys2k)) * grid2k.dealias_mask
    sol2k = (0.3 * sol2k * jnp.exp(-grid2k.Krsq / 20.0**2)
             / jnp.abs(sol2k).max()).astype(jnp.complex64)
    state2k = init2k(sol2k)
    steps2k = 40
    chunk2k = jax.jit(lambda s, st: run(step2k, s, zero_clock(), st,
                                        steps2k))
    t, sp = _timeit(lambda: chunk2k(sol2k, state2k), iters=2, trials=2)
    record("twolayer2048_flow_steps_per_s", steps2k / t, sp,
           f"2048^2 two-layer QG flow: {steps2k / t:.1f} steps/s")
    del sol2k, phys2k, state2k

    # --- fwd+bwd of one differentiable hero step ----------------------------
    h = h512
    init_fn, step_fn = build_stepper(h.model, "IFMAB3", dt=DT)
    rp = h.rp

    @jax.jit
    def grad_step(sol, pkts):
        def loss(s):
            fields_old = fields_from_psih(h.psih_fn(s), h.grid, rp.interp)
            s1, _, _ = step_fn(s, zero_clock(), init_fn(s))
            fields_new = fields_from_psih(h.psih_fn(s1), h.grid, rp.interp)
            out = raytrace(pkts, fields_old, fields_new, 0.0, DT, rp)
            return jnp.mean(out.k**2 + out.l**2)

        return jax.value_and_grad(loss)(sol)

    t, sp = _timeit(lambda: grad_step(h.sol0, h.packets), warmup=1,
                    trials=2)
    record("hero_fwd_bwd_step_s", t, sp,
           f"hero fwd+bwd step: {t * 1e3:.1f} ms")

    # --- gradient through 100 coupled 512^2 steps (remat, taps gather,
    # 16k packets) -----------------------------------------------------------
    h16 = make_hero(sqrt_packets=128, gather="taps")
    frame100 = make_coupled_frame(h16.model, step_fn, h16.psih_fn, h16.rp,
                                  flow_steps=100, k_cutoff=100.0 * h16.k0,
                                  k0=h16.k0, remat=True)

    @jax.jit
    def grad_through_100(s, pkts):
        def loss(s):
            fields0 = fields_from_psih(h16.psih_fn(s), h16.grid,
                                       h16.rp.interp)
            out = frame100(SimState(s, zero_clock(), init_fn(s), pkts,
                                    fields0))
            return jnp.mean(out.packets.k**2 + out.packets.l**2)

        return jax.value_and_grad(loss)(s)

    t, sp = _timeit(lambda: grad_through_100(h16.sol0, h16.packets),
                    warmup=1, iters=2, trials=2)
    record("bwd100_remat_512_s", t, sp,
           f"grad through 100 coupled 512^2 steps "
           f"(remat, taps gather, 16k packets): {t:.2f} s")

    print(json.dumps({
        "metric": "ray-steps/s (1M packets, 512^2 RSW coupled, bf16 tables)",
        "value": rays_per_s,
        "unit": "ray-steps/s",
        "device": device,
        "card": card.strip(),
        "results": results,
    }))


if __name__ == "__main__":
    main()
