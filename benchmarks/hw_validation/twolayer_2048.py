"""Capacity demo: 2048^2 two-layer QG — the reference's LARGEST
production grid (swqg/TwoLayerParameters.jl:5) — stepping on one GPU.

Measures replicated IFMAB3 flow steps/s at 2048^2 (2-field state, 2x2
matrix-exponential blocks) and extracts the barotropic ray fields once.
Memory: state 2x2048x1025 c64 = 34 MB, expm tables 4x that, physical
scratch ~0.5 GB — comfortable on one card; the slab-sharded path
(parallel/sharded.ShardedTwoLayerQG) exists for multi-card scale-out and
is equality-pinned on the 8-device CPU mesh.
"""
from __future__ import annotations

import sys
sys.path.insert(0, __file__.rsplit("/benchmarks/", 1)[0])

import os
import time

import numpy as np


def main(nx=2048, nsteps=20):
    import jax

    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(os.path.dirname(__file__), "..", "..",
                                   ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    import jax.numpy as jnp

    from juliaraytracingsw_tpu.core.grid import make_grid
    from juliaraytracingsw_tpu.core.spectral import rfft2
    from juliaraytracingsw_tpu.core.steppers import zero_clock
    from juliaraytracingsw_tpu.coupled.driver import derive_nu
    from juliaraytracingsw_tpu.models import twolayerqg
    from juliaraytracingsw_tpu.models.base import build_stepper, run
    from juliaraytracingsw_tpu.rays.raytrace import fields_from_psih

    dt = 1e-3
    grid = make_grid(nx)
    model = twolayerqg.make_model(grid, U=0.2, mu=1e-2,
                                  nu=derive_nu(1.0, nx, 4, dt), nnu=4)
    init_fn, step_fn = build_stepper(model, "IFMAB3", dt=dt)
    rng = np.random.default_rng(7)
    phys = rng.standard_normal((2, grid.ny, grid.nx)).astype(np.float32)
    sol = rfft2(jnp.asarray(phys)) * grid.dealias_mask
    sol = (0.3 * sol * jnp.exp(-grid.Krsq / 20.0**2)
           / jnp.abs(sol).max()).astype(jnp.complex64)
    print(f"# device: {jax.devices()[0]}; {nx}^2 two-layer QG")

    @jax.jit
    def chunk(sol, clock, state, c):
        sol = sol * (1.0 + 1e-12 * c)
        return run(step_fn, sol, clock, state, nsteps)

    state, clock = init_fn(sol), zero_clock()
    out = None
    for c in range(2):
        out = chunk(sol, clock, state, jnp.float32(c))
    jax.block_until_ready(out)
    times = []
    for t_i in range(3):
        t0 = time.perf_counter()
        out = chunk(sol, clock, state, jnp.float32(10 + t_i))
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / nsteps)
    t = min(times)
    sol1 = out[0]
    assert bool(jnp.isfinite(jnp.abs(sol1).max())), "2048^2 step NaN"
    print(f"2048^2 two-layer QG flow: {1.0 / t:.1f} steps/s "
          f"({t * 1e3:.2f} ms/step, spread "
          f"{(max(times) - t) / t * 100:.1f}%)")

    # barotropic ray-field extraction at 2048^2 (the coupled-frame per-step
    # collective payload in a sharded run); jitted + warmed
    @jax.jit
    def extract(s, c):
        s = s * (1.0 + 1e-12 * c)
        psih = 0.5 * sum(twolayerqg.streamfunction_from_pv(s, grid,
                                                           model.params))
        return fields_from_psih(psih, grid)

    fields = jax.block_until_ready(extract(sol1, jnp.float32(0)))
    t0 = time.perf_counter()
    fields = jax.block_until_ready(extract(sol1, jnp.float32(1)))
    print(f"2048^2 ray-field extraction: {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"(5 x {nx}^2 fields, {fields.nbytes / 1e6:.0f} MB)")


if __name__ == "__main__":
    main()
