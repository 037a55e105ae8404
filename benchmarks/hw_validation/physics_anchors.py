"""Long-horizon reference-free physics anchors.

Two of the strongest correctness checks available without reference-written
data files (the environment has no Julia runtime and no .jld2 artifacts):

1. **Inviscid-limit energy conservation at scale**: 512^2 RSW, nu=0, no
   filter, >=1000 IF-AB3 steps. The full *nonlinear* invariant

       E = mean[ (1+eta)(u^2+v^2)/2 + Cg^2 eta^2/2 ]

   (the quantity the continuous equations conserve exactly; the quadratic
   KE+PE of the diagnostics is only its small-amplitude limit) must drift
   by less than DRIFT_TOL relative over the horizon. Drift sources are
   time-discretisation error + 2/3-rule truncation only, both of which
   shrink with dt — a blow-up, sign error, or wrong nonlinear term moves
   this by orders of magnitude, not percent.

2. **Coupled-step self-convergence in float64**: the full coupled
   RSW+ray frame run to the same horizon at dt, dt/2, dt/4. The coupled
   system's leading error is the O(dt^2) *linear time blend* of the ray
   fields between flow snapshots (the same blend the reference uses,
   GPURaytracing.jl:33) — the flow's AB3 is O(dt^3) and RK4 O(dt^4), so
   the Richardson ratio err(dt->dt/4)/err(dt/2->dt/4) should approach the
   2nd-order value 5 (measured 4.8 at 64^2 CPU scale); a broken step
   update shows ~1 (no convergence) instead.

Run on a GPU (no env overrides) or the CPU (JAX_PLATFORMS=cpu);
``chip_smoke.py`` runs the energy-drift anchor on the card.
"""
from __future__ import annotations

import sys
sys.path.insert(0, __file__.rsplit("/benchmarks/", 1)[0])

import time

import numpy as np

import jax
import jax.numpy as jnp

from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.spectral import irfft2
from juliaraytracingsw_tpu.core.steppers import zero_clock
from juliaraytracingsw_tpu.coupled.driver import SimState, make_coupled_frame
from juliaraytracingsw_tpu.coupled.initial_conditions import band_geo_wave_ic
from juliaraytracingsw_tpu.models import rsw
from juliaraytracingsw_tpu.models.base import build_stepper, run
from juliaraytracingsw_tpu.rays.packets import lattice_packets
from juliaraytracingsw_tpu.rays.raytrace import RayParams, fields_from_psih

DRIFT_TOL = 2e-3   # relative E drift over 1000 inviscid 512^2 steps
F0, CG = 3.0, 1.0


def nonlinear_energy(sol, grid, Cg: float):
    """Exact RSW invariant: mean[(1+eta)(u^2+v^2)/2 + Cg^2 eta^2/2].

    Jitted; XLA's pairwise reduction keeps the f32 mean accurate to
    ~1e-7 relative, well under DRIFT_TOL."""

    @jax.jit
    def _e(s):
        u, v, eta = irfft2(s, grid.nx)
        e = (1.0 + eta) * (u**2 + v**2) / 2.0 + Cg**2 * eta**2 / 2.0
        return jnp.mean(e)

    return float(_e(sol))


def anchor_energy_drift(nx=512, nsteps=1000, dt=5e-4, amp=0.2):
    grid = make_grid(nx)
    model = rsw.make_model(grid, nu=0.0, nnu=4, f=F0, Cg=CG)   # inviscid
    init_fn, step_fn = build_stepper(model, "IFMAB3", dt=dt)
    rng = np.random.default_rng(42)
    sol = band_geo_wave_ic(grid, rng, Kg=(10, 13), Kw=(0, 5), ag=amp,
                           aw=amp / 10, f=F0, Cg=CG)
    e0 = nonlinear_energy(sol, grid, CG)
    t0 = time.time()
    # the whole horizon is one jitted scan
    sol1, clock, _ = jax.block_until_ready(jax.jit(
        lambda s, c, st: run(step_fn, s, c, st, nsteps)
    )(sol, zero_clock(), init_fn(sol)))
    wall = time.time() - t0
    e1 = nonlinear_energy(sol1, grid, CG)
    drift = abs(e1 - e0) / abs(e0)
    ok = np.isfinite(e1) and drift < DRIFT_TOL
    print(f"[energy-drift] {nx}^2 inviscid RSW, {nsteps} steps (dt={dt}): "
          f"E {e0:.8f} -> {e1:.8f}, rel drift {drift:.3e} "
          f"(tol {DRIFT_TOL:.0e}) wall {wall:.1f}s -> "
          f"{'PASS' if ok else 'FAIL'}")
    return ok


def _coupled_final(grid, model, sol0, pk, dt, T):
    init_fn, step_fn = build_stepper(model, "IFMAB3", dt=dt)
    params = model.params

    def psih_fn(sol):
        qh = grid.ik * sol[1] - grid.il * sol[0] - params.f * sol[2]
        return -qh / (grid.Krsq + params.f**2 / params.Cg2)

    rp = RayParams(f=F0, Cg=CG, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy)
    nsteps = int(round(T / dt))
    frame = make_coupled_frame(model, step_fn, psih_fn, rp, nsteps)
    fields0 = fields_from_psih(psih_fn(sol0), grid, rp.interp)
    sim = SimState(sol0, zero_clock(jnp.float64), init_fn(sol0), pk, fields0)
    out = jax.block_until_ready(frame(sim))
    return np.stack([np.asarray(out.packets.x), np.asarray(out.packets.y),
                     np.asarray(out.packets.k), np.asarray(out.packets.l)])


def anchor_self_convergence(nx=128, T=0.064, dt0=4e-3):
    """Trajectory self-convergence of the FULL coupled step under dt halving
    (float64): err(dt)/err(dt/2) should approach the flow-substep order."""
    jax.config.update("jax_enable_x64", True)
    try:
        grid = make_grid(nx, dtype=jnp.float64)
        from juliaraytracingsw_tpu.coupled.driver import derive_nu

        model = rsw.make_model(grid, nu=derive_nu(1.0, nx, 4, dt0), nnu=4,
                               f=F0, Cg=CG)
        rng = np.random.default_rng(3)
        sol0 = band_geo_wave_ic(grid, rng, Kg=(4, 7), Kw=(0, 3), ag=0.3,
                                aw=0.03, f=F0, Cg=CG).astype(jnp.complex128)
        k0 = float(np.sqrt(3.0) * F0 / CG)
        pk = lattice_packets(8, grid.Lx, grid.Ly, k0=k0, k_ring=True,
                             dtype=jnp.float64)
        trajs = [
            _coupled_final(grid, model, sol0, pk, dt0 / (2**i), T)
            for i in range(3)
        ]
        e01 = float(np.max(np.abs(trajs[0] - trajs[2])))
        e12 = float(np.max(np.abs(trajs[1] - trajs[2])))
        # errors vs the dt/4 run: ratio ~ 2^p between dt and dt/2
        ratio = e01 / max(e12, 1e-30)
        ok = np.isfinite(ratio) and ratio >= 4.0 and e12 < 1e-4
        print(f"[self-convergence] {nx}^2 coupled f64, T={T}: "
              f"max|x(dt)-x(dt/4)|={e01:.3e} max|x(dt/2)-x(dt/4)|={e12:.3e} "
              f"ratio {ratio:.1f} (~5 expected: O(dt^2) linear time blend "
              f"dominates) -> {'PASS' if ok else 'FAIL'}")
        return ok
    finally:
        jax.config.update("jax_enable_x64", False)


if __name__ == "__main__":
    # `drift` runs on the attached accelerator; `conv` runs in float64 —
    # run it with JAX_PLATFORMS=cpu. No arg = both.
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    print(f"# device: {jax.devices()[0]}")
    ok = True
    if which in ("drift", "both"):
        ok = anchor_energy_drift() and ok
    if which in ("conv", "both"):
        ok = anchor_self_convergence() and ok
    sys.exit(0 if ok else 1)
