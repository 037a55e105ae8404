"""End-to-end SWQG + WKB-rays drive of the public package API.

The canonical verification drive (see .claude/skills/verify/SKILL.md):
  1. flow-only 500-step energy-conservation run,
  2. coupled flow/ray loop with k-cutoff resets,
  3. gradient probe through one coupled step,
  4. misuse probe (unknown stepper name).

Runs on 8 virtual CPU devices by default; delete the two config lines to run
on a GPU.
"""
import os
import sys

os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=8"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from juliaraytracingsw_tpu.core.grid import make_grid
from juliaraytracingsw_tpu.core.steppers import zero_clock
from juliaraytracingsw_tpu.coupled.initial_conditions import random_band_psih
from juliaraytracingsw_tpu.models import swqg
from juliaraytracingsw_tpu.models.base import build_stepper, run
from juliaraytracingsw_tpu.rays.packets import lattice_packets
from juliaraytracingsw_tpu.rays.raytrace import (RayParams, fields_from_psih,
                                                 raytrace)
from juliaraytracingsw_tpu.rays.resample import k_cutoff_reset

# 1. flow-only energy drift
g = make_grid(128)
f, Cg, dt = 3.0, 1.0, 2e-3
model = swqg.make_model(g, nu=1e-16, nnu=4, f=f, Cg=Cg)
rng = np.random.default_rng(7)
psih0 = random_band_psih(g, rng, kband=(3, 6), amp=0.3)
sol0 = swqg.pv_from_streamfunction(psih0, g, model.params)
init_fn, step_fn = build_stepper(model, "IFMAB3", dt, use_filter=True)
sol, clock, state = run(step_fn, sol0, zero_clock(), init_fn(sol0), 500)
e0 = float(swqg.energy(sol0, g, model.params))
e1 = float(swqg.energy(sol, g, model.params))
assert np.isfinite(e1), "energy not finite"
drift = abs(e1 - e0) / e0
print(f"1. flow 500 steps: E0={e0:.6g} E1={e1:.6g} drift={drift:.3%}")
assert drift < 0.01, "energy drift too large"

# 2. coupled rays
rp = RayParams(f=f, Cg=Cg, x0=float(g.x[0]), y0=float(g.y[0]),
               dx=g.dx, dy=g.dy)
k0 = np.sqrt(3.0) * f / Cg
pk = lattice_packets(16, g.Lx, g.Ly, k0=float(k0), k_ring=True)
psih_fn = lambda s: swqg.streamfunction_from_pv(s, g, model.params)
fields = fields_from_psih(psih_fn(sol), g, rp.interp)
t = 0.0
for i in range(10):
    sol, clock, state = run(step_fn, sol, clock, state, 1)
    new_fields = fields_from_psih(psih_fn(sol), g, rp.interp)
    pk = raytrace(pk, fields, new_fields, t, t + dt, rp, nsubsteps=2)
    pk = k_cutoff_reset(pk, k_cutoff=50.0 * k0, k0=float(k0))
    fields = new_fields
    t += dt
K = np.hypot(np.asarray(pk.k), np.asarray(pk.l))
assert np.isfinite(np.asarray(pk.x)).all() and np.isfinite(K).all()
spread = float(K.std() / K.mean())
print(f"2. rays: |k| mean={K.mean():.4g} rel-spread={spread:.2e} "
      f"max={K.max():.4g}")
assert K.max() <= 50.0 * k0 + 1e-3
assert spread > 1e-7, "no refraction at all?"


# 3. gradient probe
def loss(s0):
    s1, c1, st1 = step_fn(s0, zero_clock(), init_fn(s0))
    fo = fields_from_psih(psih_fn(s0), g, rp.interp)
    fn_ = fields_from_psih(psih_fn(s1), g, rp.interp)
    out = raytrace(pk, fo, fn_, 0.0, dt, rp, nsubsteps=1)
    return jnp.mean(out.k**2 + out.l**2)


val, grad = jax.value_and_grad(loss)(sol)
gn = float(jnp.linalg.norm(grad))
print(f"3. grad: loss={float(val):.6g} |grad|={gn:.6g}")
assert np.isfinite(gn) and gn > 0

# 4. misuse probe
try:
    build_stepper(model, "NoSuchStepper", dt)
    raise SystemExit("FAIL: no error for bad stepper")
except ValueError as e:
    print(f"4. misuse: ValueError: {e}")
print("VERIFY OK")
