"""Fused Pallas ray kernels against the plain per-stage path, end to end.

Times the coupled hero frame (512^2 RSW IF-AB3 + 1,048,576 packets,
coupled/hero.py) with the fused kernels (``JRSW_FUSED=auto``) and with the
plain per-stage path (``JRSW_FUSED=off``) at ``JRSW_RAY_CHUNK`` = 0 and
65536, for bilinear and bspline RK4 and the adaptive DP5(4)
``loop='while'`` mode (bicubic has no kernel: it measured slower fused). Each row also reports how far the final packet
positions of each mode are from the fused run's. With ``--fft`` it also
times 512^2 and 1024^2 RSW flow steps under ``JRSW_FFT`` = fft, dft, dft3.

Run on a GPU: ``python benchmarks/fused_vs_plain.py [--steps 20] [--fft]``.
Prints one JSON object per row; fails without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = {
    "bilinear": dict(interp="bilinear"),
    "bilinear_bf16": dict(interp="bilinear", table_dtype="bfloat16"),
    "bspline": dict(interp="bspline"),
    "adaptive": dict(interp="bilinear", ray_method="adaptive",
                     ray_opts=dict(rtol=1e-3, atol=1e-6, max_steps=16,
                                   init_substeps=1, loop="while")),
}
MODES = {
    "fused": {"JRSW_FUSED": "auto"},
    "plain_chunk0": {"JRSW_FUSED": "off", "JRSW_RAY_CHUNK": "0"},
    "plain_chunk65536": {"JRSW_FUSED": "off", "JRSW_RAY_CHUNK": "65536"},
}


def _timed(fn, arg, reps):
    import jax

    jax.block_until_ready(fn(arg))      # compile + warm
    times = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    return min(times), (max(times) - min(times)) / min(times), out


def _set_env(env):
    import jax

    for k in ("JRSW_FUSED", "JRSW_RAY_CHUNK", "JRSW_FFT"):
        os.environ.pop(k, None)
    os.environ.update(env)
    jax.clear_caches()


def coupled_rows(cases, steps, reps):
    from juliaraytracingsw_tpu.core.steppers import zero_clock
    from juliaraytracingsw_tpu.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu.coupled.hero import DT, make_hero
    from juliaraytracingsw_tpu.models.base import build_stepper
    from juliaraytracingsw_tpu.rays.raytrace import fields_from_psih

    for case in cases:
        opts = dict(CASES[case])
        method = opts.pop("ray_method", "rk4")
        ray_opts = opts.pop("ray_opts", None)
        hero = make_hero(**opts)
        init_fn, step_fn = build_stepper(hero.model, "IFMAB3", dt=DT)
        fields0 = fields_from_psih(hero.psih_fn(hero.sol0), hero.grid,
                                   hero.rp.interp)
        sim = SimState(hero.sol0, zero_clock(), init_fn(hero.sol0),
                       hero.packets, fields0)
        ref_x = None
        for mode, env in MODES.items():
            _set_env(env)
            frame = make_coupled_frame(hero.model, step_fn, hero.psih_fn,
                                       hero.rp, steps, ray_method=method,
                                       ray_opts=ray_opts)
            t_c = time.perf_counter()
            np.asarray(frame(sim).packets.x)
            compile_s = time.perf_counter() - t_c
            t, spread, out = _timed(frame, sim, reps)
            x = np.asarray(out.packets.x)
            ref_x = x if ref_x is None else ref_x
            print(json.dumps(dict(
                case=case, mode=mode, table_dtype=hero.rp.table_dtype,
                coupled_steps_per_s=steps / t,
                ray_steps_per_s=hero.packets.n * steps / t,
                frame_s=t, spread=spread, first_call_s=compile_s,
                max_dx_vs_fused=float(np.max(np.abs(x - ref_x))),
                finite=bool(np.isfinite(x).all()))), flush=True)


def fft_rows(reps, steps=200):
    import jax

    from juliaraytracingsw_tpu.core.steppers import zero_clock
    from juliaraytracingsw_tpu.coupled.hero import DT, make_hero
    from juliaraytracingsw_tpu.models.base import build_stepper, run

    for nx in (512, 1024):
        hero = make_hero(nx=nx, sqrt_packets=2)
        for impl in ("fft", "dft", "dft3"):
            _set_env({"JRSW_FFT": impl})
            init_fn, step_fn = build_stepper(hero.model, "IFMAB3", dt=DT)
            chunk = jax.jit(lambda s: run(step_fn, s, zero_clock(),
                                          init_fn(s), steps)[0])
            t, spread, out = _timed(chunk, hero.sol0, reps)
            print(json.dumps(dict(
                nx=nx, JRSW_FFT=impl, flow_steps_per_s=steps / t,
                spread=spread,
                finite=bool(np.isfinite(np.asarray(abs(out))).all()))),
                flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--steps", type=int, default=20,
                    help="flow steps per timed coupled frame")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fft", action="store_true",
                    help="also time the JRSW_FFT flow backends")
    args = ap.parse_args()

    import jax

    from juliaraytracingsw_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: jax.devices()[0] is {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(platform=dev.platform, kind=dev.device_kind,
                          count=len(jax.devices()), card=card.strip())),
          flush=True)
    coupled_rows([c for c in args.cases.split(",") if c], args.steps,
                 args.reps)
    if args.fft:
        fft_rows(args.reps)


if __name__ == "__main__":
    main()
