"""Fused Pallas ray kernels (ops/pallas_ray_step, Triton route) against the
plain per-stage patch path: forward and gradient equality in the Pallas
interpreter, block padding, the adaptive attempt kernel, and the dispatch
in rays/raytrace (GPU -> kernel, elsewhere -> plain path, JRSW_FUSED)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from juliaraytracingsw_tpu.ops.pallas_ray_step import (
    BLOCK,
    FUSED_INTERPS,
    attempt_jnp,
    make_fused_attempt,
    make_fused_substep,
    substep_jnp,
)
from juliaraytracingsw_tpu.rays.packets import lattice_packets
from juliaraytracingsw_tpu.rays.patch import build_patch_table
from juliaraytracingsw_tpu.rays.raytrace import (
    RayParams,
    _use_fused,
    make_pair_table,
    raytrace_adaptive,
    raytrace_tables,
)

L = 2 * np.pi
NY = NX = 32


def _setup(interp, table_dtype="float32", seed=0, sqrtp=10, amp=0.1):
    rng = np.random.default_rng(seed)
    # bicubic uses the stacked [f|fx|fy|fxy] corner-data layout (4x5 ch);
    # random data suffices for impl-consistency pins
    nch = 20 if interp == "bicubic" else 5
    fo = jnp.asarray(rng.standard_normal((nch, NY, NX)) * amp, jnp.float32)
    fn = jnp.asarray(rng.standard_normal((nch, NY, NX)) * amp, jnp.float32)
    rp = RayParams(f=3.0, Cg=1.0, x0=0.0, y0=0.0, dx=L / NX, dy=L / NY,
                   interp=interp, table_dtype=table_dtype)
    # 100 packets: not a multiple of the kernel block, so padding is live
    pk = lattice_packets(sqrtp, L, L, k0=5.196, k_ring=True)
    T_pair = make_pair_table(build_patch_table(fo, interp),
                             build_patch_table(fn, interp), table_dtype)
    return rp, pk, T_pair, fo, fn


def _args(pk, T):
    return (T, pk.x, pk.y, pk.k, pk.l, pk.sign)


def _plain(pk, T, rp, t1=0.01, nsub=1):
    os.environ["JRSW_FUSED"] = "off"
    try:
        jax.clear_caches()
        return raytrace_tables(pk, T, 0.0, t1, rp, NY, NX, nsub, "rk4")
    finally:
        del os.environ["JRSW_FUSED"]
        jax.clear_caches()


def _close(a_list, b_list, rtol=1e-5, atol=1e-6):
    for a, b in zip(a_list, b_list):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interp", FUSED_INTERPS)
def test_kernel_matches_per_stage_path(interp, table_dtype):
    """The interpreted kernel (in-kernel tap gathers, all RK4 stages fused)
    reproduces the plain per-stage sampler on the same pair table — f32
    and bf16 tables alike (both upcast the same stored values)."""
    rp, pk, T, _, _ = _setup(interp, table_dtype)
    ref = _plain(pk, T, rp)
    kern = make_fused_substep(rp, 1.0, NY, NX, interpret=True)
    out = kern(*_args(pk, T), jnp.array([0.0, 0.01], jnp.float32))
    _close(out, (ref.x, ref.y, ref.k, ref.l))


@pytest.mark.parametrize("interp", FUSED_INTERPS)
def test_twin_matches_per_stage_path(interp):
    rp, pk, T, _, _ = _setup(interp)
    ref = _plain(pk, T, rp)
    out = substep_jnp(*_args(pk, T), jnp.array([0.0, 0.01], jnp.float32),
                      rp=rp, da=1.0, ny=NY, nx=NX)
    _close(out, (ref.x, ref.y, ref.k, ref.l))


@pytest.mark.parametrize("sqrtp", [10, 16])
def test_kernel_block_padding_matches_twin(sqrtp):
    """N = 100 pads to one 128-packet block, N = 256 fills two exactly;
    either way the kernel equals its twin to round-off and returns N."""
    assert BLOCK == 128
    rp, pk, T, _, _ = _setup("bilinear", sqrtp=sqrtp)
    scal = jnp.array([0.2, 0.01], jnp.float32)
    kern = make_fused_substep(rp, 0.5, NY, NX, interpret=True)
    out = kern(*_args(pk, T), scal)
    twin = substep_jnp(*_args(pk, T), scal, rp=rp, da=0.5, ny=NY, nx=NX)
    assert all(o.shape == (sqrtp * sqrtp,) for o in out)
    _close(out, twin, rtol=1e-6, atol=1e-7)


def test_kernel_custom_vjp_matches_plain_gradient():
    """The kernel's backward linearises the plain per-stage formulation, so
    its table and packet gradients equal those of the plain path."""
    rp, pk, T, _, _ = _setup("bilinear")
    kern = make_fused_substep(rp, 1.0, NY, NX, interpret=True)

    def loss_kern(T_, k_):
        o = kern(T_, pk.x, pk.y, k_, pk.l, pk.sign,
                 jnp.array([0.0, 0.01], jnp.float32))
        return jnp.sum(o[2] ** 2 + o[3] ** 2)

    def loss_plain(T_, k_):
        o = raytrace_tables(pk._replace(k=k_), T_, 0.0, 0.01, rp, NY, NX,
                            1, "rk4")
        return jnp.sum(o.k ** 2 + o.l ** 2)

    gk = jax.grad(loss_kern, argnums=(0, 1))(T, pk.k)
    os.environ["JRSW_FUSED"] = "off"
    try:
        gp = jax.grad(loss_plain, argnums=(0, 1))(T, pk.k)
    finally:
        del os.environ["JRSW_FUSED"]
    _close(gk, gp)
    assert float(jnp.abs(gk[0]).max()) > 0


def test_raytrace_tables_interpret_gradient_flows_to_table():
    rp, pk, T, _, _ = _setup("bilinear")

    def loss(T_):
        out = raytrace_tables(pk, T_, 0.0, 0.01, rp, NY, NX, 2, "rk4",
                              interpret=True)
        return jnp.mean(out.k ** 2 + out.l ** 2)

    g = jax.grad(loss)(T)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


def test_raytrace_tables_interpret_matches_plain_multistep():
    """Through the dispatch: 4 substeps with a traced a0 per substep."""
    rp, pk, T, _, _ = _setup("bilinear")
    ref = _plain(pk, T, rp, t1=0.02, nsub=4)
    out = raytrace_tables(pk, T, 0.0, 0.02, rp, NY, NX, 4, "rk4",
                          interpret=True)
    _close(out, ref)


def test_attempt_kernel_matches_twin():
    """Interpreted attempt kernel == jnp attempt twin (values + error sum)."""
    rp, pk, T, _, _ = _setup("bilinear", sqrtp=8)
    scal = jnp.array([0.0, 1.0, 0.01, 1e-5, 1e-7], jnp.float32)
    kern = make_fused_attempt(rp, NY, NX, interpret=True)
    out_k = kern(*_args(pk, T), scal)
    out_t = attempt_jnp(*_args(pk, T), scal, rp=rp, ny=NY, nx=NX)
    _close(out_k[:4], out_t[:4], rtol=1e-6, atol=1e-7)
    # the error sum is h * sum (b - b4)_i k_i — a catastrophic
    # cancellation of O(1) stage slopes down to O(h^5), so only absolute
    # agreement at the cancellation floor is meaningful
    np.testing.assert_allclose(np.asarray(out_k[4]), np.asarray(out_t[4]),
                               rtol=0.1, atol=2e-4)


def test_attempt_kernel_matches_adaptive_while():
    """raytrace_adaptive(loop='while') through the interpreted attempt
    kernel reproduces the plain chunked attempt: trajectories AND the
    accept/reject decisions."""
    rp, pk, _, fo, fn = _setup("bilinear", seed=3, sqrtp=8, amp=0.05)
    kwargs = dict(rtol=1e-5, atol=1e-7, max_steps=16, init_substeps=2,
                  pair="dopri5", loop="while")
    ref, info_ref = raytrace_adaptive(pk, fo, fn, 0.0, 0.02, rp, **kwargs)
    out, info = raytrace_adaptive(pk, fo, fn, 0.0, 0.02, rp, **kwargs,
                                  interpret=True)
    assert int(info["n_accepted"]) == int(info_ref["n_accepted"])
    assert int(info["n_rejected"]) == int(info_ref["n_rejected"])
    _close(out[:4], ref[:4])


def test_dispatch_cpu_runs_plain_path():
    """Off the GPU the default (auto) dispatch runs the plain per-stage
    path: identical to JRSW_FUSED=off."""
    rp, pk, T, _, _ = _setup("bspline")
    assert jax.default_backend() == "cpu"
    assert not _use_fused(rp)
    assert _use_fused(rp, interpret=True)
    out = raytrace_tables(pk, T, 0.0, 0.01, rp, NY, NX, 1, "rk4")
    _close(out, _plain(pk, T, rp), rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["pallas", "interpret", "jnp"])
def test_dispatch_rejects_removed_modes(mode):
    rp = _setup("bilinear")[0]
    os.environ["JRSW_FUSED"] = mode
    try:
        with pytest.raises(ValueError, match="JRSW_FUSED"):
            _use_fused(rp)
    finally:
        del os.environ["JRSW_FUSED"]


def test_dispatch_bicubic_runs_plain_path():
    """Bicubic has no fused kernel (it measured slower than the plain path
    on the H100), so it runs the plain path even when the kernels are
    forced into the interpreter."""
    rp, pk, T, _, _ = _setup("bicubic")
    assert "bicubic" not in FUSED_INTERPS
    assert not _use_fused(rp, interpret=True)
    out = raytrace_tables(pk, T, 0.0, 0.01, rp, NY, NX, 1, "rk4",
                          interpret=True)
    _close(out, _plain(pk, T, rp), rtol=0, atol=0)


@pytest.mark.parametrize("chunk", ["0", "32"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_bicubic_plain_path_matches_taps_oracle(table_dtype, chunk,
                                                monkeypatch):
    """The path bicubic runs on every backend (plain per-stage patch
    sampler, packet-chunked or not, f32 or bf16 tables) tracks the taps
    oracle over one flow interval."""
    from juliaraytracingsw_tpu.core.grid import make_grid
    from juliaraytracingsw_tpu.coupled.initial_conditions import (
        random_band_psih)
    from juliaraytracingsw_tpu.rays.raytrace import fields_from_psih, raytrace

    g = make_grid(32)
    rng = np.random.default_rng(11)
    f0 = fields_from_psih(random_band_psih(g, rng, amp=0.05), g, "bicubic")
    f1 = fields_from_psih(random_band_psih(g, rng, amp=0.05), g, "bicubic")
    p = lattice_packets(8, g.Lx, g.Ly, k0=6.0, k_ring=True)
    base = dict(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]),
                dx=g.dx, dy=g.dy, interp="bicubic")
    oracle = raytrace(p, f0, f1, 0.0, 0.1, RayParams(**base, gather="taps"),
                      nsubsteps=4)
    monkeypatch.setenv("JRSW_RAY_CHUNK", chunk)
    jax.clear_caches()
    try:
        out = raytrace(p, f0, f1, 0.0, 0.1,
                       RayParams(**base, table_dtype=table_dtype), nsubsteps=4)
    finally:
        monkeypatch.delenv("JRSW_RAY_CHUNK")
        jax.clear_caches()
    # f32 tables: FP association only; bf16 tables: ~2^-8 relative field
    # rounding acting over t = 0.1 (tests/test_rays.py bf16 bounds)
    tol = 2e-5 if table_dtype == "float32" else 2e-3
    for a, b in zip(out[:4], oracle[:4]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=tol, atol=tol)


def test_dispatch_off_wins_over_interpret():
    rp = _setup("bilinear")[0]
    os.environ["JRSW_FUSED"] = "off"
    try:
        assert not _use_fused(rp, interpret=True)
    finally:
        del os.environ["JRSW_FUSED"]


@pytest.mark.gpu
@pytest.mark.parametrize("interp", FUSED_INTERPS)
def test_compiled_kernel_matches_twin_on_gpu(gpu, interp):
    """The Triton-compiled kernel on the card equals its jnp twin."""
    rp, pk, T, _, _ = _setup(interp)
    scal = jnp.array([0.0, 0.01], jnp.float32)
    out = make_fused_substep(rp, 1.0, NY, NX)(*_args(pk, T), scal)
    twin = substep_jnp(*_args(pk, T), scal, rp=rp, da=1.0, ny=NY, nx=NX)
    _close(out, twin)


@pytest.mark.parametrize("impl", ["mxu", "pairsplit"])
@pytest.mark.parametrize("interp", ["bilinear", "bspline", "bicubic"])
def test_patch_impl_mxu_matches_split(interp, impl):
    """JRSW_PATCH_IMPL={mxu,pairsplit} (single-pass pair-row stage math)
    reproduces the 'split' oracle through raytrace_tables. The oracle is
    selected EXPLICITLY (the default is pairsplit, so an implicit
    reference would compare pairsplit with itself)."""
    rp, pk, T_pair, _, _ = _setup(interp, sqrtp=16)
    os.environ["JRSW_PATCH_IMPL"] = "split"
    try:
        jax.clear_caches()
        out_ref = raytrace_tables(pk, T_pair, 0.0, 0.02, rp, NY, NX, 4,
                                  "rk4")
        os.environ["JRSW_PATCH_IMPL"] = impl
        jax.clear_caches()
        out = raytrace_tables(pk, T_pair, 0.0, 0.02, rp, NY, NX, 4, "rk4")
    finally:
        del os.environ["JRSW_PATCH_IMPL"]
        jax.clear_caches()
    _close(out, out_ref)
