"""Spectral transforms, derivatives and Parseval energetics.

FFT convention: forward unnormalised, inverse 1/(nx*ny) — identical to
FFTW / FourierFlows ``mul!``/``ldiv!`` with an rfft plan (reference
rsw/RotatingShallowWater.jl:110-113), so spectral fields are numerically
comparable with the reference.

All transforms operate on the *last two* axes, so a channel-leading
``(C, ny, nx)`` stack transforms in one batched FFT call (one fusion, no
per-field dispatch).

Transform backend (``JRSW_FFT``, read at trace time):

- ``auto`` / ``fft`` (default): ``jnp.fft`` (cuFFT on a GPU).
- ``dft``: dense-DFT matmuls, f32-HIGHEST (~3e-7 relative), for even
  square grids up to ``_DFT_MAX_NX`` (dealias-folded transforms up to
  ``_DFT_FOLD_MAX_NX``). O(N) more FLOPs than an FFT, as matrix products.
- ``dft3``: the dense DFT with the BF16_BF16_F32_X3 dot algorithm
  (~2.4e-5 relative).

Equality with ``jnp.fft`` is pinned by tests/test_core.py.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "rfft2",
    "irfft2",
    "rfft2_dealiased",
    "irfft2_dealiased",
    "parseval_sum",
    "parseval_sum2",
    "enforce_reality",
    "spectral_gradients",
]

_DFT_MAX_NX = 512        # plain transforms: dense cost grows N^3 vs the
                         # FFT's N^2 log N
_DFT_FOLD_MAX_NX = 2048  # dealias-FOLDED transforms compute only the kept
                         # 2/3 modes (~0.45x the matmuls). JRSW_DFT_MAX_NX
                         # overrides both gates.


def _dft_max_nx(folded: bool = False) -> int:
    env = os.environ.get("JRSW_DFT_MAX_NX")
    if env is not None:
        return int(env)
    return _DFT_FOLD_MAX_NX if folded else _DFT_MAX_NX


def _fft_impl() -> str:
    mode = os.environ.get("JRSW_FFT", "auto")
    return "fft" if mode == "auto" else mode


_DFT_TABLES: dict = {}


def _dft_tables(ny: int, nx: int):
    """Host f32 DFT factor matrices for (ny, nx), cached; they embed into
    jitted executables as constants (real data — no complex h2d)."""
    key = (ny, nx)
    if key in _DFT_TABLES:
        return _DFT_TABLES[key]
    nkr = nx // 2 + 1
    ang2 = 2.0 * np.pi * np.outer(np.arange(ny), np.arange(ny)) / ny
    angk = 2.0 * np.pi * np.outer(np.arange(nx), np.arange(nkr)) / nx
    wk = np.where((np.arange(nkr) == 0) | (np.arange(nkr) == nx // 2),
                  1.0, 2.0)
    t = dict(
        # inverse: axis -2 c2c with +i exponent and 1/ny, then hermitian
        # irfft along -1 with the conjugate-doubling weights and 1/nx
        icos=(np.cos(ang2) / ny).astype(np.float32),
        isin=(np.sin(ang2) / ny).astype(np.float32),
        iar=(np.cos(angk) * wk / nx).astype(np.float32),
        iai=(-np.sin(angk) * wk / nx).astype(np.float32),
        # forward: rfft along -1 (unnormalised, -i exponent), axis -2 c2c
        fr=np.cos(angk).T.astype(np.float32),
        fi=(-np.sin(angk)).T.astype(np.float32),
        fcos=np.cos(ang2).astype(np.float32),
        fsin=(-np.sin(ang2)).astype(np.float32),
    )
    # Karatsuba sums for the 3-multiply c2c middle stage (_cmul2)
    t["ics"] = t["icos"] + t["isin"]
    t["fcs"] = t["fcos"] + t["fsin"]
    _DFT_TABLES[key] = t
    return t


def _dft1_tables(n: int):
    """1-D c2c DFT factor matrices (cos, sin, icos, isin) for the sharded
    slab transforms' distributed axis (parallel/fft.py); forward
    unnormalised e^{-i}, inverse (icos/isin) e^{+i}/n."""
    key = ("1d", n)
    if key in _DFT_TABLES:
        return _DFT_TABLES[key]
    ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(n)) / n
    t = dict(
        cos=np.cos(ang).astype(np.float32),
        sin=np.sin(ang).astype(np.float32),
        icos=(np.cos(ang) / n).astype(np.float32),
        isin=(np.sin(ang) / n).astype(np.float32),
    )
    # Karatsuba sums (_cmul2): forward kernel is cos - i*sin, inverse
    # kernel is (cos + i*sin)/n
    t["fks"] = t["cos"] - t["sin"]
    t["iks"] = t["icos"] + t["isin"]
    _DFT_TABLES[key] = t
    return t


def _dft_precision():
    if _fft_impl() == "dft3":
        return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    return jax.lax.Precision.HIGHEST


def _dft_supported(ny: int, nx: int, dtype, folded: bool = False) -> bool:
    if _fft_impl() == "fft":
        return False
    return (nx == ny and nx % 2 == 0 and nx <= _dft_max_nx(folded)
            and dtype in (jnp.float32, jnp.complex64))


def _mm2(A, x, prec):
    """Contract axis -2 of (..., M, K) with (J, M) -> (..., J, K)."""
    return jnp.einsum("jm,...mk->...jk", A, x, precision=prec)


def _use_3m() -> bool:
    return os.environ.get("JRSW_DFT_3M", "on") != "off"


def _cmul2(Ac, As, Asum, xr, xi, prec):
    """(Ac + i As) @ (xr + i xi) over axis -2, returning (real, imag).

    Default: the 3-multiply Karatsuba form — M1 = Ac@xr, M2 = As@xi,
    M3 = (Ac+As)@(xr+xi); re = M1 - M2, im = M3 - M1 - M2 — which drops
    the c2c middle stage of every dense-DFT transform from 4 matmuls to 3
    (the stage is ~57% of the transform MACs). ``Asum = Ac + As`` is a host
    constant. Rounding grows ~2x over the 4-matmul form (still f32
    round-off class under HIGHEST; pinned by tests/test_core.py).
    ``JRSW_DFT_3M=off`` restores the 4-matmul form.
    """
    if not _use_3m():
        return (_mm2(Ac, xr, prec) - _mm2(As, xi, prec),
                _mm2(Ac, xi, prec) + _mm2(As, xr, prec))
    m1 = _mm2(Ac, xr, prec)
    m2 = _mm2(As, xi, prec)
    m3 = _mm2(Asum, xr + xi, prec)
    return m1 - m2, m3 - m1 - m2


def _mmk(x, A, prec):
    """Contract the last axis of (..., J, K) with (N, K) -> (..., J, N)."""
    return jnp.einsum("...jk,nk->...jn", x, A, precision=prec)


def rfft2(field: jax.Array) -> jax.Array:
    """Real -> half-complex transform over the last two axes."""
    ny, nx = field.shape[-2], field.shape[-1]
    if _dft_supported(ny, nx, field.dtype):
        t = _dft_tables(ny, nx)
        prec = _dft_precision()
        zr = _mmk(field, t["fr"], prec)
        zi = _mmk(field, t["fi"], prec)
        wr, wi = _cmul2(t["fcos"], t["fsin"], t["fcs"], zr, zi, prec)
        return jax.lax.complex(wr, wi)
    return jnp.fft.rfft2(field, axes=(-2, -1))


def irfft2(fieldh: jax.Array, nx: int) -> jax.Array:
    """Half-complex -> real inverse transform over the last two axes.

    ``nx`` disambiguates odd/even physical size of the last axis.
    """
    ny = fieldh.shape[-2]
    if _dft_supported(ny, nx, fieldh.dtype):
        t = _dft_tables(ny, nx)
        prec = _dft_precision()
        xr, xi = jnp.real(fieldh), jnp.imag(fieldh)
        yr, yi = _cmul2(t["icos"], t["isin"], t["ics"], xr, xi, prec)
        return _mmk(yr, t["iar"], prec) + _mmk(yi, t["iai"], prec)
    return jnp.fft.irfft2(fieldh, s=(fieldh.shape[-2], nx), axes=(-2, -1))


_FOLD_CACHE: dict = {}


def _fold_info(grid):
    """(a, b, nkx) keep-block structure of the rectangular dealias mask:
    kept l-rows are [0, a) and [ny-b, ny); kept kr-columns are [0, nkx).
    Returns None if the mask is not rectangular-contiguous."""
    key = (grid.ny, grid.nx, float(grid.aliased_fraction))
    if key in _FOLD_CACHE:
        return _FOLD_CACHE[key]
    m = np.asarray(grid.dealias_mask) > 0
    ny = grid.ny
    rows = m[:, 0]
    cols = m[0, :]
    nkx = int(cols.sum())
    a = int(rows[: ny // 2 + 1].sum())
    b = int(rows[ny // 2 + 1:].sum())
    ok = (bool((cols[:nkx]).all()) and not cols[nkx:].any()
          and bool(rows[:a].all()) and (b == 0 or bool(rows[ny - b:].all()))
          and int(rows.sum()) == a + b
          and bool((m == (rows[:, None] & cols[None, :])).all()))
    info = (a, b, nkx) if ok else None
    _FOLD_CACHE[key] = info
    return info


def rfft2_dealiased(field: jax.Array, grid) -> jax.Array:
    """``grid.dealias(rfft2(field))`` — with the DFT backend the masked
    modes are FOLDED OUT of the matmuls (never computed): contraction /
    output dims shrink by (1 - aliased_fraction) on both spectral axes,
    ~0.67x the transform FLOPs at the default 1/3 rule. Exact (not an
    approximation): the dropped modes are exactly the ones the mask
    zeroes. Use only where the dealias multiply already follows the
    forward transform (every model calcN)."""
    ny, nx = field.shape[-2], field.shape[-1]
    info = _fold_info(grid)
    if info is None or not _dft_supported(ny, nx, field.dtype, folded=True):
        return grid.dealias(jnp.fft.rfft2(field, axes=(-2, -1)))
    a, b, nkx = info
    t = _dft_tables(ny, nx)
    prec = _dft_precision()
    zr = _mmk(field, t["fr"][:nkx], prec)
    zi = _mmk(field, t["fi"][:nkx], prec)
    fcos_k = np.concatenate([t["fcos"][:a], t["fcos"][ny - b:]], 0)
    fsin_k = np.concatenate([t["fsin"][:a], t["fsin"][ny - b:]], 0)
    wr, wi = _cmul2(fcos_k, fsin_k, fcos_k + fsin_k, zr, zi, prec)
    w = jax.lax.complex(wr, wi)
    mid = jnp.zeros(w.shape[:-2] + (ny - a - b, nkx), w.dtype)
    full = jnp.concatenate([w[..., :a, :], mid, w[..., a:, :]], axis=-2)
    pad = jnp.zeros(full.shape[:-1] + (grid.nkr - nkx,), w.dtype)
    return jnp.concatenate([full, pad], axis=-1)


def irfft2_dealiased(fieldh: jax.Array, grid) -> jax.Array:
    """``irfft2(grid.dealias(fieldh), grid.nx)`` with the masked modes
    folded out of the DFT matmuls (see rfft2_dealiased)."""
    ny, nx = fieldh.shape[-2], grid.nx
    info = _fold_info(grid)
    if info is None or not _dft_supported(ny, nx, fieldh.dtype, folded=True):
        return jnp.fft.irfft2(grid.dealias(fieldh), s=(ny, nx),
                              axes=(-2, -1))
    a, b, nkx = info
    t = _dft_tables(ny, nx)
    prec = _dft_precision()
    xk = jnp.concatenate([fieldh[..., :a, :nkx], fieldh[..., ny - b:, :nkx]],
                         axis=-2)
    xr, xi = jnp.real(xk), jnp.imag(xk)
    icos_k = np.concatenate([t["icos"][:, :a], t["icos"][:, ny - b:]], 1)
    isin_k = np.concatenate([t["isin"][:, :a], t["isin"][:, ny - b:]], 1)
    yr, yi = _cmul2(icos_k, isin_k, icos_k + isin_k, xr, xi, prec)
    return _mmk(yr, t["iar"][:, :nkx], prec) + _mmk(yi, t["iai"][:, :nkx],
                                                    prec)


def _doubling_weights(grid) -> jax.Array:
    """Conjugate-symmetry doubling weights for rfft storage.

    Column kr=0 appears once; all kr>0 columns represent +/- k pairs. Matches
    FourierFlows ``parsevalsum2`` which doubles every kr>0 column (including
    Nyquist — harmless for dealiased fields where that column is zero).
    """
    w = jnp.ones((grid.nkr,), jnp.float32).at[1:].set(2.0)
    if grid.nx % 2 == 0:
        # the kr = nx/2 Nyquist column is self-conjugate: count once
        w = w.at[-1].set(1.0)
    return w[None, :]


def parseval_sum2(fieldh: jax.Array, grid) -> jax.Array:
    """sum |f|^2 over physical space = Lx*Ly/(nx^2 ny^2) * sum_modes w*|fh|^2.

    Equivalent of FourierFlows ``parsevalsum2`` (used by every energy
    diagnostic, e.g. reference rsw/RotatingShallowWater.jl:323-336).
    """
    w = _doubling_weights(grid)
    norm = grid.Lx * grid.Ly / (grid.nx**2 * grid.ny**2)
    return norm * jnp.sum(w * jnp.abs(fieldh) ** 2, axis=(-2, -1))


def parseval_sum(fieldh: jax.Array, grid) -> jax.Array:
    """Real part of the mode sum with conjugate doubling (FourierFlows
    ``parsevalsum``): integrates a real quantity stored spectrally."""
    w = _doubling_weights(grid)
    norm = grid.Lx * grid.Ly / (grid.nx**2 * grid.ny**2)
    return norm * jnp.sum(w * jnp.real(fieldh), axis=(-2, -1))


def enforce_reality(solh: jax.Array, grid) -> jax.Array:
    """Purge conjugate-symmetry drift by a physical-space round trip.

    Equivalent of the reference ``enforce_reality_condition!``
    (rsw/RotatingShallowWater.jl:118-133): irfft . rfft projects onto the
    exactly-conjugate-symmetric subspace.
    """
    return rfft2(irfft2(grid.dealias(solh), grid.nx))


def spectral_gradients(psih: jax.Array, grid):
    """Velocity and velocity-gradient spectra from a streamfunction.

    u = -psi_y, v = psi_x; returns (uh, vh, uxh, uyh, vxh) —
    v_y = -u_x by incompressibility (reference
    swqg/RaytracingDriver.jl:164-185, raytracing/GPURaytracing.jl:62-64).
    """
    ik, il = grid.ik, grid.il
    uh = -il * psih
    vh = ik * psih
    uxh = ik * uh
    uyh = il * uh
    vxh = ik * vh
    return uh, vh, uxh, uyh, vxh
