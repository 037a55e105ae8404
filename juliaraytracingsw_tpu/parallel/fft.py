"""Slab-decomposed distributed 2-D real FFT over a device mesh.

For grids too large to replicate (1024^2+, multi-host), the physical field
is sharded in y-slabs: each chip holds (C, ny/P, nx). The transform is

    local rfft over x  ->  all_to_all transpose  ->  local fft over y

yielding a spectrum sharded in kr-columns (C, nl, nkr/P); the inverse
reverses the pipeline. It extends the reference's single-GPU cuFFT plans
across cards (SURVEY.md §2.6 item 7: "XLA FFT + distributed slab
transpose"); on GPUs XLA lowers ``lax.all_to_all`` to NCCL.

The odd rfft length (nkr = nx//2 + 1) is zero-padded to a multiple of the
mesh size before the transpose and cropped after.

Two API levels:
- ``local_rfft2`` / ``local_irfft2``: per-shard bodies for use INSIDE a
  ``shard_map`` (the sharded models compose them with local elementwise
  physics, parallel/sharded_rsw.py);
- ``slab_rfft2`` / ``slab_irfft2``: standalone shard_map-wrapped transforms.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.spectral import (_cmul2, _dft1_tables, _dft_precision,
                             _dft_supported, _dft_tables, _mmk)


def _dense1_ok(n: int, dtype) -> bool:
    """Use dense 1-D DFT matmuls for this axis length? Same JRSW_FFT knob
    and <=512 gate as the replicated backend (the per-shard slab transform
    pieces are full-length 1-D transforms; no dealias folding here: the kr
    axis is SHARDED, so kept-mode slicing would unbalance the shards)."""
    return _dft_supported(n, n, dtype)


def _dense_rfft1(x, nx: int):
    """jnp.fft.rfft(x, axis=-1) as two (nkr, nx) matmuls."""
    t = _dft_tables(1, nx)
    prec = _dft_precision()
    return jax.lax.complex(_mmk(x, t["fr"], prec), _mmk(x, t["fi"], prec))


def _dense_irfft1(z, nx: int):
    """jnp.fft.irfft(z, n=nx, axis=-1) (hermitian-weighted) as matmuls."""
    t = _dft_tables(1, nx)
    prec = _dft_precision()
    return (_mmk(jnp.real(z), t["iar"], prec)
            + _mmk(jnp.imag(z), t["iai"], prec))


def _dense_fft1_ax2(z, n: int):
    """jnp.fft.fft(z, axis=-2) (forward c2c, e^{-i}) as matmuls."""
    t = _dft1_tables(n)
    prec = _dft_precision()
    zr, zi = jnp.real(z), jnp.imag(z)
    wr, wi = _cmul2(t["cos"], -t["sin"], t["fks"], zr, zi, prec)
    return jax.lax.complex(wr, wi)


def _dense_ifft1_ax2(z, n: int):
    """jnp.fft.ifft(z, axis=-2) (inverse c2c, e^{+i}/n) as matmuls."""
    t = _dft1_tables(n)
    prec = _dft_precision()
    zr, zi = jnp.real(z), jnp.imag(z)
    yr, yi = _cmul2(t["icos"], t["isin"], t["iks"], zr, zi, prec)
    return jax.lax.complex(yr, yi)

__all__ = ["slab_rfft2", "slab_irfft2", "slab_sharding_physical",
           "slab_sharding_spectral", "local_rfft2", "local_irfft2",
           "padded_nkr"]


def padded_nkr(nx: int, nproc: int) -> int:
    """rfft length nx//2+1 zero-padded up to a multiple of the mesh size."""
    nkr = nx // 2 + 1
    return ((nkr + nproc - 1) // nproc) * nproc


def slab_sharding_physical(mesh: Mesh, axis: str = "packets") -> NamedSharding:
    """(C, ny, nx) sharded in y-slabs."""
    return NamedSharding(mesh, P(None, axis, None))


def slab_sharding_spectral(mesh: Mesh, axis: str = "packets") -> NamedSharding:
    """(C, nl, nkr_pad) sharded in kr-columns."""
    return NamedSharding(mesh, P(None, None, axis))


def _pad_to(x, size, ax):
    pad = size - x.shape[ax]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[ax] = (0, pad)
    return jnp.pad(x, widths)


def local_rfft2(f, nkr_pad: int, axis: str):
    """Per-shard forward transform (call INSIDE shard_map).

    f (..., ny/P, nx) y-slab shard -> (..., nl, nkr_pad/P) kr-column shard.
    """
    nx = f.shape[-1]
    if _dense1_ok(nx, f.dtype):
        fh = _dense_rfft1(f, nx)
    else:
        fh = jnp.fft.rfft(f, axis=-1)
    fh = _pad_to(fh, nkr_pad, -1)
    fh = jax.lax.all_to_all(fh, axis, split_axis=f.ndim - 1,
                            concat_axis=f.ndim - 2, tiled=True)
    nl = fh.shape[-2]
    if _dense1_ok(nl, fh.dtype):
        return _dense_fft1_ax2(fh, nl)
    return jnp.fft.fft(fh, axis=-2)


def local_irfft2(fh, nx: int, axis: str):
    """Per-shard inverse transform (call INSIDE shard_map).

    fh (..., nl, nkr_pad/P) kr-column shard -> (..., ny/P, nx) y-slab shard.
    """
    nkr = nx // 2 + 1
    nl = fh.shape[-2]
    if _dense1_ok(nl, fh.dtype):
        f = _dense_ifft1_ax2(fh, nl)
    else:
        f = jnp.fft.ifft(fh, axis=-2)
    f = jax.lax.all_to_all(f, axis, split_axis=fh.ndim - 2,
                           concat_axis=fh.ndim - 1, tiled=True)
    f = f[..., :nkr]
    if _dense1_ok(nx, f.dtype):
        return _dense_irfft1(f, nx)
    return jnp.fft.irfft(f, n=nx, axis=-1)


def slab_rfft2(field, mesh: Mesh, axis: str = "packets"):
    """field (C, ny, nx) y-slab-sharded -> spectrum (C, nl, nkr_pad)
    kr-column-sharded (zero-padded last axis; crop with [..., :nkr])."""
    nkr_pad = padded_nkr(field.shape[-1], mesh.shape[axis])
    out = jax.shard_map(
        partial(local_rfft2, nkr_pad=nkr_pad, axis=axis), mesh=mesh,
        in_specs=P(None, axis, None),
        out_specs=P(None, None, axis),
    )(field)
    return out


def slab_irfft2(spech, nx: int, mesh: Mesh, axis: str = "packets"):
    """Inverse of slab_rfft2: (C, nl, nkr_pad) kr-sharded ->
    (C, ny, nx) y-slab-sharded."""
    out = jax.shard_map(
        partial(local_irfft2, nx=nx, axis=axis), mesh=mesh,
        in_specs=P(None, None, axis),
        out_specs=P(None, axis, None),
    )(spech)
    return out
