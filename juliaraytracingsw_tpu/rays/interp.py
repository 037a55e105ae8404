"""Periodic field interpolation at scattered packet positions.

Interpolation is an explicit gather + weighted sum (the reference binds 10
CUDA textures per ray step, raytracing/GPURaytracing.jl:115-134), batched over a leading field axis so one XLA gather serves
all fields (u, v, ux, uy, vx, ...) at once:

- ``bilinear``  : 4-point stencil — the accuracy class of the reference's
                  GPU texture path (but in full f32; CUDA textures use 9-bit
                  fixed-point weights).
- ``bspline``   : periodic cubic B-spline, 16-point stencil. The prefilter
                  (B-spline coefficient solve) is DIAGONAL in Fourier space
                  for periodic uniform grids, so spectral models get exact
                  C2 B-spline interpolation for one elementwise multiply —
                  the equivalent of the reference CPU path
                  (Interpolations.jl ``BSpline(Cubic(Periodic))``,
                  raytracing/Raytracing.jl:152-159).
- ``bicubic_hermite`` : f/fx/fy/fxy corner-data bicubic from the reference's
                  utils/CUDAInterpolations.jl:71-108 — used when exact
                  spectral derivative fields are available.

All functions take field stacks ``(F, ny, nx)`` and query points ``(N,)``,
returning ``(F, N)``. Everything is differentiable (gathers have
scatter-add transposes); custom Pallas kernels live in ops/.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "bilinear",
    "bspline_prefilter",
    "bspline",
    "bicubic_hermite",
    "interpolate",
]


def _frac_index(q, origin, d, n):
    """Continuous index into a periodic axis: integer cell + fraction."""
    fi = (q - origin) / d
    i0 = jnp.floor(fi)
    alpha = fi - i0
    return i0.astype(jnp.int32), alpha


def _wrap(i, n):
    return jnp.remainder(i, n)


def _gather(fields, iy, ix):
    """fields (F, ny, nx); iy/ix (N,) wrapped indices -> (F, N)."""
    F, ny, nx = fields.shape
    flat = fields.reshape(F, ny * nx)
    idx = iy * nx + ix
    return jnp.take(flat, idx, axis=1)


def _gather_taps(fields, tap_flat_idx):
    """ONE fused flat gather for all fields x taps.

    fields (F, ny, nx); tap_flat_idx (T, N) flattened yx indices ->
    (F, T, N). PERFORMANCE-CRITICAL: a single 1-D ``jnp.take`` over the
    fully-flattened field lowers to one dynamic gather; per-tap
    ``take(..., axis=1)`` calls lower to many small gathers.
    """
    F, ny, nx = fields.shape
    T, N = tap_flat_idx.shape
    flat = fields.reshape(F * ny * nx)
    offs = (jnp.arange(F, dtype=tap_flat_idx.dtype) * (ny * nx))[:, None, None]
    idx = (tap_flat_idx[None] + offs).reshape(-1)
    return jnp.take(flat, idx).reshape(F, T, N)


def bilinear(fields, xq, yq, x0, y0, dx, dy):
    """Periodic bilinear interpolation; fields (F, ny, nx) -> (F, N)."""
    _, ny, nx = fields.shape
    ix0, ax = _frac_index(xq, x0, dx, nx)
    iy0, ay = _frac_index(yq, y0, dy, ny)
    ix0, ix1 = _wrap(ix0, nx), _wrap(ix0 + 1, nx)
    iy0w, iy1 = _wrap(iy0, ny), _wrap(iy0 + 1, ny)
    taps = jnp.stack([
        iy0w * nx + ix0, iy0w * nx + ix1, iy1 * nx + ix0, iy1 * nx + ix1,
    ])
    g = _gather_taps(fields, taps)          # (F, 4, N)
    b = g[:, 0] + ax * (g[:, 1] - g[:, 0])
    t = g[:, 2] + ax * (g[:, 3] - g[:, 2])
    return b + ay * (t - b)


# --- periodic cubic B-spline -------------------------------------------------

def bspline_prefilter_mask(grid):
    """(nl, nkr) spectral prefilter turning samples into B-spline coefficients.

    The cubic B-spline sampled on the grid has DFT b(theta) =
    (4 + 2 cos(theta))/6 per axis; dividing the field spectrum by
    b(kx dx) b(ky dy) yields interpolating-spline coefficients exactly
    (periodic uniform case).
    """
    tx = np.asarray(grid.kr) * grid.dx
    ty = np.asarray(grid.l) * grid.dy
    bx = (4.0 + 2.0 * np.cos(tx)) / 6.0
    by = (4.0 + 2.0 * np.cos(ty)) / 6.0
    return jnp.asarray(1.0 / (by[:, None] * bx[None, :]), jnp.float32)


def bspline_prefilter(fieldsh, grid):
    """Apply the spectral prefilter to spectral fields (before irfft2)."""
    return fieldsh * bspline_prefilter_mask(grid)


def _bspline_w(a):
    """Cubic B-spline weights for the 4 taps at offsets (-1, 0, 1, 2)."""
    a2, a3 = a * a, a * a * a
    w0 = (1.0 - 3.0 * a + 3.0 * a2 - a3) / 6.0
    w1 = (4.0 - 6.0 * a2 + 3.0 * a3) / 6.0
    w2 = (1.0 + 3.0 * a + 3.0 * a2 - 3.0 * a3) / 6.0
    w3 = a3 / 6.0
    return w0, w1, w2, w3


def bspline(coeff_fields, xq, yq, x0, y0, dx, dy):
    """Periodic cubic B-spline evaluation on prefiltered coefficient fields.

    ``coeff_fields`` must be physical-space irfft2 of prefiltered spectra
    (see ``bspline_prefilter``), shape (F, ny, nx). All 16 taps gathered in
    ONE fused flat take (see ``_gather_taps``).
    """
    _, ny, nx = coeff_fields.shape
    ix0, ax = _frac_index(xq, x0, dx, nx)
    iy0, ay = _frac_index(yq, y0, dy, ny)
    wx = _bspline_w(ax)   # 4 x (N,)
    wy = _bspline_w(ay)
    taps = []
    for jy in range(4):
        iy = _wrap(iy0 + (jy - 1), ny)
        for jx in range(4):
            ix = _wrap(ix0 + (jx - 1), nx)
            taps.append(iy * nx + ix)
    g = _gather_taps(coeff_fields, jnp.stack(taps))   # (F, 16, N)
    out = None
    for jy in range(4):
        row = None
        for jx in range(4):
            term = g[:, jy * 4 + jx] * wx[jx]
            row = term if row is None else row + term
        term = row * wy[jy]
        out = term if out is None else out + term
    return out


# --- Hermite bicubic (CUDAInterpolations formulas) ---------------------------

def _cubic_hermite(a, f0, f1, m0, m1):
    """utils/CUDAInterpolations.jl:39-44 Hermite cubic on [0,1]."""
    a2 = a * a
    a3 = a2 * a
    return (
        f0
        + m0 * a
        + (-3.0 * f0 + 3.0 * f1 - 2.0 * m0 - m1) * a2
        + (2.0 * f0 - 2.0 * f1 + m0 + m1) * a3
    )


def bicubic_hermite(f, fx, fy, fxy, xq, yq, x0, y0, dx, dy):
    """Bicubic with exact corner derivatives (utils/CUDAInterpolations.jl:71-108).

    All four field stacks have shape (F, ny, nx); derivatives are in physical
    units (they are scaled by dx/dy internally).
    """
    F, ny, nx = f.shape
    ix0, ax = _frac_index(xq, x0, dx, nx)
    iy0, ay = _frac_index(yq, y0, dy, ny)
    ix0w, ix1 = _wrap(ix0, nx), _wrap(ix0 + 1, nx)
    iy0w, iy1 = _wrap(iy0, ny), _wrap(iy0 + 1, ny)

    taps = jnp.stack([
        iy0w * nx + ix0w, iy0w * nx + ix1, iy1 * nx + ix0w, iy1 * nx + ix1,
    ])
    stacked = jnp.concatenate([f, fx, fy, fxy])       # (4F, ny, nx)
    g = _gather_taps(stacked, taps)                   # (4F, 4, N)

    def corners(block, scale):
        c = g[block * F:(block + 1) * F] * scale
        return c[:, 0], c[:, 1], c[:, 2], c[:, 3]

    f00, f10, f01, f11 = corners(0, 1.0)
    fx00, fx10, fx01, fx11 = corners(1, dx)
    fy00, fy10, fy01, fy11 = corners(2, dy)
    fxy00, fxy10, fxy01, fxy11 = corners(3, dx * dy)

    b0 = _cubic_hermite(ax, f00, f10, fx00, fx10)
    b1 = _cubic_hermite(ax, f01, f11, fx01, fx11)
    d0 = _cubic_hermite(ax, fy00, fy10, fxy00, fxy10)
    d1 = _cubic_hermite(ax, fy01, fy11, fxy01, fxy11)
    return _cubic_hermite(ay, b0, b1, d0, d1)


def interpolate(fields, xq, yq, x0, y0, dx, dy, method: str = "bilinear"):
    """Dispatch on method. For ``'bicubic'`` (Hermite, exact corner
    derivatives) ``fields`` must be the stacked (4F, ny, nx) layout
    [f | fx | fy | fxy] produced by raytrace.fields_from_psih(...,
    interp='bicubic'); the result has F rows."""
    if method == "bilinear":
        return bilinear(fields, xq, yq, x0, y0, dx, dy)
    if method == "bspline":
        return bspline(fields, xq, yq, x0, y0, dx, dy)
    if method == "bicubic":
        F4 = fields.shape[0]
        if F4 % 4:
            raise ValueError(
                "bicubic expects a stacked (4F, ny, nx) [f|fx|fy|fxy] layout"
            )
        F = F4 // 4
        return bicubic_hermite(
            fields[:F], fields[F:2 * F], fields[2 * F:3 * F], fields[3 * F:],
            xq, yq, x0, y0, dx, dy,
        )
    raise ValueError(f"unknown interpolation method {method!r}")
