"""Patch-gather ray interpolation: the fast ray path.

The reference's CUDA texture path (raytracing/GPURaytracing.jl:115-134)
does ~10 texture fetches per packet per RHS eval; a literal translation
(one gather per tap per field) costs 20 scattered indices per packet per
stage. The patch formulation inverts the layout:

  1. Once per ray substep, build a *packed patch table* ``T`` of shape
     ``(ny*nx, F*ph*pw)`` where row ``c`` holds the full ``ph x pw``
     neighborhood of cell ``c`` for all F fields (built with jnp.roll —
     pure streaming traffic, no gathers).
  2. ONE ``jnp.take`` per packet fetches the whole neighborhood of both
     time levels (the (old|new) pair table, one index per packet).
  3. Every integrator stage then interpolates *locally* from the gathered
     patch with elementwise arithmetic only — zero further gathers.
     Patches are blended linearly in time per stage (blend commutes with
     gather).

Validity: a patch centered on the packet's cell at gather time covers local
fractional offsets in [-(lo), pw-lo-1); stages stay valid while the packet
moves less than ``lo`` cells within one substep (CFL gives ~0.1 cells for
production configs — 10x margin for the default 4x4 bilinear patch).
Offsets are clamped to the valid patch range as a safety net (matches the
reference's texture clamp semantics under extreme velocities).

Accuracy classes (same formulas as rays/interp.py):
  - 'bilinear': 4x4 patch (taps -1..2), local bilinear.
  - 'bspline' : 6x6 patch of B-spline *coefficients* (spectrally
    prefiltered, see interp.bspline_prefilter), local cubic B-spline —
    exact C2 interpolation matching the reference CPU path
    (raytracing/Raytracing.jl:152-159).
  - 'bicubic' : 4x4 patch over the stacked [f|fx|fy|fxy] corner-data
    layout (4*F channels, fields_from_psih(..., interp='bicubic')) with
    per-block Hermite value/derivative weights — the reference's
    accuracy-premium blueprint (utils/CUDAInterpolations.jl:71-108) at
    patch-path speed. Derivative channels are stored in physical units, so
    evaluation needs the (dx, dy) cell sizes (``deriv_scale``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "PATCH_SHAPES",
    "build_patch_table",
    "build_pair_table_direct",
    "patch_interpolate",
    "patch_interpolate_pair",
    "patch_interpolate_pair_shared",
]

# interp method -> (patch height, patch width, lo offset of tap grid)
# Window sizes cover local offsets in [-1, 2) EXACTLY (taps floor-1..floor+2
# for the cubic, floor..floor+1 for bilinear/bicubic corner pairs), i.e.
# packets may drift a full cell within one substep before the clamped
# polynomial extension kicks in.
PATCH_SHAPES = {
    "bilinear": (4, 4, 1),
    "bspline": (6, 6, 2),
    "bicubic": (4, 4, 1),
}


def build_patch_table(fields, method: str = "bilinear"):
    """(F, ny, nx) -> (ny*nx, F*ph*pw) packed per-cell neighborhoods.

    Row c = cell (iy, ix) holds fields[f, iy + dy - lo, ix + dx - lo]
    (periodic) for all f, dy in [0, ph), dx in [0, pw). Built with
    jnp.roll — streaming HBM traffic only, ~F*ph*pw MB at 512^2.
    """
    ph, pw, lo = PATCH_SHAPES[method]
    F, ny, nx = fields.shape
    shifted = []
    for dy in range(ph):
        for dx in range(pw):
            # fields[f, y + dy - lo, x + dx - lo] = roll by -(dy-lo), -(dx-lo)
            shifted.append(
                jnp.roll(fields, shift=(lo - dy, lo - dx), axis=(1, 2))
            )
    # (ph*pw, F, ny, nx) -> (ny, nx, F, ph*pw) -> (ny*nx, F*ph*pw)
    T = jnp.stack(shifted)
    T = T.transpose(2, 3, 1, 0)
    return T.reshape(ny * nx, F * ph * pw)


def build_pair_table_direct(fields_old, fields_new, method: str = "bilinear",
                            dtype: str = "float32"):
    """ONE-op (old|new) pair-table build via patch-extraction convolution.

    Replaces build_patch_table(old) + build_patch_table(new) + the 2W-wide
    concat with a single ``conv_general_dilated_patches`` over the stacked
    2F channels: the roll/stack/transpose build pays a full minor-dim
    relayout of the table plus a second full copy in the concat, while the
    patch conv emits the (ny, nx, 2F*ph*pw) layout directly.

    Column layout is identical to
    ``make_pair_table(build_patch_table(old), build_patch_table(new))``
    (channel-major (c, dy, dx) patch ordering — pinned by tests; bit-exact
    on CPU). For bf16 tables the cast happens BEFORE the build so the
    conv streams half the bytes.
    """
    ph, pw, lo = PATCH_SHAPES[method]
    F, ny, nx = fields_old.shape
    X = jnp.concatenate([fields_old, fields_new]).astype(jnp.dtype(dtype))
    Xp = jnp.pad(X, ((0, 0), (lo, ph - 1 - lo), (lo, pw - 1 - lo)),
                 mode="wrap")[None]
    # full precision: the patch-extraction conv has a 0/1 kernel, but a
    # reduced-precision default (TF32 on GPUs) would silently round f32
    # tables
    P = jax.lax.conv_general_dilated_patches(
        Xp, (ph, pw), (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    return P.reshape(ny * nx, 2 * F * ph * pw)


def _axis_weights_bilinear(local, size, lo):
    """(N,) local continuous offsets -> (N, size) bilinear tap weights.

    local is the offset from the patch's base cell; tap j sits at j - lo.
    """
    j0 = jnp.clip(jnp.floor(local), -lo, size - lo - 2)
    a = local - j0
    taps = j0 + lo                                 # base tap slot in [0, size-2]
    iota = jax.lax.broadcasted_iota(jnp.int32, (local.shape[0], size), 1)
    t = taps[:, None].astype(jnp.int32)
    w = jnp.where(iota == t, 1.0 - a[:, None], 0.0)
    return w + jnp.where(iota == t + 1, a[:, None], 0.0)


def _bspline_w4(a):
    a2, a3 = a * a, a * a * a
    return (
        (1.0 - 3.0 * a + 3.0 * a2 - a3) / 6.0,
        (4.0 - 6.0 * a2 + 3.0 * a3) / 6.0,
        (1.0 + 3.0 * a + 3.0 * a2 - 3.0 * a3) / 6.0,
        a3 / 6.0,
    )


def _axis_weights_bspline(local, size, lo):
    """Cubic B-spline weights over 4 taps at floor(local)-1 .. floor(local)+2,
    expressed over the full patch axis of length ``size``.

    j0 is clipped so the highest tap slot j0+lo+2 stays <= size-1; outside
    the covered range the local cubic piece extends polynomially — a
    continuous (and differentiable) safety net for packets that drift more
    than the patch margin within one substep (error O(drift^3), CFL-guarded).
    """
    j0 = jnp.clip(jnp.floor(local), -(lo - 1), size - lo - 3)
    a = local - j0
    ws = _bspline_w4(a)                            # 4 x (N,)
    base = (j0 + lo - 1)[:, None].astype(jnp.int32)  # first tap slot
    iota = jax.lax.broadcasted_iota(jnp.int32, (local.shape[0], size), 1)
    w = jnp.zeros((local.shape[0], size), local.dtype)
    for j, wj in enumerate(ws):
        w = w + jnp.where(iota == base + j, wj[:, None], 0.0)
    return w


def _axis_weights_hermite(local, size, lo, scale):
    """Hermite cubic weights over the 2 nodes of the containing cell,
    expressed over the full patch axis: returns ``(wv, wd)`` where ``wv``
    carries the value-basis (h00, h01) and ``wd`` the derivative-basis
    (h10, h11) scaled by the physical cell size (stored derivative channels
    are in physical units, interp.bicubic_hermite convention)."""
    j0 = jnp.clip(jnp.floor(local), -lo, size - lo - 2)
    a = local - j0
    a2, a3 = a * a, a * a * a
    h00, h01 = 1.0 - 3.0 * a2 + 2.0 * a3, 3.0 * a2 - 2.0 * a3
    h10, h11 = (a - 2.0 * a2 + a3) * scale, (a3 - a2) * scale
    t = (j0 + lo)[:, None].astype(jnp.int32)
    iota = jax.lax.broadcasted_iota(jnp.int32, (local.shape[0], size), 1)
    wv = (jnp.where(iota == t, h00[:, None], 0.0)
          + jnp.where(iota == t + 1, h01[:, None], 0.0))
    wd = (jnp.where(iota == t, h10[:, None], 0.0)
          + jnp.where(iota == t + 1, h11[:, None], 0.0))
    return wv, wd


def _hermite_block_weights(local_x, local_y, deriv_scale):
    """The 4 separable (wy, wx) weight pairs for the [f, fx, fy, fxy]
    channel blocks of the bicubic corner-data layout."""
    ph, pw, lo = PATCH_SHAPES["bicubic"]
    sx, sy = deriv_scale
    wxv, wxd = _axis_weights_hermite(local_x, pw, lo, sx)
    wyv, wyd = _axis_weights_hermite(local_y, ph, lo, sy)
    return ((wyv, wxv), (wyv, wxd), (wyd, wxv), (wyd, wxd))


def _weight_matrix(local_x, local_y, method: str):
    """(N, ph*pw) separable tap-weight matrix w2[n, jy*pw+jx]."""
    ph, pw, lo = PATCH_SHAPES[method]
    if method == "bilinear":
        wx = _axis_weights_bilinear(local_x, pw, lo)
        wy = _axis_weights_bilinear(local_y, ph, lo)
    elif method == "bspline":
        wx = _axis_weights_bspline(local_x, pw, lo)
        wy = _axis_weights_bspline(local_y, ph, lo)
    else:
        raise ValueError(f"unknown patch interp {method!r}")
    return (wy[:, :, None] * wx[:, None, :]).reshape(local_x.shape[0],
                                                     ph * pw)


def _selector(ph: int, pw: int, F: int, dtype, nblocks: int = 1):
    """(F*ph*pw, F//nblocks) 0/1 matrix summing each field's tap block.

    With ``nblocks>1`` (bicubic corner-data layout) channel c = b*Fb + j of
    block b contributes to output field j, folding the [f|fx|fy|fxy] block
    sum into the same matmul as the tap reduction."""
    import numpy as np

    pp = ph * pw
    Fb = F // nblocks
    M = np.zeros((F * pp, Fb), np.float32)
    for c in range(F):
        M[c * pp:(c + 1) * pp, c % Fb] = 1.0
    return jnp.asarray(M, dtype)


@partial(jax.jit, static_argnames=("method", "deriv_scale"))
def patch_interpolate_pair(rows_pair, local_x, local_y, a,
                           method: str = "bilinear", deriv_scale=(1.0, 1.0)):
    """Time-blended evaluation of all F fields from gathered PAIR rows.

    rows_pair : (N, 2*F*ph*pw) rows from a make_pair_table gather
    a         : scalar blend (0 -> old snapshot, 1 -> new)
    returns   : (F, N)  (F//4 rows for the bicubic corner-data layout)

    Matmul formulation: one full-width elementwise multiply by the tiled
    separable weights, then a (N, 2W) x (2W, F) matmul whose selector
    matrix folds BOTH the per-field tap reduction and the time blend, so
    the gathered rows are read exactly once."""
    ph, pw, lo = PATCH_SHAPES[method]
    pp = ph * pw
    N, W2 = rows_pair.shape
    F = W2 // (2 * pp)
    W = F * pp
    if method == "bicubic":
        Fb = F // 4
        blocks = _hermite_block_weights(local_x, local_y, deriv_scale)
        w4 = jnp.stack(
            [(wy[:, :, None] * wx[:, None, :]).reshape(N, pp)
             for wy, wx in blocks], axis=1)                # (N, 4, pp)
        w_t = jnp.broadcast_to(w4[:, :, None, :],
                               (N, 4, Fb, pp)).reshape(N, W)
        M = _selector(ph, pw, F, rows_pair.dtype, nblocks=4)   # (W, Fb)
    else:
        w2 = _weight_matrix(local_x, local_y, method)          # (N, pp)
        w_t = jnp.broadcast_to(w2[:, None, :], (N, F, pp)).reshape(N, W)
        M = _selector(ph, pw, F, rows_pair.dtype)              # (W, F)
    w_t2 = jnp.concatenate([w_t, w_t], axis=1)             # (N, 2W)
    Mb = jnp.concatenate([(1.0 - a) * M, a * M], axis=0)   # (2W, F)
    # full-precision matmul: a reduced-precision default (TF32 on GPUs)
    # would silently round the interpolated fields
    return jnp.dot(rows_pair * w_t2, Mb,
                   precision=jax.lax.Precision.HIGHEST).T  # (F, N)


@partial(jax.jit, static_argnames=("method", "deriv_scale"))
def patch_interpolate_pair_shared(rows_pair, local_x, local_y, a,
                                  method: str = "bilinear",
                                  deriv_scale=(1.0, 1.0)):
    """Time-blended evaluation reading the PAIR rows in one pass with the
    separable weights built ONCE (JRSW_PATCH_IMPL=pairsplit): the split
    formulation evaluates old/new levels via two patch_interpolate calls,
    constructing identical weight matrices twice; here the (N, 2, F, ph, pw)
    view shares them and the final time blend contracts the level axis.

    rows_pair : (N, 2*F*ph*pw); returns (F, N) (F//4 rows for bicubic)."""
    ph, pw, lo = PATCH_SHAPES[method]
    N = rows_pair.shape[0]
    F = rows_pair.shape[1] // (2 * ph * pw)
    P = rows_pair.reshape(N, 2, F, ph, pw)
    if method == "bicubic":
        Fb = F // 4
        Pb = P.reshape(N, 2, 4, Fb, ph, pw)
        out = None
        for b, (wy, wx) in enumerate(
                _hermite_block_weights(local_x, local_y, deriv_scale)):
            v = jnp.sum(Pb[:, :, b] * wx[:, None, None, None, :], axis=4)
            v = jnp.sum(v * wy[:, None, None, :], axis=3)    # (N, 2, Fb)
            out = v if out is None else out + v
    else:
        if method == "bilinear":
            wx = _axis_weights_bilinear(local_x, pw, lo)
            wy = _axis_weights_bilinear(local_y, ph, lo)
        elif method == "bspline":
            wx = _axis_weights_bspline(local_x, pw, lo)
            wy = _axis_weights_bspline(local_y, ph, lo)
        else:
            raise ValueError(f"unknown patch interp {method!r}")
        out = jnp.sum(P * wx[:, None, None, None, :], axis=4)
        out = jnp.sum(out * wy[:, None, None, :], axis=3)    # (N, 2, F)
    v = (1.0 - a) * out[:, 0] + a * out[:, 1]
    return v.T                                               # (F, N)


@partial(jax.jit, static_argnames=("method", "deriv_scale"))
def patch_interpolate(patches, local_x, local_y, method: str = "bilinear",
                      deriv_scale=(1.0, 1.0)):
    """Evaluate all F fields from packed patches at local offsets.

    patches  : (N, F*ph*pw) rows gathered from build_patch_table
    local_x/y: (N,) continuous offsets from each packet's patch base cell
    returns  : (F, N)

    ``method='bicubic'`` treats the channel axis as 4 blocks [f|fx|fy|fxy]
    of F//4 base fields each and needs ``deriv_scale=(dx, dy)`` to convert
    the physical-unit derivative channels to cell units.
    """
    ph, pw, lo = PATCH_SHAPES[method]
    N = patches.shape[0]
    F = patches.shape[1] // (ph * pw)
    P = patches.reshape(N, F, ph, pw)
    if method == "bicubic":
        Fb = F // 4
        Pb = P.reshape(N, 4, Fb, ph, pw)
        out = None
        for b, (wy, wx) in enumerate(
                _hermite_block_weights(local_x, local_y, deriv_scale)):
            v = jnp.sum(Pb[:, b] * wx[:, None, None, :], axis=3)
            v = jnp.sum(v * wy[:, None, :], axis=2)
            out = v if out is None else out + v
        return out.T                                # (Fb, N)
    if method == "bilinear":
        wx = _axis_weights_bilinear(local_x, pw, lo)
        wy = _axis_weights_bilinear(local_y, ph, lo)
    elif method == "bspline":
        wx = _axis_weights_bspline(local_x, pw, lo)
        wy = _axis_weights_bspline(local_y, ph, lo)
    else:
        raise ValueError(f"unknown patch interp {method!r}")
    # contract x then y elementwise: (N,F,ph,pw)*(N,1,1,pw) -> (N,F,ph)
    v = jnp.sum(P * wx[:, None, None, :], axis=3)
    v = jnp.sum(v * wy[:, None, :], axis=2)
    return v.T                                      # (F, N)
