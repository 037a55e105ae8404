"""Type-2 NUFFT: evaluate spectral fields at scattered points.

Equivalent of the reference's NUFFT interpolation path
(raytracing/NUFFTRaytracing.jl uses nufft2d2 of psi-derived spectra at
packet positions). The spectrally-exact evaluation is a dense
contraction over retained modes — matrix work rather than a
spreading/gridding kernel:

    f(x_j) = sum_{k,l} fh[l,k] e^{i(k x_j + l y_j)}  (conjugate-even in k)

Factored as two stages through the separable phase,
    g[l, j] = sum_k w_k fh[l, k] e^{i k x_j}      (nl x nkr) @ (nkr x N)
    f[j]    = sum_l g[l, j] e^{i l y_j}           contraction over nl
so cost is O(nl*nkr*N + nl*N) — two complex matmuls instead of
O(nl*nkr*N) scattered exponentials.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["nufft2d2"]


def nufft2d2(fh, xq, yq, grid):
    """Evaluate rfft2-layout spectra at scattered points, exactly.

    fh: (..., nl, nkr) spectrum with FFT normalisation (unnormalised
    forward); xq/yq: (N,) physical coordinates. Returns (..., N) real.
    """
    kr = grid.kr            # (nkr,)
    ell = grid.l            # (nl,)
    # conjugate-even doubling: kr>0 columns represent +/- pairs
    w = jnp.ones((grid.nkr,), fh.dtype).at[1:].set(2.0)
    if grid.nx % 2 == 0:
        w = w.at[-1].set(1.0)

    # rfft2 coefficients carry DFT index phases: evaluate relative to the
    # first grid node (x0, y0)
    phase_x = jnp.exp(1j * jnp.outer(kr, xq - grid.x[0]))    # (nkr, N)
    phase_y = jnp.exp(1j * jnp.outer(ell, yq - grid.y[0]))   # (nl, N)

    # precision=HIGHEST: at default precision a GPU may run these matmuls
    # in TF32 — unacceptable for the exact-NUFFT claim
    g = jnp.einsum("...lk,kn->...ln", fh * w, phase_x.astype(fh.dtype),
                   precision=jax.lax.Precision.HIGHEST)
    f = jnp.einsum("...ln,ln->...n", g, phase_y.astype(fh.dtype),
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.real(f) / (grid.nx * grid.ny)
