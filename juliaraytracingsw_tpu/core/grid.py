"""Doubly-periodic 2-D spectral grid.

Layout conventions (deliberately different from the reference's
FourierFlows ``(nx, ny)``/x-first layout, see /root/reference
rsw/RotatingShallowWater.jl:52-53):

- physical fields have shape ``(..., ny, nx)`` indexed ``[y, x]`` so the fast
  (lane) axis is x and real-to-complex FFTs run over the last two axes;
- spectral fields have shape ``(..., nl, nkr)`` with ``nkr = nx//2 + 1``
  non-negative x-wavenumbers on the last axis and full-order y-wavenumbers
  ``l`` on the second-to-last axis;
- multi-component state is channel-leading ``(C, nl, nkr)`` so the trailing
  two axes stay large and tile onto (8,128) vector registers, and one batched
  FFT covers all components.

The FFT normalisation matches FFTW/FourierFlows: forward unnormalised,
inverse carries 1/(nx*ny) (this is also numpy's default), so spectral
amplitudes are directly comparable with reference JLD2 snapshots.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Grid", "make_grid"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "x", "y", "kr", "l", "Krsq", "invKrsq", "dealias_mask",
    ],
    meta_fields=["nx", "ny", "Lx", "Ly", "aliased_fraction"],
)
@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of a doubly-periodic rectangular grid.

    Mirrors the role of FourierFlows ``TwoDGrid`` (reference
    rsw/RotatingShallowWater.jl:87) but in [y, x] layout.
    """

    nx: int
    ny: int
    Lx: float
    Ly: float
    aliased_fraction: float
    x: jax.Array        # (nx,) cell-centered coords starting at -Lx/2
    y: jax.Array        # (ny,)
    kr: jax.Array       # (nkr,) non-negative x wavenumbers, 2*pi/Lx * [0..nx/2]
    l: jax.Array        # (nl,)  y wavenumbers in FFT order
    Krsq: jax.Array     # (nl, nkr) = kr^2 + l^2
    invKrsq: jax.Array  # (nl, nkr), zero at the (0,0) mode
    dealias_mask: jax.Array  # (nl, nkr) float mask, 1 keep / 0 zero

    # --- static derived sizes -------------------------------------------------
    @property
    def nkr(self) -> int:
        return self.nx // 2 + 1

    @property
    def nl(self) -> int:
        return self.ny

    @property
    def dx(self) -> float:
        return self.Lx / self.nx

    @property
    def dy(self) -> float:
        return self.Ly / self.ny

    @property
    def spectral_shape(self) -> tuple[int, int]:
        return (self.nl, self.nkr)

    @property
    def physical_shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    # --- spectral helpers ----------------------------------------------------
    def dealias(self, solh: jax.Array) -> jax.Array:
        """Zero the aliased (highest) wavenumbers; 2/3-rule for af=1/3.

        Square (per-axis) truncation like FourierFlows ``dealias!``.
        """
        return solh * self.dealias_mask

    # spectral derivative factors. Built with lax.complex instead of 1j*
    # multiplication so they also work EAGERLY on runtimes where complex
    # host->device constant transfers are unimplemented (core/transfer.py).
    @property
    def ik(self) -> jax.Array:
        """i*kr broadcast over (nl, nkr)."""
        return jax.lax.complex(jnp.zeros_like(self.kr), self.kr)[None, :]

    @property
    def il(self) -> jax.Array:
        return jax.lax.complex(jnp.zeros_like(self.l), self.l)[:, None]


def _wavenumbers(n: int, L: float) -> np.ndarray:
    return 2.0 * np.pi / L * np.fft.fftfreq(n, d=1.0 / n)


def make_grid(
    nx: int,
    Lx: float = 2.0 * np.pi,
    ny: int | None = None,
    Ly: float | None = None,
    aliased_fraction: float = 1.0 / 3.0,
    dtype=jnp.float32,
) -> Grid:
    """Build a Grid. ``dtype`` is the real dtype of physical fields."""
    ny = nx if ny is None else ny
    Ly = Lx if Ly is None else Ly
    nkr = nx // 2 + 1

    dx, dy = Lx / nx, Ly / ny
    x = np.arange(nx) * dx - Lx / 2.0
    y = np.arange(ny) * dy - Ly / 2.0

    kr = 2.0 * np.pi / Lx * np.arange(nkr)
    ell = _wavenumbers(ny, Ly)

    Krsq = ell[:, None] ** 2 + kr[None, :] ** 2
    with np.errstate(divide="ignore"):
        invKrsq = np.where(Krsq > 0, 1.0 / np.where(Krsq > 0, Krsq, 1.0), 0.0)

    # per-axis square dealias mask: keep |k_index| <= (1 - af) * n/2
    if aliased_fraction and aliased_fraction > 0:
        kcut_x = (1.0 - aliased_fraction) * (nx // 2)
        kcut_y = (1.0 - aliased_fraction) * (ny // 2)
        ix = np.arange(nkr)  # index == |k index| for rfft axis
        iy = np.abs(np.fft.fftfreq(ny, d=1.0 / ny))
        mask = ((ix[None, :] <= kcut_x) & (iy[:, None] <= kcut_y)).astype(
            np.float32
        )
    else:
        mask = np.ones((ny, nkr), np.float32)

    return Grid(
        nx=nx,
        ny=ny,
        Lx=float(Lx),
        Ly=float(Ly),
        aliased_fraction=float(aliased_fraction),
        x=jnp.asarray(x, dtype),
        y=jnp.asarray(y, dtype),
        kr=jnp.asarray(kr, dtype),
        l=jnp.asarray(ell, dtype),
        Krsq=jnp.asarray(Krsq, dtype),
        invKrsq=jnp.asarray(invKrsq, dtype),
        dealias_mask=jnp.asarray(mask, dtype),
    )
