"""Host <-> device transfer helpers that tolerate complex-transfer gaps.

They move real/imag planes separately and combine/split on device, for
runtimes without complex host<->device transfers. The CPU and CUDA
backends transfer complex64 directly (``chip_smoke.py`` phase b checks the
GPU), so there the helpers are equivalent to plain asarray; reducing them
to ``jnp.asarray`` / ``np.asarray`` is ROADMAP 3.4. Complex constants
*captured inside jit* ship inside the executable either way.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["to_device", "to_host"]


@jax.jit
def _combine(re, im):
    return jax.lax.complex(re, im)


def to_device(x, dtype=None):
    """numpy (real or complex) -> device array, avoiding complex transfers."""
    x = np.asarray(x)
    if not np.iscomplexobj(x):
        return jnp.asarray(x, dtype)
    cdtype = np.dtype(dtype) if dtype is not None else (
        np.complex64 if x.dtype != np.complex128 else np.complex128
    )
    rdtype = np.float32 if cdtype == np.complex64 else np.float64
    out = _combine(
        jnp.asarray(np.ascontiguousarray(x.real), rdtype),
        jnp.asarray(np.ascontiguousarray(x.imag), rdtype),
    )
    return out


def to_host(x) -> np.ndarray:
    """device array (real or complex) -> numpy, avoiding complex transfers."""
    if isinstance(x, np.ndarray):
        return x
    if jnp.iscomplexobj(x):
        return np.asarray(jnp.real(x)) + 1j * np.asarray(jnp.imag(x))
    return np.asarray(x)
