"""juliaraytracingsw_tpu — JAX framework for WKB wave-packet ray tracing
through rotating-shallow-water / quasi-geostrophic turbulence.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
codebase ndefilippis/JuliaRaytracingSW (Julia + FourierFlows + CUDA.jl):

- ``core``      : spectral grid, FFT wrappers, exponential filters, time steppers
                  (IF-AB3 with per-mode matrix exponentials, ETDRK4, filtered AB3/RK4).
- ``models``    : rotating shallow water (+ Linborg / Modified / QuadHeight variants),
                  one-layer SWQG, two-layer QG, multi-layer QG, Thomas-Yamada.
- ``rays``      : batched WKB ray tracing (dx/dt = u + c_g, dk/dt = -(grad u)^T k)
                  with periodic bilinear/bicubic interpolation and fixed/adaptive RK.
- ``ops``       : fused Pallas (Triton) ray kernels for GPUs.
- ``coupled``   : interleaved PDE-step / ray-substep drivers, diagnostics, outputs.
- ``parallel``  : device meshes, packet sharding, distributed-FFT helpers.
- ``analysis``  : omega-k spectra, exact radial spectra, transfer functions,
                  packet statistics, slope/Matern estimation.
- ``io``        : JLD2 (reference) readers, rolling HDF5 writers, checkpointing.
- ``config``    : typed experiment configurations + sweep tables.

Everything on the compute path is functional: pure ``step(state) -> state``
pytrees under ``jax.jit`` / ``lax.scan``, sharded with ``jax.sharding``.
"""

__version__ = "0.1.0"
