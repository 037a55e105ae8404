"""CI-scale versions of the long-horizon physics anchors
(benchmarks/hw_validation/physics_anchors.py). The
full-scale runs (512^2 x 1000 steps, 128^2 f64 convergence) are recorded in
scripts/hw_validation.md from on-chip executions."""
import numpy as np

from benchmarks.hw_validation import physics_anchors as pa


def test_inviscid_energy_drift_small():
    assert pa.anchor_energy_drift(nx=128, nsteps=300, dt=5e-4)


def test_coupled_self_convergence_small():
    assert pa.anchor_self_convergence(nx=64, T=0.064, dt0=4e-3)
