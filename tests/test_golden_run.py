"""End-to-end golden smoke run: rsw 128^2 + packets
through spinup, coupled frames, the analyze suite, and the HTML report —
asserting stored summary statistics against recorded golden values.

Goldens were produced by this exact command on the CPU backend (seed 42);
tolerances absorb FFT/XLA version-to-version roundoff, not physics changes.
"""
import os

import h5py
import numpy as np

from juliaraytracingsw_tpu.experiments.__main__ import main

GOLDEN_T = [0.098175, 0.147262, 0.19635, 0.245437, 0.294524]
GOLDEN_KE = [0.014664, 0.014562, 0.014525, 0.014589, 0.014680]
GOLDEN_PE = [0.001134, 0.001261, 0.001353, 0.001359, 0.001318]
GOLDEN_KE_GEO = [0.014317, 0.014178, 0.014113, 0.014129, 0.014181]
GOLDEN_KE_WAVE = [0.000333, 0.000350, 0.000347, 0.000360, 0.000369]


def test_golden_rsw_128_run_and_analysis(tmp_path):
    run = tmp_path / "run"
    main(["rsw", "--nx", "128", "--seed", "42", "--ag", "0.5",
          "--aw", "0.05", "--spinup-T", "0.05", "--T", "0.3",
          "--output-dt", "0.05", "--out-dir", str(run),
          "--sqrt-npackets", "8"])
    main(["analyze", str(run)])

    figs = run / "figures"
    with h5py.File(figs / "plot_data.h5", "r") as f:
        np.testing.assert_allclose(f["t"][()], GOLDEN_T, rtol=1e-5)
        np.testing.assert_allclose(f["e/KE"][()], GOLDEN_KE, rtol=2e-3)
        np.testing.assert_allclose(f["e/PE"][()], GOLDEN_PE, rtol=5e-3)
        np.testing.assert_allclose(f["e/KE_geo"][()], GOLDEN_KE_GEO,
                                   rtol=2e-3)
        np.testing.assert_allclose(f["e/KE_wave"][()], GOLDEN_KE_WAVE,
                                   rtol=5e-3)
    # figures + self-contained HTML page written
    for name in ("energy_series.png", "radial_spectra.png",
                 "flux_integrals.png", "snapshots.png",
                 "packet_frequency_pdfs.png", "run.html"):
        assert (figs / name).exists(), name
    html = (figs / "run.html").read_text()
    assert "Ro" in html and "cdn" not in html.lower()
