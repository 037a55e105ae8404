"""JLD2 reader fixture test: hand-write an HDF5 file
with the JLD2 on-disk layout — complex (re, im) compound dtype, Julia
column-major array order — and check the reader round-trips it and that
cmd_steady_raytracing runs on it."""
import os

import numpy as np
import h5py
import pytest

from juliaraytracingsw_tpu.io.jld2 import (
    list_keys,
    load_array,
    load_scalar,
    to_spectral_layout,
)


def _write_jld2_like(path, julia_spec, t=3.5):
    """Emulate JLD2's HDF5 layout: complex compound dtype ("re","im") and
    Julia column-major order. JLD2 writes the raw column-major buffer with
    REVERSED dims, so a Julia (nkr, nl) array shows up to h5py as (nl, nkr)."""
    comp = np.dtype([("re", "<f4"), ("im", "<f4")])
    # julia_spec is conceptually Julia (nkr, nl); its h5py appearance is the
    # transpose, which is what we store here (row-major write of the same
    # memory).
    as_seen = julia_spec.T
    rec = np.empty(as_seen.shape, comp)
    rec["re"] = as_seen.real
    rec["im"] = as_seen.imag
    with h5py.File(path, "w") as f:
        f["snapshots/sol/0"] = rec
        f["snapshots/t/0"] = np.float64(t)
        f["grid/nx"] = np.int64((julia_spec.shape[0] - 1) * 2)
        f["grid/Lx"] = np.float64(2 * np.pi)


class TestJLD2Reader:
    def test_complex_compound_roundtrip(self, tmp_path, rng):
        nx = 16
        nkr, nl = nx // 2 + 1, nx
        julia = (rng.standard_normal((nkr, nl))
                 + 1j * rng.standard_normal((nkr, nl))).astype(np.complex64)
        p = str(tmp_path / "ref.jld2")
        _write_jld2_like(p, julia)

        arr = load_array(p, "snapshots/sol/0")
        assert np.iscomplexobj(arr)
        # h5py row-major read of Julia column-major = transposed dims:
        # (nl, nkr) = our spectral layout
        assert arr.shape == (nl, nkr)
        np.testing.assert_allclose(to_spectral_layout(arr), julia.T)

        assert load_scalar(p, "snapshots/t/0") == 3.5
        keys = list_keys(p)
        assert "snapshots/sol/0" in keys and "grid/nx" in keys

    def test_steady_raytracing_runs_on_fixture(self, tmp_path, rng):
        """cmd_steady_raytracing --snapshot-file on a JLD2-layout psih."""
        from juliaraytracingsw_tpu.core.grid import make_grid
        from juliaraytracingsw_tpu.experiments.__main__ import main

        nx = 32
        g = make_grid(nx)
        # band-limited streamfunction, stored Julia-style (nkr, nl)
        K = np.sqrt(np.asarray(g.Krsq))
        mask = (K >= 2) & (K <= 5)
        psih = (mask * np.exp(1j * rng.uniform(0, 2 * np.pi, K.shape))
                ).astype(np.complex64) * 0.05
        p = str(tmp_path / "snap.jld2")
        _write_jld2_like(p, psih.T)   # our (nl,nkr) -> Julia (nkr,nl)

        main(["steady-raytracing", "--nx", str(nx), "--T", "0.05",
              "--output-dt", "0.01", "--out-dir", str(tmp_path),
              "--sqrt-npackets", "2", "--snapshot-file", p,
              "--snapshot-key", "snapshots/sol/0",
              "--packet-velocity-scale", "2.0"])
        from juliaraytracingsw_tpu.io.output import SequencedReader

        r = SequencedReader(str(tmp_path / "packets"))
        steps = r.steps("p/x")
        assert steps
        x = r.read(f"p/x/{steps[-1]}")
        assert np.isfinite(x).all()


class TestJLD2Fidelity:
    """Structurally-faithful fixtures: superblock v2+,
    /_types committed datatypes with julia_type attrs, unicode keys and
    struct fieldnames — the features real JLD2.jl files carry."""

    def _psih(self, rng, nx=16):
        nl, nkr = nx, nx // 2 + 1
        return (rng.standard_normal((2, nl, nkr))
                + 1j * rng.standard_normal((2, nl, nkr))).astype(np.complex64)

    def test_fixture_has_jld2_structure(self, tmp_path, rng):
        from juliaraytracingsw_tpu.io.jld2_fixture import write_twolayer_ic

        p = str(tmp_path / "ic.jld2")
        write_twolayer_ic(p, self._psih(rng), dt=2e-3, t=7.25)
        # HDF5 signature + superblock version >= 2 (byte 8 of the file)
        with open(p, "rb") as fh:
            header = fh.read(16)
        assert header[:8] == b"\x89HDF\r\n\x1a\n"
        assert header[8] >= 2, f"superblock version {header[8]}"
        with h5py.File(p, "r") as f:
            assert "_types" in f and len(f["_types"]) >= 2
            names = sorted(f["_types"])
            dt0 = f[f"_types/{names[0]}"]
            assert "julia_type" in dt0.attrs
            assert "Complex" in dt0.attrs["julia_type"]
            assert f["params"].attrs["julia_type"] == "Main.Params"
            assert "snapshots/ψh/0" in f

    def test_load_twolayer_ic_roundtrip(self, tmp_path, rng):
        from juliaraytracingsw_tpu.io.jld2 import load_struct, load_twolayer_ic
        from juliaraytracingsw_tpu.io.jld2_fixture import write_twolayer_ic

        psih = self._psih(rng)
        p = str(tmp_path / "ic.jld2")
        write_twolayer_ic(p, psih, dt=2e-3, t=7.25, f0=3.0, U=(0.15, -0.15),
                          mu=0.4)
        out, t, params, dt = load_twolayer_ic(p)
        np.testing.assert_allclose(out, psih, rtol=1e-6)
        assert t == 7.25 and dt == 2e-3
        # unicode fieldnames unpack like the reference's @unpack f₀, β, μ
        assert params["f₀"] == 3.0 and params["μ"] == 0.4
        np.testing.assert_allclose(params["U"], [0.15, -0.15])
        with pytest.raises(TypeError):
            load_struct(p, "clock/dt")

    def test_simulation_to_raytracing_chain(self, tmp_path, rng):
        """Production chain: twolayer-simulation writes the IC file in the
        reference layout; twolayer --ic-file consumes it
        (TwoLayerSimulation.jl:137-143 -> TwoLayerRaytracing.jl:162-182)."""
        from juliaraytracingsw_tpu.experiments.__main__ import main

        sim_dir = tmp_path / "sim"
        main(["twolayer-simulation", "--nx", "16", "--T", "0.02",
              "--U", "0.15", "--out-dir", str(sim_dir)])
        ics = [p for p in os.listdir(sim_dir)
               if p.startswith("initial_condition_")]
        assert ics, "no IC file written"
        run_dir = tmp_path / "run"
        main(["twolayer", "--nx", "16", "--T", "0.02", "--spinup-T", "0.0",
              "--output-dt", "0.01", "--out-dir", str(run_dir),
              "--sqrt-npackets", "2", "--ic-file", str(sim_dir / ics[0])])
        from juliaraytracingsw_tpu.io.output import SequencedReader

        r = SequencedReader(str(run_dir / "packets"))
        assert r.steps("p/x")
