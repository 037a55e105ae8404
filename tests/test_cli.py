"""CLI smoke tests: every experiment subcommand runs a toy config end-to-end
and records energetics (reference parity: one entry point per *Main.jl /
driver; variants replace the sbatch file-swap pattern)."""
import os

import jax

import h5py
import numpy as np
import pytest

from juliaraytracingsw_tpu.experiments.__main__ import main


def _common(tmp_path, T="0.05", spinup="0.01", out_dt="0.01", nx="32"):
    return ["--nx", nx, "--spinup-T", spinup, "--T", T,
            "--output-dt", out_dt, "--out-dir", str(tmp_path),
            "--sqrt-npackets", "2"]


@pytest.mark.parametrize("variant", ["rsw", "linborg", "modified",
                                     "quadheight"])
def test_rsw_variants_run_from_cli(tmp_path, variant):
    """--model {rsw,linborg,modified,quadheight} replaces the reference's
    file-swap of {Linborg,Modified,QuadHeight}ShallowWater.jl
    (rsw/rsw-driver.sbatch)."""
    main(["rsw", "--model", variant, "--ag", "0.2", "--aw", "0.02",
          *_common(tmp_path)])
    with h5py.File(tmp_path / "diagnostics.h5", "r") as f:
        ke = f["kinetic_energy"][()]
        pe = f["potential_energy"][()]
        assert np.isfinite(ke).all() and np.isfinite(pe).all()
        assert (ke > 0).all()


def test_rsw_birth_death_flag(tmp_path):
    """--birth-death is read and produces population telemetry."""
    main(["rsw", "--birth-death", "--bd-lam", "0.005", "--ag", "0.2",
          "--aw", "0.02", *_common(tmp_path, T="0.06")])
    from juliaraytracingsw_tpu.io.output import SequencedReader

    r = SequencedReader(str(tmp_path / "packets"))
    steps = r.steps("p/births")
    assert steps, "no birth telemetry written"
    assert int(r.read(f"p/births/{steps[-1]}")) > 0


def test_thomasyamada_two_phase_cli(tmp_path):
    main(["thomasyamada", "--nx", "32", "--ty-dt", "1e-3",
          "--startup-dt-factor", "2", "--startup-T", "0.01",
          "--T", "0.01", "--output-dt", "0.005",
          "--out-dir", str(tmp_path)])
    assert os.path.exists(tmp_path / "startup.000000.h5")
    assert os.path.exists(tmp_path / "ty.000000.h5")
    with h5py.File(tmp_path / "diagnostics.h5", "r") as f:
        assert np.isfinite(f["wave_ke"][()]).all()
        assert np.isfinite(f["geo_ke"][()]).all()


def test_omega_k_mem_cap_blocking_and_fanout(tmp_path):
    """Streamed omega-k: a tiny --mem-cap-gb forces
    multiple k sub-blocks whose per-k outputs are identical to the
    unblocked run, and --fanout runs the full k range as concurrent
    launcher-backed task processes."""
    run = tmp_path / "run"
    run.mkdir()
    main(["rsw", "--ag", "0.2", "--aw", "0.02", "--nx", "16",
          "--spinup-T", "0.0", "--T", "0.08", "--output-dt", "0.01",
          "--out-dir", str(run), "--sqrt-npackets", "2"])

    out_a = tmp_path / "oka"
    out_b = tmp_path / "okb"
    main(["omega-k", str(run), "--out-dir", str(out_a)])
    # ~5e-7 GB cap => a few k rows per sub-block at 16^2
    main(["omega-k", str(run), "--out-dir", str(out_b),
          "--mem-cap-gb", "5e-7"])
    files = sorted(os.listdir(out_a))
    assert files == sorted(os.listdir(out_b)) and len(files) == 9
    for name in files:
        with h5py.File(out_a / name, "r") as fa, \
                h5py.File(out_b / name, "r") as fb:
            for key in fa:
                np.testing.assert_array_equal(fa[key][()], fb[key][()])

    out_c = tmp_path / "okc"
    main(["omega-k", str(run), "--out-dir", str(out_c), "--fanout", "2"])
    got = sorted(p for p in os.listdir(out_c) if p.startswith("radial"))
    assert got == files


def test_omega_k_plot_assembly(tmp_path):
    """omega-k-plot assembles per-k files into radial (omega, K) power
    classes (MakeOmegaKPlots parity): Parseval-style sanity — total
    assembled power equals the sum of the per-k weighted powers, shapes
    consistent, heatmaps written."""
    run = tmp_path / "run"
    run.mkdir()
    main(["rsw", "--ag", "0.2", "--aw", "0.02", "--nx", "16",
          "--spinup-T", "0.0", "--T", "0.08", "--output-dt", "0.01",
          "--out-dir", str(run), "--sqrt-npackets", "2"])
    ok = tmp_path / "ok"
    main(["omega-k", str(run), "--out-dir", str(ok)])
    main(["omega-k-plot", str(run), "--omega-dir", str(ok),
          "--out-dir", str(ok)])
    with h5py.File(ok / "omega_k_radial.h5", "r") as f:
        omega = f["omega"][()]
        K = f["K"][()]
        for name in ("c0", "cp", "cm"):
            P = f[name][()]
            assert P.shape == (len(omega), len(K))
            assert np.isfinite(P).all() and (P >= 0).all()
            assert P.sum() > 0
    for name in ("c0", "cp", "cm"):
        assert (ok / f"omega_k_{name}.png").exists()


def test_omega_k_ty_model_mem_cap(tmp_path):
    """TY omega-k rows (complex-U +/- separation) under mem-cap blocking:
    sub-block outputs identical to the unblocked run."""
    run = tmp_path / "run"
    main(["thomasyamada", "--nx", "16", "--ty-dt", "2e-3",
          "--startup-dt-factor", "2", "--startup-T", "0.01", "--T", "0.08",
          "--output-dt", "0.01", "--out-dir", str(run)])
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    main(["omega-k", str(run), "--base", "ty", "--model", "ty",
          "--out-dir", str(out_a)])
    main(["omega-k", str(run), "--base", "ty", "--model", "ty",
          "--out-dir", str(out_b), "--mem-cap-gb", "5e-7"])
    files = sorted(os.listdir(out_a))
    assert files == sorted(os.listdir(out_b)) and len(files) == 9
    with h5py.File(out_a / files[2], "r") as fa, \
            h5py.File(out_b / files[2], "r") as fb:
        assert "U_wave" in fa and "ut" in fa
        for key in fa:
            np.testing.assert_array_equal(fa[key][()], fb[key][()])


def test_live_dashboard_written(tmp_path):
    """--live N writes a refreshing live.png + live.html during the run
    (headless stand-in for the reference's Makie window)."""
    main(["rsw", "--ag", "0.2", "--aw", "0.02", "--live", "2",
          *_common(tmp_path, T="0.05")])
    assert (tmp_path / "live.png").exists()
    html = (tmp_path / "live.html").read_text()
    assert "http-equiv=\"refresh\"" in html and "live.png" in html


def test_b_parameter_chain(tmp_path):
    """omega-k --decompose stores psit rows; b-parameter computes a finite
    non-negative diffusivity estimate from them (compute_b_parameter.jl
    chain)."""
    run = tmp_path / "run"
    run.mkdir()
    main(["rsw", "--ag", "0.2", "--aw", "0.02", "--nx", "16",
          "--spinup-T", "0.0", "--T", "0.08", "--output-dt", "0.01",
          "--out-dir", str(run), "--sqrt-npackets", "2"])
    ok = tmp_path / "ok"
    main(["omega-k", str(run), "--out-dir", str(ok)])
    main(["b-parameter", str(run), "--omega-dir", str(ok),
          "--n-points", "16"])
    with h5py.File(ok / "b_parameter.h5", "r") as f:
        b = float(f["b"][()])
        D11 = f["D11"][()]
    assert np.isfinite(b) and b >= 0
    assert np.isfinite(D11).all() and (D11 >= 0).all()


def test_omega_k_stft_rows(tmp_path):
    """--stft-window stores sliding-window spectra per k
    (ShortTimeFourierSWQG.jl parity at CLI level)."""
    run = tmp_path / "run"
    run.mkdir()
    main(["rsw", "--ag", "0.2", "--aw", "0.02", "--nx", "16",
          "--spinup-T", "0.0", "--T", "0.12", "--output-dt", "0.01",
          "--out-dir", str(run), "--sqrt-npackets", "2"])
    ok = tmp_path / "ok"
    main(["omega-k", str(run), "--out-dir", str(ok), "--stft-window", "6"])
    with h5py.File(ok / "radial_data_k=002.h5", "r") as f:
        spec = f["stft/c0"][()]
        centers = f["stft/centers"][()]
        assert spec.shape[0] == len(centers) and spec.shape[1] == 6
        assert np.isfinite(spec).all()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_rsw_sharded_cli(tmp_path):
    """--sharded routes the run through the kr-column-sharded flow path
    (parallel/sharded.py) with data-parallel packets."""
    out = tmp_path / "shrun"
    out.mkdir()
    main(["rsw", "--sharded", "--ag", "0.2", "--aw", "0.02",
          *_common(tmp_path, nx="32"), "--out-dir", str(out),
          "--sqrt-npackets", "8"])
    files = {p.name for p in out.iterdir()}
    assert any(f.startswith("rsw") for f in files)
    assert any(f.startswith("packets") for f in files)
    assert "diagnostics.h5" in files


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_twolayer_sharded_cli_baroclinic(tmp_path):
    out = tmp_path / "shrun2l"
    out.mkdir()
    main(["twolayer", "--sharded", "--baroclinic", "--U", "0.1",
          *_common(tmp_path, nx="32"), "--out-dir", str(out),
          "--sqrt-npackets", "8"])
    assert (out / "diagnostics.h5").exists()


def test_sharded_rejects_unsupported_combo(tmp_path):
    out = tmp_path / "shbad"
    out.mkdir()
    with pytest.raises(SystemExit, match="frozen-flow"):
        main(["rsw", "--sharded", "--frozen-flow",
              *_common(tmp_path, nx="32"), "--out-dir", str(out)])


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_checkpoint_restore_roundtrip(tmp_path):
    """--sharded runs checkpoint UNSHARDED host state (portable across mesh
    sizes) and restore re-shards it, AB3 history included."""
    out1 = tmp_path / "a"; out1.mkdir()
    ck = str(tmp_path / "state.npz")
    main(["rsw", "--sharded", "--ag", "0.2", "--aw", "0.02",
          *_common(tmp_path, nx="32"), "--out-dir", str(out1),
          "--sqrt-npackets", "8", "--checkpoint", ck])
    out2 = tmp_path / "b"; out2.mkdir()
    main(["rsw", "--sharded", "--ag", "0.2", "--aw", "0.02",
          "--nx", "32", "--spinup-T", "0", "--T", "0.02",
          "--output-dt", "0.01", "--out-dir", str(out2),
          "--sqrt-npackets", "8", "--restore", ck])
    with h5py.File(out2 / "diagnostics.h5") as f:
        t = np.asarray(f["t"])
        ke = np.asarray(f["kinetic_energy"])
    # the restored run continues from the checkpointed clock
    assert t[0] > 0.0 and np.isfinite(ke).all()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_thomasyamada_sharded_cli(tmp_path):
    """thomasyamada --sharded runs both phases on ShardedThomasYamada with
    the same outputs/diagnostics as the replicated two-phase driver
   ."""
    main(["thomasyamada", "--sharded", "--nx", "32", "--ty-dt", "1e-3",
          "--startup-dt-factor", "2", "--startup-T", "0.01",
          "--T", "0.01", "--output-dt", "0.005",
          "--out-dir", str(tmp_path)])
    assert os.path.exists(tmp_path / "startup.000000.h5")
    assert os.path.exists(tmp_path / "ty.000000.h5")
    with h5py.File(tmp_path / "diagnostics.h5", "r") as f:
        assert np.isfinite(f["wave_ke"][()]).all()
        assert np.isfinite(f["geo_ke"][()]).all()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_multilayer_sharded_cli(tmp_path):
    """twolayer --nlayers 3 --sharded: the n-layer MultiLayerQG path on
    ShardedMultiLayerQG, packets on the depth-weighted barotropic mean
   ."""
    out = tmp_path / "sh3l"
    out.mkdir()
    main(["twolayer", "--nlayers", "3", "--sharded", "--U", "0.1",
          *_common(tmp_path, nx="32"), "--out-dir", str(out),
          "--sqrt-npackets", "8"])
    with h5py.File(out / "diagnostics.h5") as f:
        ke = f["kinetic_energy"][()]
        assert np.isfinite(ke).all() and ke.shape[-1] == 3


def test_multilayer_replicated_cli(tmp_path):
    """twolayer --nlayers 3 without --sharded uses the replicated
    MultiLayerQG model end-to-end."""
    out = tmp_path / "rep3l"
    out.mkdir()
    main(["twolayer", "--nlayers", "3", "--U", "0.1",
          *_common(tmp_path, nx="32"), "--out-dir", str(out)])
    with h5py.File(out / "diagnostics.h5") as f:
        assert np.isfinite(f["kinetic_energy"][()]).all()


def test_multilayer_rejects_twolayer_only_flags(tmp_path):
    with pytest.raises(SystemExit, match="two-layer-only"):
        main(["twolayer", "--nlayers", "3", "--baroclinic",
              *_common(tmp_path, nx="32")])
