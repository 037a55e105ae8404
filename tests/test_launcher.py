"""Multi-host launcher: env resolution + sweep orchestration.

The reference's cluster layer is sbatch scripts + job arrays
(raytracing/array-driver.sbatch, rsw/rsw-raytracing-driver.sbatch); this
build resolves the process topology from the scheduler environment and
stitches hosts with jax.distributed. Real multi-process bring-up needs >1
host, so these tests cover the pure resolution logic, the single-process
no-op, the per-child card allocation, and the local sweep orchestrator
end-to-end.
"""
import os
import subprocess
import sys

import pytest

from juliaraytracingsw_tpu.parallel.launcher import (
    ClusterSpec,
    card_slots,
    launch_sweep,
    resolve_cluster,
    initialize_from_env,
    sweep_row_from_env,
    visible_cards,
)
from juliaraytracingsw_tpu.parallel.mesh import init_distributed


def test_resolve_single():
    spec = resolve_cluster({})
    assert spec == ClusterSpec(None, 1, 0, source="single")


def test_resolve_explicit():
    spec = resolve_cluster({
        "JRSW_COORDINATOR": "10.0.0.1:1234",
        "JRSW_NUM_PROCESSES": "4",
        "JRSW_PROCESS_ID": "3",
    })
    assert spec.source == "explicit"
    assert spec.coordinator == "10.0.0.1:1234"
    assert (spec.num_processes, spec.process_id) == (4, 3)


def test_resolve_slurm_nodelist_expansion():
    spec = resolve_cluster({
        "SLURM_PROCID": "2",
        "SLURM_NTASKS": "8",
        "SLURM_JOB_NODELIST": "gpu-[003-010,012]",
    })
    assert spec.source == "slurm"
    assert spec.coordinator == "gpu-003:8476"
    assert (spec.num_processes, spec.process_id) == (8, 2)

    # plain comma list + custom port
    spec = resolve_cluster({
        "SLURM_PROCID": "0",
        "SLURM_NTASKS": "2",
        "SLURM_STEP_NODELIST": "nodeA,nodeB",
        "JRSW_PORT": "9000",
    })
    assert spec.coordinator == "nodeA:9000"


def test_resolve_slurm_single_task_is_single():
    spec = resolve_cluster({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"})
    assert spec.source == "single"


def test_resolve_mpi_requires_coordinator():
    with pytest.raises(RuntimeError):
        resolve_cluster({"OMPI_COMM_WORLD_SIZE": "2",
                         "OMPI_COMM_WORLD_RANK": "1"})
    spec = resolve_cluster({"OMPI_COMM_WORLD_SIZE": "2",
                            "OMPI_COMM_WORLD_RANK": "1",
                            "JRSW_COORDINATOR": "h:1"})
    assert spec.source == "mpi" and spec.process_id == 1


def test_initialize_single_process_noop():
    # must not touch jax.distributed (which would fail in-process here)
    spec = initialize_from_env({})
    assert spec.source == "single"
    assert init_distributed(num_processes=1) == 0


def test_sweep_row_from_env():
    rows = [{"a": "1"}, {"a": "2"}, {"a": "3"}]
    assert sweep_row_from_env(rows, {"JRSW_SWEEP_INDEX": "2"}) == {"a": "3"}
    # SLURM array ids are 1-based like the reference's parameters.txt lookup
    assert sweep_row_from_env(rows, {"SLURM_ARRAY_TASK_ID": "1"}) == {"a": "1"}
    with pytest.raises(RuntimeError):
        sweep_row_from_env(rows, {})


def test_launch_sweep_runs_rows(tmp_path):
    out = tmp_path / "sweep"
    script = tmp_path / "job.py"
    script.write_text(
        "import sys, os, json\n"
        "args = dict(zip(sys.argv[1::2], sys.argv[2::2]))\n"
        "os.makedirs(args['--out'], exist_ok=True)\n"
        "open(os.path.join(args['--out'], 'done.json'), 'w').write(\n"
        "    json.dumps({'ag': args['--ag'],\n"
        "                'idx': os.environ['JRSW_SWEEP_INDEX']}))\n"
    )
    rows = [{"ag": "0.5"}, {"ag": "1.5"}, {"ag": "2.5"}]
    rcs = launch_sweep([sys.executable, str(script)], rows, str(out),
                       max_parallel=2)
    assert rcs == [0, 0, 0]
    import json

    for i, row in enumerate(rows):
        rec = json.loads((out / f"run{i:03d}" / "done.json").read_text())
        assert rec == {"ag": row["ag"], "idx": str(i)}


def test_launch_sweep_dry_run(capsys, tmp_path):
    rcs = launch_sweep(["prog"], [{"x": "1"}], str(tmp_path), dry_run=True)
    assert rcs == [0]
    assert "--x 1" in capsys.readouterr().out


def test_cli_sweep_picks_array_row(tmp_path, monkeypatch):
    """`experiments sweep` under SLURM_ARRAY_TASK_ID runs exactly one row."""
    table = tmp_path / "params.txt"
    table.write_text("ArrayTaskID ag\n1 0.5\n2 1.5\n")
    env = dict(os.environ, SLURM_ARRAY_TASK_ID="2", JAX_PLATFORMS="cpu")
    # use a subcommand invocation that fails fast after printing the plan:
    # dry-check via --extra-args pointing at an invalid flag would still
    # spawn; instead just verify row selection through the library path.
    from juliaraytracingsw_tpu.config.params import load_sweep_table

    rows = load_sweep_table(str(table))
    sel = sweep_row_from_env(rows, env)
    assert sel["ag"] == "1.5"


def test_card_slots_round_robin_one_child_per_card():
    """On a 4-card host each concurrent child gets its own card, in order,
    and a request for more children than cards is capped at the cards."""
    logs = []
    assert card_slots(2, {}, cards=["0", "1", "2", "3"]) == ["0", "1"]
    slots = card_slots(6, {}, cards=["0", "1", "2", "3"], log=logs.append)
    assert slots == ["0", "1", "2", "3"]
    assert logs and "capped at 4" in logs[0]


def test_card_slots_shared_cards_need_mem_fraction():
    """Several children per card only with XLA_PYTHON_CLIENT_MEM_FRACTION,
    and the sweep says so; cards are still dealt round-robin."""
    logs = []
    env = {"XLA_PYTHON_CLIENT_MEM_FRACTION": "0.2"}
    slots = card_slots(5, env, cards=["3", "5"], log=logs.append)
    assert slots == ["3", "5", "3", "5", "3"]
    assert logs and "XLA_PYTHON_CLIENT_MEM_FRACTION=0.2" in logs[0]


def test_card_slots_cpu_children_get_no_card_and_no_cap():
    assert card_slots(8, {"JAX_PLATFORMS": "cpu"}, cards=["0"]) == [None] * 8
    assert card_slots(3, {}, cards=[]) == [None] * 3


def test_visible_cards_reads_cuda_visible_devices():
    assert visible_cards({"CUDA_VISIBLE_DEVICES": "2,3"}) == ["2", "3"]
    assert visible_cards({"CUDA_VISIBLE_DEVICES": ""}) == []


def test_launch_sweep_children_get_own_card(tmp_path, monkeypatch):
    """Each child sees only the card it was dealt (CUDA_VISIBLE_DEVICES)."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,7")
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.delenv("XLA_PYTHON_CLIENT_MEM_FRACTION", raising=False)
    out = tmp_path / "seen"
    out.mkdir()
    script = ("import os, sys; open(os.path.join(sys.argv[1], "
              "os.environ['JRSW_SWEEP_INDEX']), 'w').write("
              "os.environ['CUDA_VISIBLE_DEVICES'])")
    rcs = launch_sweep([sys.executable, "-c", script, str(out)],
                       [{}, {}, {}], str(tmp_path / "logs"),
                       max_parallel=4, out_flag=None)
    assert rcs == [0, 0, 0]
    seen = [(out / str(i)).read_text() for i in range(3)]
    assert set(seen) <= {"4", "7"} and seen[:2] == ["4", "7"]
