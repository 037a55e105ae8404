"""Multi-host launch + sweep orchestration.

The reference's entire cluster story is SLURM shell scripts: per-run sbatch
files that copy ``.jl`` sources into a rundir and job arrays that ``awk`` a
row out of ``parameters.txt`` (rsw/rsw-raytracing-driver.sbatch,
raytracing/array-driver.sbatch + raytracing/parameters.txt). The JAX
equivalent has two independent layers:

1. **One tightly-coupled job spanning several GPU hosts** — one process per
   host drives all of that host's cards; ``jax.distributed.initialize``
   stitches the hosts into a single device set, and all cross-card traffic
   is XLA collectives (NCCL). ``resolve_cluster`` derives (coordinator,
   num_processes, process_id) from whatever scheduler environment is
   present, in priority order:

   - explicit ``JRSW_COORDINATOR`` / ``JRSW_NUM_PROCESSES`` / ``JRSW_PROCESS_ID``
   - SLURM (``SLURM_STEP_NODELIST``/``SLURM_JOB_NODELIST``, ``SLURM_NTASKS``,
     ``SLURM_PROCID``) — the reference's scheduler, so its users keep their
     sbatch workflow and replace ``julia Main.jl`` with
     ``python -m juliaraytracingsw_tpu.experiments <cmd> --distributed``
   - OpenMPI (``OMPI_COMM_WORLD_SIZE``/``RANK``) via ``mpirun``

2. **Embarrassingly-parallel parameter sweeps** — independent runs, one per
   parameter-table row (the reference's job arrays). ``launch_sweep`` runs
   them as local subprocesses with bounded concurrency; under SLURM each
   array task simply picks its row via ``sweep_row_from_env`` (replaces the
   ``awk`` lookup in array-driver.sbatch). A JAX process reserves most of a
   card's memory when it starts, so each child gets one card of its own
   through ``CUDA_VISIBLE_DEVICES`` (``card_slots``).

See README.md "Distributed runs" for the operational recipe.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from dataclasses import dataclass

__all__ = [
    "ClusterSpec", "resolve_cluster", "initialize_from_env",
    "sweep_row_from_env", "visible_cards", "card_slots", "launch_sweep",
]


@dataclass(frozen=True)
class ClusterSpec:
    """Resolved multi-process topology."""

    coordinator: str | None
    num_processes: int
    process_id: int
    source: str   # 'explicit' | 'slurm' | 'mpi' | 'single'


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, expanding one bracket group:
    ``gpu-[003-010,12]`` -> ``gpu-003``. Pure string logic (no ``scontrol``
    dependency) so it is unit-testable off-cluster."""
    first = nodelist.split(",")[0] if "[" not in nodelist else nodelist
    m = re.match(r"([^\[,]+)\[([^\]]+)\]", first)
    if not m:
        return first.split(",")[0]
    prefix, body = m.groups()
    tok = body.split(",")[0].split("-")[0]
    return prefix + tok


def resolve_cluster(env: dict | None = None) -> ClusterSpec:
    """Derive the process topology from the environment (pure; testable)."""
    env = os.environ if env is None else env
    if "JRSW_NUM_PROCESSES" in env:
        n = int(env["JRSW_NUM_PROCESSES"])
        return ClusterSpec(
            coordinator=env.get("JRSW_COORDINATOR"),
            num_processes=n,
            process_id=int(env.get("JRSW_PROCESS_ID", "0")),
            source="explicit",
        )
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        nodelist = env.get("SLURM_STEP_NODELIST",
                           env.get("SLURM_JOB_NODELIST", ""))
        port = env.get("JRSW_PORT", "8476")
        return ClusterSpec(
            coordinator=f"{_first_slurm_host(nodelist)}:{port}",
            num_processes=int(env["SLURM_NTASKS"]),
            process_id=int(env["SLURM_PROCID"]),
            source="slurm",
        )
    if int(env.get("OMPI_COMM_WORLD_SIZE", "1")) > 1:
        coord = env.get("JRSW_COORDINATOR")
        if coord is None:
            raise RuntimeError(
                "mpirun detected but no coordinator address; set "
                "JRSW_COORDINATOR=host:port on every rank"
            )
        return ClusterSpec(
            coordinator=coord,
            num_processes=int(env["OMPI_COMM_WORLD_SIZE"]),
            process_id=int(env["OMPI_COMM_WORLD_RANK"]),
            source="mpi",
        )
    return ClusterSpec(None, 1, 0, source="single")


def initialize_from_env(env: dict | None = None) -> ClusterSpec:
    """Resolve the topology and bring up ``jax.distributed`` accordingly.

    Single-process: no-op. Otherwise: explicit coordinator/size/rank.
    Returns the resolved spec."""
    from .mesh import init_distributed

    spec = resolve_cluster(env)
    if spec.source == "single":
        return spec
    init_distributed(spec.coordinator, spec.num_processes, spec.process_id)
    return spec


# --- parameter sweeps (job-array replacement) --------------------------------

def sweep_row_from_env(rows: list[dict], env: dict | None = None) -> dict:
    """Pick this task's sweep row under a SLURM job array
    (``SLURM_ARRAY_TASK_ID``, 1-based like the reference's parameters.txt
    lookup) or an explicit ``JRSW_SWEEP_INDEX`` (0-based)."""
    env = os.environ if env is None else env
    if "JRSW_SWEEP_INDEX" in env:
        return rows[int(env["JRSW_SWEEP_INDEX"])]
    if "SLURM_ARRAY_TASK_ID" in env:
        return rows[int(env["SLURM_ARRAY_TASK_ID"]) - 1]
    raise RuntimeError("no sweep index in environment "
                       "(JRSW_SWEEP_INDEX or SLURM_ARRAY_TASK_ID)")


def visible_cards(env: dict | None = None) -> list[str]:
    """GPU ids this process may hand to children: ``CUDA_VISIBLE_DEVICES``
    when set, else the indices ``nvidia-smi`` lists (none on a host
    without NVIDIA cards). Stays off JAX, so the parent holds no card."""
    env = os.environ if env is None else env
    if "CUDA_VISIBLE_DEVICES" in env:
        return [c for c in env["CUDA_VISIBLE_DEVICES"].split(",") if c]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    if out.returncode != 0:
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def card_slots(max_parallel: int, env: dict | None = None,
               cards: list[str] | None = None,
               log=None) -> list[str | None]:
    """Concurrency slots of a sweep, each with the card its child gets
    (``None``: no ``CUDA_VISIBLE_DEVICES`` restriction).

    Children that run with ``JAX_PLATFORMS=cpu`` (e.g. the numpy-only
    omega-k fan-out) and hosts without cards get no card and no cap. On a
    GPU host each child gets one card, round-robin, and concurrency is
    capped at the number of cards: a JAX process reserves most of its
    card's memory at start-up, so a second one on the same card fails.
    Several children per card need ``XLA_PYTHON_CLIENT_MEM_FRACTION``
    set to each one's share; the sweep then logs that it shares cards."""
    env = os.environ if env is None else env
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    if env.get("JAX_PLATFORMS") == "cpu":
        return [None] * max_parallel
    cards = visible_cards(env) if cards is None else cards
    if not cards:
        return [None] * max_parallel
    frac = env.get("XLA_PYTHON_CLIENT_MEM_FRACTION")
    if max_parallel > len(cards):
        if frac:
            log(f"sweep: {max_parallel} children share {len(cards)} card(s), "
                f"XLA_PYTHON_CLIENT_MEM_FRACTION={frac} each")
            return [cards[i % len(cards)] for i in range(max_parallel)]
        log(f"sweep: --max-parallel {max_parallel} capped at {len(cards)}, "
            "one child per card (set XLA_PYTHON_CLIENT_MEM_FRACTION to "
            "share cards)")
    return [cards[i] for i in range(min(max_parallel, len(cards)))]


def launch_sweep(base_cmd: list[str], rows: list[dict], out_root: str,
                 max_parallel: int = 1, env_extra: dict | None = None,
                 dry_run: bool = False, out_flag: str | None = "--out") -> list[int]:
    """Run one subprocess per sweep row with bounded concurrency.

    Each child gets ``JRSW_SWEEP_INDEX=i``, a per-row ``<out_flag>``
    directory (omitted when ``out_flag=None`` for tasks that share one
    output dir, e.g. omega-k k-range fan-out), the row's key/values
    appended as ``--key value`` CLI overrides — the local stand-in for a
    SLURM array over parameters.txt — and a card of its own (see
    ``card_slots``, which also caps the concurrency). Returns the list of
    return codes (ordered by row)."""
    os.makedirs(out_root, exist_ok=True)
    cmds, envs = [], []
    for i, row in enumerate(rows):
        cmd = list(base_cmd)
        if out_flag is not None:
            cmd += [out_flag, os.path.join(out_root, f"run{i:03d}")]
        for k, v in row.items():
            cmd += [f"--{k.replace('_', '-')}", str(v)]
        e = dict(os.environ, JRSW_SWEEP_INDEX=str(i), **(env_extra or {}))
        cmds.append(cmd)
        envs.append(e)
    if dry_run:
        for c in cmds:
            print(" ".join(c))
        return [0] * len(cmds)
    slots = card_slots(max_parallel, dict(os.environ, **(env_extra or {})))
    free = list(range(len(slots)))
    rcs: list[int | None] = [None] * len(cmds)
    running: list[tuple[int, subprocess.Popen, int]] = []
    nxt = 0
    while nxt < len(cmds) or running:
        while nxt < len(cmds) and free:
            slot = free.pop(0)
            if slots[slot] is not None:
                envs[nxt]["CUDA_VISIBLE_DEVICES"] = slots[slot]
            log = open(os.path.join(out_root, f"run{nxt:03d}.log"), "w")
            p = subprocess.Popen(cmds[nxt], env=envs[nxt],
                                 stdout=log, stderr=subprocess.STDOUT)
            running.append((nxt, p, slot))
            nxt += 1
        idx, p, slot = running.pop(0)
        rcs[idx] = p.wait()
        free.append(slot)
        if rcs[idx] != 0:
            print(f"sweep run{idx:03d} exited rc={rcs[idx]}", file=sys.stderr)
    return [rc if rc is not None else -1 for rc in rcs]
