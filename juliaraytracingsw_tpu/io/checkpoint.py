"""Bit-exact checkpoint/resume of coupled simulations.

Saves the FULL integration state pytree — spectral solution, stepper AB3
history (N_{-1}, N_{-2}), packet ensemble, clock, and (when birth/death
resampling is active) the BirthDeathState including its PRNG key — so a
resumed run continues the exact trajectory AND the exact stochastic stream.
This fixes the reference's restart discontinuity, where snapshots double as
checkpoints but the AB3 history is lost and the stepper re-bootstraps with
forward-Euler steps (SURVEY.md §5.4; utils/IFMAB3.jl:130).

Restore validates BOTH leaf shapes/dtypes and the stored pytree STRUCTURE
against the running state, so a checkpoint from a differently-configured
run (e.g. birth/death on vs off, different stepper history layout) fails
loudly instead of restoring silently wrong.
"""
from __future__ import annotations

import numpy as np
import jax


__all__ = ["save_checkpoint", "load_checkpoint"]


def _flatten_with_paths(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return leaves, treedef


def _leaf_paths(tree) -> list[str]:
    """Version-stable structural fingerprint: the key path of every leaf
    (e.g. '.packets.x'), via the public tree_flatten_with_path API —
    unlike repr(PyTreeDef), key-path strings survive jax upgrades."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["".join(str(k) for k in kp) for kp, _ in flat]


def save_checkpoint(path: str, state_tree) -> None:
    """Serialize an arbitrary pytree of arrays to one .npz file."""
    from ..core.transfer import to_host

    leaves, treedef = _flatten_with_paths(state_tree)
    arrays = {f"leaf_{i}": to_host(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        repr(treedef).encode(), dtype=np.uint8
    )
    arrays["__treepaths__"] = np.frombuffer(
        "\n".join(_leaf_paths(state_tree)).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_checkpoint(path: str, like_tree):
    """Restore into the structure of ``like_tree``.

    Validates (a) the stored treedef repr against ``like_tree``'s structure,
    (b) the leaf count, and (c) every leaf's shape — mismatches raise with a
    diagnostic instead of unflattening a structurally different state.
    """
    data = np.load(path)
    leaves, treedef = jax.tree_util.tree_flatten(like_tree)
    mismatch = None
    if "__treepaths__" in data:
        # preferred: leaf key paths are stable across jax versions
        stored = bytes(data["__treepaths__"]).decode()
        current = "\n".join(_leaf_paths(like_tree))
        if stored != current:
            mismatch = (stored, current)
    elif "__treedef__" in data:
        # legacy checkpoints: repr comparison (same-version only)
        stored = bytes(data["__treedef__"]).decode()
        if stored != repr(treedef):
            mismatch = (stored, repr(treedef))
    if mismatch is not None:
        raise ValueError(
            "checkpoint pytree structure does not match the running "
            f"state:\n  stored:   {mismatch[0]}\n  expected: {mismatch[1]}\n"
            "(was the checkpoint written with a different driver "
            "configuration — stepper, birth/death, packet layout?)"
        )
    n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
    if n_stored != len(leaves):
        raise ValueError(
            f"checkpoint has {n_stored} leaves, running state has "
            f"{len(leaves)}"
        )
    out = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        # compare by METADATA only — np.asarray(ref) would pull the live
        # device leaf to host
        ref_shape = tuple(np.shape(ref))
        # plain Python scalar leaves have no .dtype; np.result_type infers
        # int/float correctly (a float64 fallback would silently retype ints)
        ref_dtype = (np.dtype(ref.dtype) if hasattr(ref, "dtype")
                     else np.result_type(ref))
        if tuple(arr.shape) != ref_shape:
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != expected {ref_shape}"
            )
        from ..core.transfer import to_device

        out.append(to_device(arr.astype(ref_dtype)))
    return jax.tree_util.tree_unflatten(treedef, out)
