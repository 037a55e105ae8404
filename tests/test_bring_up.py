"""Start-up contracts: the compile-cache location, a simulation path that
imports without h5py, and chip_smoke.py refusing to run without a GPU."""
import os
import subprocess
import sys

import jax
import pytest

from juliaraytracingsw_tpu.utils.compile_cache import (
    CHECKOUT_CACHE,
    setup_compile_cache,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_honours_env(restore_cache_dir, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is used and
    nothing else is set in code."""
    jax.config.update("jax_compilation_cache_dir", None)
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert setup_compile_cache(env) == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_checkout(restore_cache_dir):
    assert setup_compile_cache({}) == CHECKOUT_CACHE
    assert jax.config.jax_compilation_cache_dir == CHECKOUT_CACHE
    assert CHECKOUT_CACHE == os.path.join(ROOT, ".jax_cache")


_BLOCK_H5PY = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("h5py", "matplotlib"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
"""


def test_coupled_driver_runs_without_h5py():
    """CoupledDriver with no writers imports and steps with h5py and
    matplotlib absent (the GPU hosts need not have them)."""
    code = _BLOCK_H5PY + """
import numpy as np
from juliaraytracingsw_tpu.coupled.driver import CoupledDriver
from juliaraytracingsw_tpu.coupled.hero import DT, make_hero
h = make_hero(nx=32, sqrt_packets=8)
drv = CoupledDriver(model=h.model, psih_fn=h.psih_fn, rp=h.rp, dt=DT,
                    log_fn=lambda m: None)
drv.init(h.sol0, h.packets)
drv.run(n_frames=1, flow_steps_per_frame=2)
assert np.isfinite(np.asarray(drv.sim.packets.x)).all()
assert "h5py" not in sys.modules
print("ran")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ran")


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_chip_smoke_fails_without_gpu(args):
    """On a CPU-only backend chip_smoke.py exits non-zero at phase (a) and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py", *args], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stdout + r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the package, the script fails."""
    (tmp_path / "chip_smoke.py").write_bytes(
        open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
