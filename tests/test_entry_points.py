"""What decides where a solve runs, and how the entry scripts start.

- the batched solver's choice of path, from the platform and the OCP;
- the persistent compilation cache directory;
- chip_smoke.py refusing to run without a GPU or outside a checkout.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmmpc_tpu.controllers import MPC, MPCWholeBody
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import MobileManipulator, RobotDemo
from mmmpc_tpu.solver.batched import kernel_path_applies
from mmmpc_tpu.utils import compile_cache
from mmmpc_tpu.utils.configs import SolverConfig

REPO = Path(__file__).resolve().parents[1]
N = 5


def _qref():
    mpc = MPCWholeBody(MobileManipulator(0.1), [Obstacles(1.0, 0.2, 0.3)],
                       [], N=N)
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
    params = dict(mpc.make_params(np.tile(x0, (N + 1, 1)),
                                  np.zeros((N, 5))),
                  U_last=np.zeros((N, 5)))
    return mpc.ocp, params


@pytest.mark.parametrize("platform, use_kernels, formulation, fleet, want", [
    ("gpu", True, "qref", False, True),
    ("gpu", True, "qref", True, True),      # per-robot params the kernel reads
    ("cpu", True, "qref", False, False),
    ("rocm", True, "qref", False, False),
    ("gpu", False, "qref", False, False),   # the plain XLA path, on request
    ("gpu", True, "demo", False, False),    # no kernel for this OCP
])
def test_kernel_path_choice(platform, use_kernels, formulation, fleet, want):
    if formulation == "qref":
        ocp, params = _qref()
    else:
        mpc = MPC(RobotDemo(0.1), N=N)
        ocp = mpc.ocp
        params = mpc.make_params(np.zeros((N + 1, 2)), np.zeros((N, 1)))
    if fleet:
        params = dict(params, X_ref=np.zeros((N + 1, 9, 4)),
                      U_last=np.zeros((N, 5, 4)), eq_mask=np.ones(4))
    cfg = SolverConfig(use_kernels=use_kernels)
    assert kernel_path_applies(ocp, cfg, params, platform) is want


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "checkout"])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself; the code sets nothing
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            ignored = (REPO / ".gitignore").read_text().split()
            assert ".jax_cache/" in ignored
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run_smoke(cwd, path=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if path is not None:
        env["PATH"] = path
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("has_smi", [False, True],
                         ids=["no_nvidia_smi", "cpu_devices"])
def test_chip_smoke_refuses_without_gpu(has_smi, tmp_path):
    if has_smi:
        # an nvidia-smi that answers, while JAX still sees only CPUs
        smi = tmp_path / "nvidia-smi"
        smi.write_text("#!/bin/sh\necho 'Fake GPU, 100.00 W'\n")
        smi.chmod(0o755)
        path = f"{tmp_path}{os.pathsep}{os.environ.get('PATH', '')}"
    else:
        path = str(tmp_path)        # no nvidia-smi anywhere on the PATH
    out = _run_smoke(REPO, path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    if has_smi:
        assert "not a GPU" in out.stderr


def test_chip_smoke_needs_the_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_lanes_path_runs_at_highest_precision():
    """Every matrix product of the lanes path — the one-hot candidate
    selection included — is lowered at HIGHEST precision, so a float32
    product cannot drop to TF32 on the GPU."""
    from mmmpc_tpu.solver.batched import solve_batched_lanes

    ocp, params = _qref()
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    B = 4
    x0 = jnp.tile(params["X_ref"][0], (B, 1))
    U0 = jnp.zeros((B, N, 5), jnp.float32)
    cfg = SolverConfig(al_iters=1, ilqr_iters=1, n_alpha=2)
    text = jax.jit(lambda x, u: solve_batched_lanes(
        ocp, x, u, params, cfg, interpret=True)).lower(x0, U0).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots
    assert all("HIGHEST" in ln for ln in dots), [
        ln for ln in dots if "HIGHEST" not in ln][:3]
