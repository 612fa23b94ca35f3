"""Long-horizon benchmark: sequential lax.scan Riccati vs associative-scan
(parallel-prefix, O(log N) depth) across horizon lengths.

The reference caps its horizon at N=20 (demo_wholebody_qref.py:11); long-
horizon MPC is a new capability (SURVEY.md par.5 long-context row).  At small
batch the backward sweep's O(N) sequential depth dominates — the
assoc-scan path trades it for O(log N) depth at O(N) extra flops.

Run on the GPU:  python scripts/bench_longhorizon.py [batch]
"""
import dataclasses
import sys
import time
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from mmmpc_tpu.controllers import MPCWholeBody
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import MobileManipulator
from mmmpc_tpu.utils.configs import SolverConfig, make_scenario
from mmmpc_tpu.solver.batched import al_ilqr_solve_batched

CFG = SolverConfig(al_iters=2, ilqr_iters=4, ilqr_iters_later=3,
                   cost_scale=1e5, constraint_tol=1e-3, n_alpha=4,
                   alpha_decay=0.4, use_kernels=False)


def build(N, batch):
    sc = make_scenario(1, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=N,
                       solver_config=CFG)
    rng = np.random.default_rng(0)
    x0 = np.array([4.45, 5.06, -np.pi, 0, 0, 0, -np.pi / 4, -np.pi, np.pi])
    x0_b = np.clip(x0[None] + rng.standard_normal((batch, 9)) * np.array(
        [0.05, 0.05, 0.02, 0.01, 0.01, 0.01, 0.05, 0.05, 0.05]),
        mpc.xlim[0], mpc.xlim[1])
    q_target = np.array([0.3, -1.0, 1.0])
    traj = np.linspace(x0, np.concatenate([x0[:6], q_target]), N + 1)
    params = dict(mpc.make_params(traj, np.zeros((N, 5))),
                  U_last=jnp.zeros((N, 5), jnp.float32))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    return (mpc, jnp.asarray(x0_b, jnp.float32),
            jnp.zeros((batch, N, 5), jnp.float32), params)


def timeit(fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out.U)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out.U)
    return (time.perf_counter() - t0) / reps * 1e3, out


def main():
    from mmmpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    print(f"device={jax.devices()[0]} batch={batch} "
          f"iters={CFG.al_iters}x({CFG.ilqr_iters},{CFG.ilqr_iters_later})")
    for N in (20, 100, 500, 2000):
        mpc, x0_b, U0_b, params = build(N, batch)
        row = [f"N={N:5d}"]
        for assoc in (False, True):
            cfg = dataclasses.replace(CFG, use_assoc_scan=assoc)
            fn = jax.jit(lambda x0, U0, c=cfg: al_ilqr_solve_batched(
                mpc.ocp, x0, U0, params, c))
            ms, out = timeit(fn, x0_b, U0_b)
            conv = float(jnp.mean(out.converged.astype(jnp.float32)))
            row.append(f"{'assoc' if assoc else 'scan '}: {ms:9.1f} ms "
                       f"(conv {conv*100:4.0f}%)")
        print("  ".join(row), flush=True)


if __name__ == "__main__":
    main()
