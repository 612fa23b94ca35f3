"""CPU fleet-completion diagnostic at small batch: final-phase histogram of
failures for parity vs recovery configs (used to decompose the straggler
population without spending GPU time).

    python scripts/fleet_diag_cpu.py [batch] [--relax]
"""

import collections
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmmpc_tpu.controllers import MPCWholeBody  # noqa: E402
from mmmpc_tpu.models.obstacles import Obstacles  # noqa: E402
from mmmpc_tpu.models.robots import MobileManipulator  # noqa: E402
from mmmpc_tpu.sim.batch_task_engine import (  # noqa: E402
    PHASE_DONE, make_batch_task_loop,
)
from mmmpc_tpu.utils.configs import SolverConfig, make_scenario  # noqa: E402

N = 20
CFG = SolverConfig(al_iters=6, ilqr_iters=12, cost_scale=1e5,
                   constraint_tol=1e-3, n_alpha=3, alpha_decay=0.35)


def main():
    relax = "--relax" in sys.argv
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    batch = int(args[0]) if args else 128
    sc = make_scenario(1, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=N,
                       solver_config=CFG)
    shared = mpc.make_params(np.zeros((N + 1, 9)), np.zeros((N, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    shared = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), shared)

    loop_kw = (dict(rotate_exit_pos_tol=0.05, aim_at_button=True)
               if relax else {})
    run = jax.jit(make_batch_task_loop(
        mpc.ocp, CFG, shared, t_move=sc.t_move,
        t_manipulate=sc.t_manipulate, dt=sc.dt, n_ticks=40, ik_iters=40,
        **loop_kw))
    rng = np.random.default_rng(0)
    x0 = np.tile(sc.x_start, (batch, 1)).astype(np.float32)
    x0[:, 6:] += (0.05 * rng.standard_normal((batch, 3))).astype(np.float32)
    gpt = np.tile(np.asarray(sc.global_pose_target, np.float32), (batch, 1))
    x0_j, gpt_j = jnp.asarray(x0), jnp.asarray(gpt)
    carry = None
    phases, Xs = [], []
    for i in range(10):
        log, carry = (run(x0_j, gpt_j, carry) if carry is not None
                      else run(x0_j, gpt_j))
        phases.append(np.asarray(log.phase))
        Xs.append(np.asarray(log.X[:, 1:]))
        print(f"chunk {i} done", flush=True)
    ph = np.concatenate(phases, axis=1)
    X = np.concatenate(Xs, axis=1)
    final = ph[:, -1]
    print(f"mode={'relax' if relax else 'parity'} batch={batch}")
    print("final phase histogram:", collections.Counter(final.tolist()))
    bad = np.flatnonzero(final != PHASE_DONE)
    print(f"completion {1 - len(bad) / batch:.4f}; failing: {bad.tolist()}")
    for b in bad[:8]:
        t_hist = collections.Counter(ph[b].tolist())
        print(f"b={b} phase-time {dict(t_hist)} final x={X[b, -1].round(3)}")


if __name__ == "__main__":
    main()
