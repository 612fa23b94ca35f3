"""Batched-throughput benchmark for EVERY MPC formulation, not just the
flagship qref controller.

The qref controller has dedicated fused Pallas kernels; the others run the
natively-batched scan solver (the vmap/batched path).  This script publishes
solves/s + convergence for each so "matches or beats the reference" is
evidenced per formulation (reference controllers/: mpc_demo, mpc_base,
mpc_manipulator_3DoF, mpc_wholebody, mpc_wholebody_qref + the moving_obs
branch).

Run on the GPU:  python scripts/bench_controllers.py [batch]
"""

import json
import sys
import time
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from mmmpc_tpu.controllers import (
    MPC, MPCBase, MPCManipulator3DoF, MPCWholeBody, MPCWholeBodyEndpoint,
    MPCWholeBodyMovingObs,
)
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import (
    Base, ManipulatorPanda3DoF, MobileManipulator, RobotDemo,
)
from mmmpc_tpu.models.mobile_manipulator import wholebody_fk
from mmmpc_tpu.parallel import controller_batched_fn
from mmmpc_tpu.utils.configs import SolverConfig, make_scenario

DT = 0.1
N = 20
# the flagship production schedule (bench.py); small formulations converge
# well inside it, so one schedule keeps the rows comparable
CFG = SolverConfig(al_iters=8, ilqr_iters=20, ilqr_iters_later=12,
                   cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                   alpha_decay=0.35, scan_unroll=10)
# the tiny formulations don't need the 1e5 cost scale (their costs are O(1))
CFG_SMALL = SolverConfig(al_iters=8, ilqr_iters=20, ilqr_iters_later=12,
                         constraint_tol=1e-3, n_alpha=3, alpha_decay=0.35,
                         scan_unroll=10)


def _wholebody_batch(batch, rng):
    x0 = np.array([4.45, 5.06, -np.pi, 0, 0, 0, -np.pi / 4, -np.pi, np.pi])
    jit = rng.standard_normal((batch, 9)) * np.array(
        [0.05, 0.05, 0.02, 0.01, 0.01, 0.01, 0.05, 0.05, 0.05])
    return x0, x0[None] + jit


def problems(batch):
    """Yield (name, mpc, x0_b, params) per formulation."""
    rng = np.random.default_rng(0)

    # --- 1-D demo (reference controllers/mpc_demo.py)
    demo = MPC(RobotDemo(DT), N=N, solver_config=CFG_SMALL)
    x0d = np.stack([rng.uniform(-2, 2, batch), rng.uniform(-0.5, 0.5, batch)],
                   axis=1)
    trajd = np.linspace([0.0, 0.0], [3.0, 0.0], N + 1)
    yield "demo_1d", demo, x0d, demo.make_params(trajd, np.zeros((N, 1)))

    # --- base-only (reference controllers/mpc_base.py)
    base = MPCBase(Base(DT), [Obstacles(1.2, 0.15, 0.3)], N=N,
                   solver_config=CFG_SMALL)
    x0b = rng.standard_normal((batch, 6)) * np.array(
        [0.1, 0.1, 0.05, 0.02, 0.02, 0.02])
    trajb = np.linspace(np.zeros(6), np.array([2.5, 0.3, 0, 0, 0, 0]), N + 1)
    yield "base_only", base, x0b, base.make_params(trajb, np.zeros((N, 2)))

    # --- arm-only (reference controllers/mpc_manipulator_3DoF.py); wedge
    # obstacle in front of the arm (the test-verified feasible geometry,
    # tests/test_controllers.py::test_manipulator_convex_obstacle_pushes_away)
    arm = MPCManipulator3DoF(
        ManipulatorPanda3DoF(DT),
        [np.array([[1 / np.sqrt(2), 0, 1 / np.sqrt(2)]]),
         np.array([[-1 / np.sqrt(2), 0, 1 / np.sqrt(2)]])],
        np.array([0.0, 0.0, 0.35]), N=N, solver_config=CFG_SMALL)
    q0 = np.array([0.3, -1.2, 1.2])
    x0a = np.clip(q0[None] + rng.standard_normal((batch, 3)) * 0.05,
                  arm.qlim[0] + 1e-3, arm.qlim[1] - 1e-3)
    x0a[:, 1] = np.minimum(x0a[:, 1], -1e-3)
    traja = np.linspace(q0, np.array([0.0, -0.6, 0.9]), N + 1)
    yield "arm_only", arm, x0a, arm.make_params(traja, np.zeros((N, 3)))

    # --- whole-body endpoint-ref (reference controllers/mpc_wholebody.py)
    sc = make_scenario(1, N=N)
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    epc = MPCWholeBodyEndpoint(MobileManipulator(DT), obstacles, N=N,
                               solver_config=CFG)
    # feasible start inside the endpoint controller's (tighter) arm bounds
    # (tests/test_controllers.py::test_wholebody_endpoint_controller)
    x0e = np.zeros(9)
    x0e[6:] = [0.0, -0.6, 0.8]
    x0e_b = x0e[None] + rng.standard_normal((batch, 9)) * np.array(
        [0.05, 0.05, 0.02, 0.0, 0.0, 0.0, 0.03, 0.03, 0.03])
    x0e_b = np.clip(x0e_b, epc.xlim[0] + 1e-3, epc.xlim[1] - 1e-3)
    pose0 = np.asarray(wholebody_fk(jnp.asarray(x0e))[0])
    pose_t = pose0 + np.array([0.3, 0.0, 0.1, 0.0])
    traje = np.linspace(pose0, pose_t, N + 1)
    yield "wholebody_endpoint", epc, x0e_b, epc.make_params(
        traje, np.zeros((N, 5)))

    x0w, x0w_b = _wholebody_batch(batch, rng)

    # --- flagship qref (comparison row; the headline bench.py config)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    qref = MPCWholeBody(MobileManipulator(DT), obstacles, hp, N=N,
                        solver_config=CFG)
    q_target = np.array([0.3, -1.0, 1.0])
    trajq = np.linspace(x0w, np.concatenate([x0w[:6], q_target]), N + 1)
    x0q = np.clip(x0w_b, qref.xlim[0], qref.xlim[1])
    yield "wholebody_qref", qref, x0q, qref.make_params(
        trajq, np.zeros((N, 5)))

    # --- moving-obs (reconstructed moving_obs branch)
    mov = MPCWholeBodyMovingObs(MobileManipulator(DT), obstacles, hp, N=N,
                                solver_config=CFG)
    mov.observe_obstacles(np.asarray(sc.ground_obstacles)[:, :2],
                          np.tile([0.05, 0.02], (len(obstacles), 1)))
    yield "wholebody_moving_obs", mov, x0q, mov.make_params(
        trajq, np.zeros((N, 5)))


def bench_one(name, mpc, x0_b, params, reps=10):
    batch = x0_b.shape[0]
    nu = mpc.ocp.nu
    params = dict(params, U_last=jnp.zeros((N, nu), jnp.float32))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    x0_b = jnp.asarray(x0_b, jnp.float32)
    U0_b = jnp.zeros((batch, N, nu), jnp.float32)
    run = jax.jit(controller_batched_fn(mpc))
    res, stats = run(x0_b, U0_b, params)
    jax.block_until_ready(res.U)
    t0 = time.perf_counter()
    for _ in range(reps):
        res, stats = run(x0_b, U0_b, params)
    jax.block_until_ready(res.U)
    dt = time.perf_counter() - t0
    return {
        "controller": name, "batch": batch, "horizon": N,
        "solves_per_s": round(batch * reps / dt, 1),
        "converged_frac": round(float(stats.n_converged)
                                / float(stats.n_solved), 4),
        "max_violation": float(stats.max_violation),
    }


def main():
    from mmmpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    print(f"device={jax.devices()[0]} batch={batch} horizon={N} "
          f"schedule={CFG.al_iters}x({CFG.ilqr_iters},{CFG.ilqr_iters_later})",
          file=sys.stderr)
    names = set(sys.argv[2:])
    for name, mpc, x0_b, params in problems(batch):
        if names and name not in names:
            continue
        row = bench_one(name, mpc, x0_b, params)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
