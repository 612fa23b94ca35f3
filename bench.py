"""Headline benchmark: whole-body qref MPC solves/s on the GPU.

Run from the root of a checkout:  python bench.py
It uses every visible card (the per-card batch is held constant) and exits
non-zero when JAX finds no GPU.  It prints the card's name and power limit,
the device and a stats line to stderr, then ONE JSON line to stdout:
    {"metric": "wholebody_qref_solves_per_s", "value": N, "unit": "solves/s",
     "vs_baseline": R}

Baseline semantics: the reference publishes no throughput numbers
(BASELINE.md); its implied budget is one IPOPT solve per dt = 0.1 s control
period => 10 solves/s sustained on CPU.  vs_baseline = our solves/s / 10.

The benchmark solves the flagship problem (N=20 horizon, scenario-1
constraint stack: 3 ground circles, 3 half-planes, self-collision spheres,
state/input/rate boxes) for a batch of perturbed scenarios with the default
production solver config, in float32, entirely on-device.  Convergence
statistics are reported to stderr so throughput can't silently be bought
with unconverged solves.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from mmmpc_tpu.controllers import MPCWholeBody
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import MobileManipulator
from mmmpc_tpu.utils.configs import SolverConfig, make_scenario

N = 20
# Scenarios per card: the batch amortizes each iteration's fixed costs
# (kernel launches, selection).  Held constant per card when sharding.
BATCH = 8192
REPS = 10
# cost_scale keeps the ~1e5-magnitude objective inside float32 mantissa;
# constraint_tol 1e-3 (on states of magnitude ~5 m / rad) is the float32
# convergence floor.  3 line-search candidates at decay 0.35.
# Production is the TWO-STAGE solve (solver/refine.py, swept by
# scripts/sweep_refine.py): stage 1 runs the whole batch at 5 AL rounds x
# (16 first / 10 later / 12 final) = 58 iterations — every single-stage
# schedule this cheap leaves a 0.1-5% unconverged tail — then stage 2
# re-solves the 1024 worst scenarios warm-started with the AL penalty
# schedule continued for 3x12 more rounds and merges back
# violation-monotonically.
SOLVER_CFG = SolverConfig(al_iters=5, ilqr_iters=16, ilqr_iters_later=10,
                          ilqr_iters_final=12,
                          cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                          alpha_decay=0.35, scan_unroll=10)
REFINE_ROUNDS, REFINE_SWEEPS = 3, 12


def build_problem(batch):
    sc = make_scenario(1, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    robot = MobileManipulator(sc.dt)
    mpc = MPCWholeBody(robot, obstacles, hp, N=N, solver_config=SOLVER_CFG)

    rng = np.random.default_rng(0)
    # perturbed manipulate-phase starts near the table (the hard regime:
    # every constraint family active)
    x0 = np.array([4.45, 5.06, -np.pi, 0, 0, 0, -np.pi / 4, -np.pi, np.pi])
    jitter = rng.standard_normal((batch, 9)) * np.array(
        [0.05, 0.05, 0.02, 0.01, 0.01, 0.01, 0.05, 0.05, 0.05])
    x0_b = np.clip(x0[None] + jitter, mpc.xlim[0], mpc.xlim[1])
    q_target = np.array([0.3, -1.0, 1.0])
    traj = np.linspace(x0, np.concatenate([x0[:6], q_target]), N + 1)
    u_ref = np.zeros((N, 5))
    params = dict(mpc.make_params(traj, u_ref),
                  U_last=jnp.zeros((N, 5), jnp.float32))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    return (mpc, jnp.asarray(x0_b, jnp.float32),
            jnp.zeros((batch, N, 5), jnp.float32), params)


def main():
    import shutil
    import subprocess

    from mmmpc_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" or shutil.which("nvidia-smi") is None:
        sys.exit(f"bench.py: needs an NVIDIA GPU; JAX's first device is "
                 f"{dev.platform!r}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, file=sys.stderr)
    n_dev = len(jax.devices())
    batch = BATCH * n_dev          # keep per-chip batch constant
    mpc, x0_b, U0_b, params = build_problem(batch)
    from mmmpc_tpu.solver.refine import continue_mu
    refine_cfg = continue_mu(SOLVER_CFG, SOLVER_CFG.al_iters,
                             al_iters=REFINE_ROUNDS,
                             ilqr_iters=REFINE_SWEEPS,
                             ilqr_iters_later=REFINE_SWEEPS,
                             ilqr_iters_final=None)
    if n_dev > 1:
        # shard over all cards; stats reduce inside the program (each
        # shard refines its own worst scenarios)
        from mmmpc_tpu.parallel import make_mesh, sharded_solve_fn
        run = sharded_solve_fn(
            mpc.solve_fn(), make_mesh(),
            batch_impl=mpc.batch_solve_refined_fn(refine_cfg=refine_cfg))
    else:
        from mmmpc_tpu.parallel.data_parallel import _with_stats
        run = jax.jit(_with_stats(
            mpc.batch_solve_refined_fn(refine_cfg=refine_cfg)))

    # compile + warm up
    res, stats = run(x0_b, U0_b, params)
    jax.block_until_ready(res.U)

    t0 = time.perf_counter()
    for _ in range(REPS):
        res, stats = run(x0_b, U0_b, params)
    jax.block_until_ready(res.U)
    dt = time.perf_counter() - t0

    solves_per_s = batch * REPS / dt
    per_solve_latency = dt / REPS  # full-batch latency (all in parallel)

    print(json.dumps({
        "platform": dev.platform, "device_kind": dev.device_kind,
        "n_devices": n_dev, "card": card,
        "batch": batch, "reps": REPS, "horizon": N,
        "batch_latency_s": per_solve_latency,
        "converged_frac": float(stats.n_converged) / float(stats.n_solved),
        "max_violation": float(stats.max_violation),
        "mean_cost": float(stats.mean_cost),
    }), file=sys.stderr)

    # batched failure forensics (reference mpc_wholebody_qref.py:318-326):
    # dump the worst scenarios whenever any of the batch failed to converge
    if float(stats.n_converged) < float(stats.n_solved):
        from mmmpc_tpu.utils.debugging import report_unconverged
        report_unconverged(mpc.ocp, res, params, top_k=3)

    print(json.dumps({
        "metric": "wholebody_qref_solves_per_s",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / 10.0, 1),
    }))


if __name__ == "__main__":
    main()
