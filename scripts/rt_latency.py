"""Real-time receding-horizon latency: warm-started fleet serving.

Measures p50/p99 wall-clock per MPC tick on the GPU, including host round
trips, for a TRUE closed-loop: each tick applies u[0] through the model
plant and re-solves from the advanced state, carrying both primal (shifted
U) and dual (shifted, decayed multipliers) warm starts — the deployment
regime of the framework.

Two shapes:
- single scenario (B=1, pure-JAX scan path) — the classic one-robot loop;
- batch-1024 lanes path (fused forward kernel) — fleet serving.

The RT config (al_iters=3, ilqr_iters=6, later=4) tracks the optimum in a
handful of sweeps because the duals carry over.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import build_problem
from mmmpc_tpu.solver import al_ilqr_solve, shift_multipliers
from mmmpc_tpu.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu.utils.configs import SolverConfig

TICKS = 100
RT_CFG = SolverConfig(al_iters=3, ilqr_iters=6, ilqr_iters_later=4,
                      cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                      alpha_decay=0.35, scan_unroll=10)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def run_loop(solve, step, x0, U0, params, to_ulast, bootstrap=None):
    """Receding-horizon loop: apply u[0], advance the plant, re-solve with
    shifted primal/dual warm starts and U_last = the warm sequence (the
    input-rate constraint is relative to the previous commands, as deployed
    — sim/batch_engine.py semantics).  ``bootstrap`` solves the cold first
    tick at the full offline budget (fleet bring-up), after which the RT
    budget only has to TRACK the optimum."""
    x = x0
    res = (bootstrap or solve)(x, U0, params, None)
    jax.block_until_ready(res.U)
    lat, convs, viols = [], [], []
    for _ in range(TICKS):
        t0 = time.perf_counter()
        x = step(x, res.U)
        U_warm = jnp.concatenate([res.U[..., 1:, :], res.U[..., -1:, :]],
                                 axis=-2)
        lam = shift_multipliers(res.lam_stage, res.lam_term, res.lam_eq)
        p = dict(params, U_last=to_ulast(U_warm))
        res = solve(x, U_warm, p, lam)
        jax.block_until_ready(res.U)
        lat.append(time.perf_counter() - t0)
        convs.append(np.mean(np.asarray(res.converged, dtype=np.float32)))
        viols.append(float(jnp.max(res.max_violation)))
    return lat, convs, viols


def main():
    from mmmpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from bench import SOLVER_CFG as FULL_CFG

    mpc, x0_b, U0_b, params = build_problem(1024)
    ocp = mpc.ocp
    dyn = ocp.dynamics

    single = jax.jit(
        lambda x0, U0, p, lam0: al_ilqr_solve(ocp, x0, U0, p, RT_CFG,
                                              lam0=lam0))
    boot1 = jax.jit(
        lambda x0, U0, p, lam0: al_ilqr_solve(ocp, x0, U0, p, FULL_CFG,
                                              lam0=lam0))
    step1 = jax.jit(lambda x, U: dyn(x, U[0]))
    lat1, conv1, viol1 = run_loop(single, step1, x0_b[0], U0_b[0], params,
                                  lambda U: U, bootstrap=boot1)
    print(f"B=1    p50 {pct(lat1, 50):6.1f} ms  p99 {pct(lat1, 99):6.1f} ms"
          f"  converged={np.mean(conv1)*100:.1f}%"
          f"  max_viol={max(viol1):.2e}")

    batched = jax.jit(
        lambda x0, U0, p, lam0: al_ilqr_solve_batched(ocp, x0, U0, p, RT_CFG,
                                                      lam0_b=lam0))
    bootB = jax.jit(
        lambda x0, U0, p, lam0: al_ilqr_solve_batched(ocp, x0, U0, p,
                                                      FULL_CFG, lam0_b=lam0))
    stepB = jax.jit(jax.vmap(lambda x, U: dyn(x, U[0])))
    # per-scenario U_last rides the kernels batch-minor: (N, nu, B)
    latB, convB, violB = run_loop(batched, stepB, x0_b, U0_b, params,
                                  lambda U: jnp.transpose(U, (1, 2, 0)),
                                  bootstrap=bootB)
    print(f"B=1024 p50 {pct(latB, 50):6.1f} ms  p99 {pct(latB, 99):6.1f} ms"
          f"  mean converged={np.mean(convB)*100:.2f}%"
          f"  min tick converged={np.min(convB)*100:.2f}%"
          f"  max_viol={max(violB):.2e}")


if __name__ == "__main__":
    main()
