"""Fleet task benchmark: thousands of FULL move->press-button tasks running
concurrently in one compiled on-device loop (sim/batch_task_engine.py).

The reference completes one task per process in ~70 host-driven control ticks
with one IPOPT solve each (interface_wholebody_qref.py:65-143).  Here the
whole fleet's task FSMs, solves, IK and plant steps advance together per tick;
the metric is task completion rate + fleet tick throughput.

Run on the GPU:  python scripts/bench_fleet_tasks.py [batch] [scenario]
"""

import json
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
from mmmpc_tpu.sim.batch_task_engine import PHASE_DONE, make_batch_task_loop
from mmmpc_tpu.utils.configs import SolverConfig, make_scenario

# the host Interface's default budget: the task FSM's phase switches
# (terminal-equality activation ~1.5 m out, rotate weight jolt) need the
# full schedule; the lean RT schedule leaves >1 violations at those ticks
CFG = SolverConfig(al_iters=6, ilqr_iters=12, cost_scale=1e5,
                   constraint_tol=1e-3, n_alpha=3, alpha_decay=0.35)
# N=20 is the reference demo horizon (demo_wholebody_qref.py:11); the
# FSM's terminal equality activates up to ~2.8 m out (interface:155-167),
# which a 1 s horizon cannot reach -- N=10 is only feasible for the nearby
# scenario-0 target (tests/test_task_engine.py).  The host Interface needs
# 192 ticks for scenario 1 (most of it the rotate phase settling the
# reference's brittle 1 cm / 0.5 deg exit tolerances); 280 gives the fleet's
# jittered stragglers headroom
N = 20
N_TICKS = 400
CHUNK = 40                    # ticks per XLA execution (transport-bounded)


def main():
    from mmmpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    # --relax: opt-in straggler recovery (aim-at-button rotate target +
    # 5 cm exit position tolerance; yaw tolerance stays 0.5 deg) for
    # deployments that prefer completion over host-bug parity.  See the
    # make_batch_task_loop docstring for why a blanket tolerance relaxation
    # is NOT safe (measured 42% completion).
    relax = "--relax" in sys.argv
    global N_TICKS, CFG
    # --al= / --ilqr= / --ilqr-later=: reduced warm-started budgets (the
    # engine carries primal+dual warm starts across ticks, so most ticks
    # should not need the cold-start schedule)
    budget = {}
    for a in sys.argv[1:]:
        if a.startswith("--al="):
            budget["al_iters"] = int(a.split("=")[1])
        elif a.startswith("--ilqr="):
            budget["ilqr_iters"] = int(a.split("=")[1])
        elif a.startswith("--ilqr-later="):
            budget["ilqr_iters_later"] = int(a.split("=")[1])
    if "--no-kernel" in sys.argv:
        # attribution lane: force the vmapped per-scenario solver to
        # separate kernel-numerics effects from engine-logic effects on
        # completion
        budget["use_kernels"] = False
    if budget:
        import dataclasses
        CFG = dataclasses.replace(CFG, **budget)
    dump_done = None
    for a in sys.argv[1:]:
        if a.startswith("--dump-done="):
            # per-robot done_at dump (npz) — feeds the host-parity
            # individual-level comparison (scripts/host_fleet_parity.py)
            dump_done = a.split("=", 1)[1]
    for a in sys.argv[1:]:
        if a.startswith("--ticks="):
            t = int(a.split("=")[1])
            # round UP to a CHUNK multiple (never to 0 — a floor of t<CHUNK
            # would skip the loop entirely and crash on the unbound log)
            N_TICKS = max(CHUNK, (t + CHUNK - 1) // CHUNK * CHUNK)
            if N_TICKS != t:
                print(f"--ticks={t} rounded to {N_TICKS} "
                      f"(multiple of CHUNK={CHUNK})", file=sys.stderr)
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    batch = int(args[0]) if args else 1024
    scenario = int(args[1]) if len(args) > 1 else 1
    sc = make_scenario(scenario, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=N,
                       solver_config=CFG)
    shared = mpc.make_params(np.zeros((N + 1, 9)), np.zeros((N, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    shared = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), shared)

    # Parity mode pins the solver to the host-parity vmapped path by
    # default (the lanes path lands the brittle rotate-exit gates at a
    # different knife-edge point).  Recovery mode runs the fast lanes path —
    # its re-aim/re-approach machinery retires the gate sensitivity.
    # --lanes forces the fast path in parity mode to measure that trade.
    host_parity = (not relax) and "--lanes" not in sys.argv
    loop_kw = (dict(rotate_exit_pos_tol=0.05, aim_at_button=True)
               if relax else {})
    loop_kw["host_parity_solver"] = host_parity
    loop = make_batch_task_loop(
        mpc.ocp, CFG, shared, t_move=sc.t_move, t_manipulate=sc.t_manipulate,
        dt=sc.dt, n_ticks=CHUNK, ik_iters=40, **loop_kw)
    if len(jax.devices()) > 1:
        # fleet scale-out: shard robots over the data mesh (embarrassingly
        # parallel; the chunk carry stays sharded across segments)
        from mmmpc_tpu.parallel import make_mesh, sharded_task_loop_fn
        run = sharded_task_loop_fn(loop, make_mesh())
    else:
        run = jax.jit(loop)

    rng = np.random.default_rng(0)
    x0 = np.tile(sc.x_start, (batch, 1)).astype(np.float32)
    # joint-space jitter (base jitter strands the reference's brittle
    # 1 cm / 0.5 deg rotate-phase exit tolerances — host-Interface parity,
    # see tests/test_task_engine.py)
    x0[:, 6:] += (0.05 * rng.standard_normal((batch, 3))).astype(np.float32)
    gpt = np.tile(np.asarray(sc.global_pose_target, np.float32), (batch, 1))

    x0_j, gpt_j = jnp.asarray(x0), jnp.asarray(gpt)
    log, _ = run(x0_j, gpt_j)          # compile + warm up one chunk
    jax.block_until_ready(log.X)

    t0 = time.perf_counter()
    carry = None
    phases = []
    viol_max = 0.0
    worst_log = None
    for _ in range(N_TICKS // CHUNK):
        log, carry = run(x0_j, gpt_j, carry) if carry is not None \
            else run(x0_j, gpt_j)
        phases.append(np.asarray(log.phase))
        chunk_max = float(np.max(np.asarray(log.violation)))
        if worst_log is None or chunk_max > viol_max:
            worst_log = log
        viol_max = max(viol_max, chunk_max)
    jax.block_until_ready(log.X)
    dt_wall = time.perf_counter() - t0

    # failure forensics (reference mpc_wholebody_qref.py:318-326): dump the
    # worst robots of the worst chunk when any tick violated the tolerance
    if viol_max > CFG.constraint_tol:
        from mmmpc_tpu.utils.debugging import report_rollout_failures
        report_rollout_failures(worst_log,
                                constraint_tol=CFG.constraint_tol, top_k=3)

    phase_t = np.concatenate(phases, axis=1)           # (B, N_TICKS)
    done = phase_t[:, -1] == PHASE_DONE
    done_mask = phase_t == PHASE_DONE
    done_at = np.where(done_mask.any(axis=1),
                       done_mask.argmax(axis=1), N_TICKS).astype(float)
    if dump_done:
        np.savez(dump_done, done=done, done_at=done_at,
                 final_phase=phase_t[:, -1])
    print(json.dumps({
        "scenario": scenario,
        "mode": ("relaxed-exit" if relax
                 else "parity" if host_parity else "parity-lanes"),
        "budget": f"al={CFG.al_iters} ilqr={CFG.ilqr_iters}"
                  f"/{CFG.ilqr_iters_later or CFG.ilqr_iters}",
        "batch": batch, "n_ticks": N_TICKS,
        "horizon": N, "wall_s": round(dt_wall, 3),
        "completion_rate": round(float(done.mean()), 4),
        "median_done_tick": float(np.median(done_at[done]))
        if done.any() else None,
        "robot_ticks_per_s": round(batch * N_TICKS / dt_wall, 1),
        "fleet_tick_ms": round(dt_wall / N_TICKS * 1e3, 2),
        "max_violation": viol_max,
    }, ), flush=True)


if __name__ == "__main__":
    main()
