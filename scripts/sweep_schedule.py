"""Iteration-schedule sweep for the flagship cold-start benchmark.

The production schedule (8 AL rounds x (20 first / 12 later), 3 line-search
candidates at decay 0.35) was swept in round 2; the round-5 kernel op-count
reductions (incremental trig, divide-free Cholesky) changed the per-
iteration cost, so the cheapest 100%-converging schedule may have moved.
Total inner iterations multiply throughput directly — this sweep is the
FLOP-count lever the measured-roofline leaves open.

Run on the GPU:  python scripts/sweep_schedule.py [batch]
One JSON line per schedule; pick the fastest row with converged_frac 1.0
and max_violation under the 1e-3 tolerance.
"""

import dataclasses
import json
import sys
import time
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# (al_iters, first, later, final, n_alpha, alpha_decay)
SCHEDULES = [
    (8, 20, 12, None, 3, 0.35),    # production (round 2 sweep winner)
    (7, 20, 12, None, 3, 0.35),
    (8, 18, 10, None, 3, 0.35),
    (7, 18, 10, 12, 3, 0.35),
    (6, 20, 12, 16, 3, 0.35),
    (8, 16, 10, None, 3, 0.35),
    (8, 20, 10, 12, 3, 0.35),
    (8, 20, 12, None, 2, 0.3),
    (6, 18, 12, 16, 3, 0.35),
    (7, 16, 10, 14, 3, 0.35),
]


def main():
    from mmmpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py"))
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)
    from mmmpc_tpu.parallel import controller_batched_fn

    for al, first, later, final, n_alpha, decay in SCHEDULES:
        cfg = dataclasses.replace(
            bm.SOLVER_CFG, al_iters=al, ilqr_iters=first,
            ilqr_iters_later=later, ilqr_iters_final=final,
            n_alpha=n_alpha, alpha_decay=decay)
        mpc, x0_b, U0_b, params = bm.build_problem(batch)
        mpc.solver_config = cfg
        run = jax.jit(controller_batched_fn(mpc))
        res, stats = run(x0_b, U0_b, params)
        jax.block_until_ready(res.U)
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            res, stats = run(x0_b, U0_b, params)
        jax.block_until_ready(res.U)
        dt = time.perf_counter() - t0
        iters = first + (al - 2) * later + (final or later) if al >= 2 \
            else first
        print(json.dumps({
            "schedule": f"{al}x({first},{later}"
                        f"{',' + str(final) if final else ''}) "
                        f"a{n_alpha}@{decay}",
            "iters": iters,
            "solves_per_s": round(batch * reps / dt, 1),
            "converged_frac": float(stats.n_converged) / float(
                stats.n_solved),
            "max_violation": float(stats.max_violation),
        }), flush=True)


if __name__ == "__main__":
    main()
