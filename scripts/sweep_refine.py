"""Two-stage (cheap schedule + straggler refinement) sweep.

The single-schedule sweep (sweep_schedule.py) showed
the 100%-convergence frontier at 92 iterations: every 80-88-iteration
schedule converges all but a 0.03-0.16% tail.  solver/refine.py re-solves
only that tail (warm-started, mu continued) and merges back
violation-monotonically — so the question this sweep answers is: which
(stage-1 schedule, refine budget) pair maximizes throughput while the
MERGED batch still converges 100%?

Run on the GPU:  python scripts/sweep_refine.py [batch]
One JSON line per config; pick the fastest row with converged_frac 1.0.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from mmmpc_tpu.parallel.data_parallel import _with_stats
from mmmpc_tpu.solver.refine import continue_mu

# stage 1: (al, first, later, final); stage 2: (al_r, iters_r)
# optionally a third element: refine_size (default refine.REFINE_SIZE)
CONFIGS = [
    # single-stage baselines for reference
    ((7, 20, 12, None), None),
    # the sweep-table stragglers, each with a modest refine budget
    ((7, 16, 10, 14), (2, 12)),
    ((7, 18, 10, 12), (2, 12)),
    ((6, 20, 12, 16), (2, 12)),
    ((6, 18, 12, 16), (2, 12)),
    ((8, 18, 10, None), (2, 12)),
    # cheaper stage 1, bigger refine
    ((6, 16, 10, 12), (3, 12)),
    ((6, 14, 8, 12), (3, 12)),
    ((5, 16, 10, 12), (3, 14)),
    ((5, 14, 8, 12), (4, 12)),
]

# round 2: probe around the round-1 winner 5x(16,10,12)+3x14 (204.3k, 1.0)
CONFIGS_R2 = [
    ((5, 16, 10, 12), (2, 12)),          # cheaper refine
    ((5, 16, 10, 12), (3, 12)),
    ((5, 16, 8, 12), (3, 14)),           # 52-iter stage 1
    ((5, 14, 10, 12), (3, 14)),          # 56
    ((4, 18, 10, 12), (4, 14)),          # 50, 4 AL rounds
    ((4, 16, 10, 12), (4, 14)),          # 48
    ((5, 14, 8, 12), (4, 12), 2048),     # 50 + two-tile refine
    ((4, 16, 10, 14), (5, 12), 2048),    # 50 + two-tile refine, more rounds
]


def main():
    from mmmpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    configs = (CONFIGS_R2 if len(sys.argv) > 2 and sys.argv[2] == "r2"
               else CONFIGS)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "benchmod", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py"))
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)

    for entry in configs:
        (al, first, later, final), refine = entry[0], entry[1]
        refine_size = entry[2] if len(entry) > 2 else None
        cfg = dataclasses.replace(
            bm.SOLVER_CFG, al_iters=al, ilqr_iters=first,
            ilqr_iters_later=later, ilqr_iters_final=final)
        mpc, x0_b, U0_b, params = bm.build_problem(batch)
        mpc.solver_config = cfg
        if refine is None:
            run = jax.jit(_with_stats(mpc.batch_solve_fn()))
            rdesc = "none"
        else:
            al_r, it_r = refine
            rcfg = continue_mu(cfg, al, al_iters=al_r, ilqr_iters=it_r,
                               ilqr_iters_later=it_r, ilqr_iters_final=None)
            run = jax.jit(_with_stats(mpc.batch_solve_refined_fn(
                refine_cfg=rcfg, refine_size=refine_size)))
            rdesc = f"{al_r}x{it_r}@{refine_size or 1024}"
        res, stats = run(x0_b, U0_b, params)
        jax.block_until_ready(res.U)
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            res, stats = run(x0_b, U0_b, params)
        jax.block_until_ready(res.U)
        dt = time.perf_counter() - t0
        iters1 = first + (al - 2) * later + (final or later) if al >= 2 \
            else first
        print(json.dumps({
            "stage1": f"{al}x({first},{later}"
                      f"{',' + str(final) if final else ''})",
            "iters1": iters1,
            "refine": rdesc,
            "solves_per_s": round(batch * reps / dt, 1),
            "converged_frac": float(stats.n_converged) / float(
                stats.n_solved),
            "max_violation": float(stats.max_violation),
        }), flush=True)


if __name__ == "__main__":
    main()
