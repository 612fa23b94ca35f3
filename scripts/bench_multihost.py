"""Multi-host benchmark entry point — one process per host.

Launch (same command on every host, distinct JAX_PROCESS_ID):

    JAX_COORDINATOR=host0:12345 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=$RANK \
        python scripts/bench_multihost.py

Single-process it degenerates to bench.py semantics (same solve program),
so the scaling-efficiency comparison 1 card -> 1 host -> >=2 hosts uses one
code path.  Each host feeds only its local slice of the global batch
(parallel/multihost.py::host_local_batch); throughput/convergence stats are
psum/pmax-reduced inside the compiled program, crossing the network when
the mesh does.
"""
import json
import sys
import time
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from bench import BATCH, REPS, build_problem
from mmmpc_tpu.parallel import (
    global_data_mesh, host_local_batch, init_distributed, sharded_solve_fn,
)


def main():
    from mmmpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    distributed = init_distributed()
    mesh = global_data_mesh()
    n_dev = len(jax.devices())
    global_batch = BATCH * n_dev

    # every process builds the same global problem definition, then feeds
    # only its local slice of the batch
    mpc, x0_all, U0_all, params = build_problem(global_batch)
    n_proc = jax.process_count()
    local = global_batch // n_proc
    lo = local * jax.process_index()
    x0_b, U0_b = host_local_batch(
        mesh, (np.asarray(x0_all[lo:lo + local]),
               np.asarray(U0_all[lo:lo + local])))

    run = sharded_solve_fn(mpc.solve_fn(), mesh,
                           batch_impl=mpc.batch_solve_fn())
    res, stats = run(x0_b, U0_b, params)
    jax.block_until_ready(res.U)

    t0 = time.perf_counter()
    for _ in range(REPS):
        res, stats = run(x0_b, U0_b, params)
    jax.block_until_ready(res.U)
    dt = time.perf_counter() - t0
    solves_per_s = global_batch * REPS / dt

    if jax.process_index() == 0:
        print(json.dumps({
            "metric": "wholebody_qref_solves_per_s",
            "value": round(solves_per_s, 1),
            "unit": "solves/s",
            "n_processes": n_proc, "n_devices": n_dev,
            "distributed": distributed,
            "global_batch": global_batch,
            "converged_frac": float(stats.n_converged) / float(stats.n_solved),
            "max_violation": float(stats.max_violation),
        }))


if __name__ == "__main__":
    main()
