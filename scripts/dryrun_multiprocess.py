"""TRUE multi-process validation of the multi-host path (parallel/multihost):
two OS processes, each owning 4 virtual CPU devices, coordinated by
jax.distributed — the same bootstrap, global mesh, host-local data feeding and
in-program psum/pmax reductions a 2-host deployment uses, with the
cross-process collectives actually executing (over the local gRPC transport
standing in for the network between hosts).

Run:  python scripts/dryrun_multiprocess.py          (spawns both workers)
      ... exits 0 and prints PASS if both processes agree with the
      single-process vmap oracle.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = int(os.environ.get("MMMPC_MP_PORT", "18923"))
NPROC = 2
DEV_PER_PROC = 4


def worker(process_id: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from mmmpc_tpu.parallel import sharded_solve_fn
    from mmmpc_tpu.parallel.multihost import (
        global_data_mesh, host_local_batch, init_distributed,
        process_batch_slice,
    )

    assert init_distributed(f"localhost:{PORT}", NPROC, process_id)
    assert jax.process_count() == NPROC
    assert len(jax.local_devices()) == DEV_PER_PROC
    assert len(jax.devices()) == NPROC * DEV_PER_PROC

    from mmmpc_tpu.controllers import MPCBase
    from mmmpc_tpu.models.obstacles import Obstacles
    from mmmpc_tpu.models.robots import Base
    from mmmpc_tpu.utils.configs import SolverConfig

    N, B = 8, 32
    mpc = MPCBase(Base(0.1), [Obstacles(1.0, 0.05, 0.3)], N=N,
                  solver_config=SolverConfig(al_iters=3, ilqr_iters=6))
    traj = np.linspace(np.zeros(6), np.array([2.0, 0, 0, 0, 0, 0]), N + 1)
    params = dict(mpc.make_params(traj, np.zeros((N, 2))),
                  U_last=jnp.zeros((N, 2)))

    # deterministic global batch; every process derives the same one and
    # feeds only its own slice
    rng = np.random.default_rng(7)
    x0_g = rng.standard_normal((B, 6)) * 0.1
    U0_g = np.zeros((B, N, 2))
    local, off = process_batch_slice(B)
    mesh = global_data_mesh()
    x0_s, U0_s = host_local_batch(
        mesh, (x0_g[off:off + local], U0_g[off:off + local]))

    run = sharded_solve_fn(mpc.solve_fn(), mesh)
    res, stats = run(x0_s, U0_s, params)
    jax.block_until_ready(res.U)

    # stats were psum/pmax-reduced across processes inside the program
    assert float(stats.n_solved) == B, float(stats.n_solved)

    # local shard must match the single-(virtual)device oracle bit-for-bit
    U_local = np.asarray(
        jax.experimental.multihost_utils.process_allgather(res.U,
                                                           tiled=True))
    from mmmpc_tpu.parallel import batched_solve_fn
    res_ref, _ = jax.jit(batched_solve_fn(mpc.solve_fn()))(
        jnp.asarray(x0_g), jnp.asarray(U0_g), params)
    np.testing.assert_allclose(U_local.reshape(B, N, 2),
                               np.asarray(res_ref.U), atol=1e-10)
    print(f"process {process_id}: OK (n_solved={int(stats.n_solved)}, "
          f"global devices={len(jax.devices())})", flush=True)


def main() -> int:
    env = dict(os.environ)
    procs = [
        subprocess.Popen([sys.executable, __file__, "--worker", str(i)],
                         env=env, cwd=REPO)
        for i in range(NPROC)
    ]
    rcs = [p.wait(timeout=900) for p in procs]
    if any(rcs):
        print("FAIL", rcs)
        return 1
    print("PASS: 2-process x 4-device global mesh, cross-process "
          "collectives executed")
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--worker") + 1]))
    else:
        sys.exit(main())
