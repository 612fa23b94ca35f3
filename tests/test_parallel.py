"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmmpc_tpu.controllers import MPCWholeBody
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import MobileManipulator
from mmmpc_tpu.parallel import batched_solve_fn, make_mesh, sharded_solve_fn
from mmmpc_tpu.utils.configs import SolverConfig


@pytest.fixture(scope="module")
def small_mpc():
    robot = MobileManipulator(0.1)
    return MPCWholeBody(robot, [Obstacles(1.0, 0.3, 0.3)], [], N=5,
                        solver_config=SolverConfig(al_iters=2, ilqr_iters=4))


def _problem(mpc, B):
    rng = np.random.default_rng(3)
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
    x0_b = jnp.asarray(x0[None] + 0.02 * rng.standard_normal((B, 9))
                       * np.array([1, 1, 0.2, 0, 0, 0, 0.1, 0.1, 0.1]))
    U0_b = jnp.zeros((B, mpc.N, 5))
    target = np.concatenate([[0.5, 0.1, 0, 0, 0, 0], x0[6:]])
    traj = jnp.asarray(np.linspace(x0, target, mpc.N + 1))
    params = dict(mpc.make_params(traj, np.zeros((mpc.N, 5))),
                  U_last=jnp.zeros((mpc.N, 5)))
    return x0_b, U0_b, params


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_solve_matches_vmap(small_mpc):
    """shard_map over 8 virtual devices must produce exactly the same
    solutions as plain vmap on one device."""
    B = 16
    x0_b, U0_b, params = _problem(small_mpc, B)

    run_local = jax.jit(batched_solve_fn(small_mpc.solve_fn()))
    res_local, stats_local = run_local(x0_b, U0_b, params)

    mesh = make_mesh()
    run_sharded = sharded_solve_fn(small_mpc.solve_fn(), mesh)
    res_sharded, stats = run_sharded(x0_b, U0_b, params)

    np.testing.assert_allclose(np.asarray(res_sharded.U),
                               np.asarray(res_local.U), atol=1e-10)
    assert float(stats.n_solved) == B
    np.testing.assert_allclose(float(stats.mean_cost),
                               float(stats_local.mean_cost), rtol=1e-10)
    np.testing.assert_allclose(float(stats.max_violation),
                               float(stats_local.max_violation), atol=1e-10)


def test_graft_entry_single():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    u0, cost, viol = jax.jit(fn)(*args)
    assert u0.shape == (5,)
    assert np.isfinite(float(cost))


def test_graft_entry_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_sharded_with_batch_impl(small_mpc):
    """sharded_solve_fn with the natively-batched per-shard implementation
    (the multi-chip bench path) matches the plain vmap shard path."""
    B = 16
    x0_b, U0_b, params = _problem(small_mpc, B)
    mesh = make_mesh()
    run_vmap = sharded_solve_fn(small_mpc.solve_fn(), mesh)
    run_impl = sharded_solve_fn(small_mpc.solve_fn(), mesh,
                                batch_impl=small_mpc.batch_solve_fn())
    res_a, stats_a = run_vmap(x0_b, U0_b, params)
    res_b, stats_b = run_impl(x0_b, U0_b, params)
    np.testing.assert_allclose(np.asarray(res_a.U), np.asarray(res_b.U),
                               atol=1e-10)
    np.testing.assert_allclose(float(stats_a.mean_cost),
                               float(stats_b.mean_cost), rtol=1e-10)


def test_sharded_lanes_kernel_path():
    """The multi-card bench configuration — shard_map over the mesh with the
    batch-minor lanes solver (fused forward kernel) per shard — must execute
    and match the vmap path.  The kernel runs in Pallas interpreter mode."""
    from mmmpc_tpu.solver.batched import solve_batched_lanes

    N = 5
    cfg = SolverConfig(al_iters=1, ilqr_iters=2, n_alpha=2, alpha_decay=0.4,
                       cost_scale=1e5)
    robot = MobileManipulator(0.1)
    mpc = MPCWholeBody(robot, [Obstacles(1.0, 0.3, 0.3)], [], N=N,
                       solver_config=cfg)
    n_dev = len(jax.devices())
    B = 32 * n_dev
    rng = np.random.default_rng(5)
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
    f32 = jnp.float32
    x0_b = jnp.asarray(x0[None] + 0.02 * rng.standard_normal((B, 9))
                       * np.array([1, 1, 0.2, 0, 0, 0, 0.1, 0.1, 0.1]), f32)
    U0_b = jnp.zeros((B, N, 5), f32)
    target = np.concatenate([[0.5, 0.1, 0, 0, 0, 0], x0[6:]])
    traj = jnp.asarray(np.linspace(x0, target, N + 1), f32)
    params = dict(mpc.make_params(traj, np.zeros((N, 5))),
                  U_last=jnp.zeros((N, 5), f32))
    params = jax.tree.map(lambda a: jnp.asarray(a, f32), params)

    mesh = make_mesh()
    run_lanes = sharded_solve_fn(
        mpc.solve_fn(), mesh,
        batch_impl=lambda x, u, p: solve_batched_lanes(
            mpc.ocp, x, u, p, cfg, interpret=True))
    res, stats = run_lanes(x0_b, U0_b, params)
    assert res.U.shape == (B, N, 5)
    assert float(stats.n_solved) == B

    # the vmap path on the same problem as the oracle
    S = 96
    run_vmap = jax.jit(batched_solve_fn(mpc.solve_fn()))
    res_ref, _ = run_vmap(x0_b[:S], U0_b[:S], params)
    np.testing.assert_allclose(np.asarray(res.U[:S]),
                               np.asarray(res_ref.U), atol=5e-4)
    np.testing.assert_allclose(np.asarray(res.cost[:S]),
                               np.asarray(res_ref.cost), rtol=5e-4)


def test_sharded_task_loop_matches_single_device(small_mpc):
    """The sharded fleet task engine (parallel/data_parallel.py::
    sharded_task_loop_fn) must produce exactly the single-device task log —
    robots are embarrassingly parallel, so sharding may not perturb the
    phase FSM, IK, or warm-start carry."""
    from mmmpc_tpu.parallel import sharded_task_loop_fn
    from mmmpc_tpu.sim.batch_task_engine import make_batch_task_loop
    from mmmpc_tpu.utils.configs import make_scenario

    sc = make_scenario(0, N=5)
    shared = small_mpc.make_params(np.zeros((6, 9)), np.zeros((5, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    cfg = SolverConfig(al_iters=1, ilqr_iters=3, n_alpha=2)
    loop = make_batch_task_loop(
        small_mpc.ocp, cfg, shared, t_move=sc.t_move,
        t_manipulate=sc.t_manipulate, dt=sc.dt, n_ticks=3, ik_iters=4)

    B = 16
    rng = np.random.default_rng(7)
    x0 = np.tile(np.asarray(sc.x_start), (B, 1))
    x0[:, 6:] += 0.02 * rng.standard_normal((B, 3))
    gpt = np.tile(np.asarray(sc.global_pose_target), (B, 1))
    x0_j, gpt_j = jnp.asarray(x0), jnp.asarray(gpt)

    log1, carry1 = jax.jit(loop)(x0_j, gpt_j)
    run_sh = sharded_task_loop_fn(loop, make_mesh())
    log8, carry8 = run_sh(x0_j, gpt_j)

    np.testing.assert_allclose(np.asarray(log8.X), np.asarray(log1.X),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(log8.phase),
                                  np.asarray(log1.phase))
    np.testing.assert_allclose(np.asarray(log8.U), np.asarray(log1.U),
                               atol=1e-6)

    # chunked continuation through the SHARDED carry == single-device carry
    log1b, _ = jax.jit(loop)(x0_j, gpt_j, carry1)
    log8b, _ = run_sh(x0_j, gpt_j, carry8)
    np.testing.assert_allclose(np.asarray(log8b.X), np.asarray(log1b.X),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(log8b.phase),
                                  np.asarray(log1b.phase))
