"""Natively-batched solver equivalence vs vmap(al_ilqr_solve).

Runs the lanes path (the fused forward kernel in interpreter mode) on the
CPU and checks it lands on the same solutions as the per-scenario path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmmpc_tpu.controllers import MPCWholeBody
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import MobileManipulator
from mmmpc_tpu.solver import al_ilqr_solve, al_ilqr_solve_batched
from mmmpc_tpu.solver.batched import solve_batched_lanes
from mmmpc_tpu.utils.configs import SolverConfig


@pytest.fixture()
def problem():
    N = 5
    cfg = SolverConfig(al_iters=3, ilqr_iters=5)
    mpc = MPCWholeBody(MobileManipulator(0.1), [Obstacles(1.0, 0.2, 0.3)],
                       [], N=N, solver_config=cfg)
    rng = np.random.default_rng(4)
    B = 64
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
    x0_b = jnp.asarray(
        x0[None] + 0.02 * rng.standard_normal((B, 9))
        * np.array([1, 1, 0.2, 0, 0, 0, 0.1, 0.1, 0.1]))
    U0_b = jnp.zeros((B, N, 5))
    target = np.concatenate([[0.5, 0.1, 0, 0, 0, 0], x0[6:]])
    traj = jnp.asarray(np.linspace(x0, target, N + 1))
    params = dict(mpc.make_params(traj, np.zeros((N, 5))),
                  U_last=jnp.zeros((N, 5)))
    return mpc, cfg, x0_b, U0_b, params


def test_batched_matches_vmap(problem):
    mpc, cfg = problem[:2]
    # float32 on both sides: the kernel computes in float32
    x0_b, U0_b, params = jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), problem[2:])

    # reference: per-scenario vmap path (on a small slice for speed)
    S = 8
    res_ref = jax.vmap(
        lambda x0, U0: al_ilqr_solve(mpc.ocp, x0, U0, params, cfg))(
            x0_b[:S], U0_b[:S])

    # the lanes path on CPU via the interpreter
    res_b = solve_batched_lanes(mpc.ocp, x0_b, U0_b, params, cfg,
                                interpret=True)

    np.testing.assert_allclose(np.asarray(res_b.U[:S]),
                               np.asarray(res_ref.U), atol=5e-5)
    np.testing.assert_allclose(np.asarray(res_b.cost[:S]),
                               np.asarray(res_ref.cost), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(res_b.max_violation[:S]),
                               np.asarray(res_ref.max_violation), atol=1e-5)


def test_batched_fallback_is_vmap(problem):
    mpc, cfg, x0_b, U0_b, params = problem
    # on the CPU the batched entry point is the vmap path: same results
    S = 6
    res_fb = al_ilqr_solve_batched(mpc.ocp, x0_b[:S], U0_b[:S], params, cfg)
    res_ref = jax.vmap(
        lambda x0, U0: al_ilqr_solve(mpc.ocp, x0, U0, params, cfg))(
            x0_b[:S], U0_b[:S])
    np.testing.assert_allclose(np.asarray(res_fb.U), np.asarray(res_ref.U),
                               atol=1e-12)
