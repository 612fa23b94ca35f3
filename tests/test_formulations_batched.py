"""Batched-vs-per-scenario parity for every formulation.

``al_ilqr_solve_batched`` (the entry point the batched controllers, the
fleet engines and the sharded solve call) must land on the same solutions
as the plain per-scenario ``al_ilqr_solve`` for each of the six
formulations, with params shared across the batch and with per-scenario
params (the fleet convention: a trailing batch axis on ``X_ref`` and, where
the formulation reads one, ``U_last``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmmpc_tpu.controllers import (
    MPC, MPCBase, MPCManipulator3DoF, MPCWholeBody, MPCWholeBodyEndpoint,
    MPCWholeBodyMovingObs,
)
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import (
    Base, ManipulatorPanda3DoF, MobileManipulator, RobotDemo,
)
from mmmpc_tpu.solver import al_ilqr_solve, al_ilqr_solve_batched
from mmmpc_tpu.utils.configs import SolverConfig

B, N = 3, 5
CFG = SolverConfig(al_iters=2, ilqr_iters=3, n_alpha=3, alpha_decay=0.4)


def _wholebody_start(rng):
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
    return x0[None] + 0.05 * rng.standard_normal((B, 9)) * np.array(
        [1, 1, 0.5, 0.2, 0.2, 0.2, 0.5, 0.5, 0.5])


def make_problem(name):
    """(ocp, x0_b, U0_b, params, traj) for one formulation; ``traj`` is the
    shared X_ref the per-scenario variant perturbs."""
    rng = np.random.default_rng(0)
    hp = [(np.array([0.8, 0.1, 1.0]), np.array([[1.0, 0.0, 0.0]]))]
    if name == "demo":
        mpc = MPC(RobotDemo(0.1), N=N, solver_config=CFG)
        x0_b = np.stack([rng.uniform(-2, 2, B), rng.uniform(-0.9, 0.9, B)], 1)
        traj = np.linspace([0.0, 0.0], [3.0, 0.0], N + 1)
        params = mpc.make_params(traj, np.zeros((N, 1)))
    elif name == "base":
        mpc = MPCBase(Base(0.1), [Obstacles(1.2, 0.15, 0.3)], N=N,
                      solver_config=CFG)
        x0_b = rng.standard_normal((B, 6)) * np.array(
            [0.3, 0.3, 0.5, 0.1, 0.1, 0.1])
        traj = np.linspace(np.zeros(6), [2.5, 0.3, 0.5, 0, 0, 0], N + 1)
        params = mpc.make_params(traj, np.zeros((N, 2)))
    elif name in ("arm_joint", "arm_cartesian"):
        cart = name == "arm_cartesian"
        mpc = MPCManipulator3DoF(
            ManipulatorPanda3DoF(0.1),
            [np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])],
            np.array([0.45, 0.0, 0.55]), N=N, solver_config=CFG,
            is_cartesian_ref=cart)
        q0 = np.array([0.3, -0.9, 0.8])
        x0_b = np.clip(q0[None] + 0.2 * rng.standard_normal((B, 3)),
                       mpc.qlim[0] + 0.01, mpc.qlim[1] - 0.01)
        traj = (np.linspace([0.4, 0.0, 0.6], [0.5, 0.1, 0.5], N + 1)
                if cart else np.linspace(q0, [0.0, -0.5, 0.5], N + 1))
        params = dict(mpc.make_params(traj, np.zeros((N, 3))),
                      U_last=np.zeros((N, 3)))
    elif name == "endpoint":
        mpc = MPCWholeBodyEndpoint(
            MobileManipulator(0.1), [Obstacles(1.0, 0.2, 0.3)], N=N,
            solver_config=CFG)
        x0_b = _wholebody_start(rng)
        traj = np.linspace([0.3, 0.0, 0.9, 0.0], [0.8, 0.2, 1.1, 0.3], N + 1)
        params = dict(mpc.make_params(traj, np.zeros((N, 5))),
                      U_last=np.zeros((N, 5)))
    elif name in ("qref", "moving_obs"):
        cls = MPCWholeBodyMovingObs if name == "moving_obs" else MPCWholeBody
        mpc = cls(MobileManipulator(0.1), [Obstacles(1.0, 0.2, 0.3)], hp,
                  N=N, solver_config=CFG)
        if name == "moving_obs":
            mpc.observe_obstacles([[1.0, 0.2]], [[-0.3, 0.1]])
        x0_b = _wholebody_start(rng)
        x0 = x0_b[0]
        traj = np.linspace(x0, np.concatenate([[0.5, 0.1, 0, 0, 0, 0],
                                               x0[6:]]), N + 1)
        params = dict(mpc.make_params(traj, np.zeros((N, 5))),
                      U_last=np.zeros((N, 5)))
    else:  # pragma: no cover
        raise ValueError(name)
    U0_b = 0.1 * rng.standard_normal((B, N, mpc.NU))
    return mpc.ocp, jnp.asarray(x0_b), jnp.asarray(U0_b), params, traj


@pytest.mark.parametrize("per_scenario", [False, True],
                         ids=["shared", "per_scenario"])
@pytest.mark.parametrize("name", ["demo", "base", "arm_joint",
                                  "arm_cartesian", "endpoint", "qref",
                                  "moving_obs"])
def test_batched_matches_per_scenario(name, per_scenario):
    ocp, x0_b, U0_b, params, traj = make_problem(name)
    params = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(1)
    if per_scenario:
        # each scenario its own reference window (and previous commands)
        params["X_ref"] = jnp.asarray(
            traj[..., None] + 0.05 * rng.standard_normal(traj.shape + (B,)))
        if "U_last" in params:
            nu = params["U_last"].shape[-1]
            params["U_last"] = jnp.asarray(
                0.1 * rng.standard_normal((N, nu, B)))
    ps = {"X_ref", "U_last"} if per_scenario else set()

    res_b = jax.jit(lambda x, u, p: al_ilqr_solve_batched(
        ocp, x, u, p, CFG))(x0_b, U0_b, params)
    solve_one = jax.jit(lambda x, u, p: al_ilqr_solve(ocp, x, u, p, CFG))
    for i in range(B):
        p_i = {k: (v[..., i] if k in ps else v) for k, v in params.items()}
        res_i = solve_one(x0_b[i], U0_b[i], p_i)
        np.testing.assert_allclose(np.asarray(res_b.U[i]),
                                   np.asarray(res_i.U), atol=1e-9)
        np.testing.assert_allclose(float(res_b.cost[i]),
                                   float(res_i.cost), rtol=1e-9)
        np.testing.assert_allclose(float(res_b.max_violation[i]),
                                   float(res_i.max_violation), atol=1e-9)
    if per_scenario:
        # the per-scenario entries take effect
        shared = dict(params, X_ref=jnp.asarray(traj))
        if "U_last" in shared:
            shared["U_last"] = shared["U_last"][..., 0] * 0.0
        res_s = al_ilqr_solve_batched(ocp, x0_b, U0_b, shared, CFG)
        assert float(jnp.max(jnp.abs(res_s.U - res_b.U))) > 1e-6
