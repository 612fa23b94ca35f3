"""Controller-level tests: each reference controller's JAX re-design solves
its formulation correctly (vs the scipy interior-point oracle) and honors the
reference's protocol quirks (warm starts, weight mutation, clamping)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmmpc_tpu.controllers import (
    MPC, MPCBase, MPCManipulator3DoF, MPCWholeBody, MPCWholeBodyEndpoint,
    MPCWholeBodyMovingObs, predict_obstacle_trajectory,
)
from mmmpc_tpu.models.robots import (
    Base, ManipulatorPanda3DoF, MobileManipulator, RobotDemo,
)
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.utils.configs import SolverConfig, make_scenario
from mmmpc_tpu.verify import lbfgs_solve, scipy_solve

DT = 0.1

OBSTACLES = [Obstacles(2.5, 3.0, 0.6), Obstacles(2.5, 1.0, 0.6),
             Obstacles(5 - 0.6, 5, 0.1)]


def scenario1_halfplanes():
    sc = make_scenario(1)
    return [(sc.hp_points[j], sc.hp_normals[j][None, :]) for j in range(3)]


# ---------------------------------------------------------------- demo


def test_demo_controller_tracks():
    mpc = MPC(RobotDemo(DT), N=10)
    traj = np.stack([np.linspace(0, 1, 11), np.zeros(11)], axis=1)
    u0 = mpc.solve(np.array([0.0, 0.0]), traj, np.zeros((10, 1)))
    assert u0.shape == (1,)
    assert u0[0] > 0.1  # accelerates toward the target
    # warm start is kept between calls
    assert mpc.u_latest is not None


# ---------------------------------------------------------------- base


def test_base_controller_avoids_obstacle_and_matches_oracle():
    robot = Base(DT)
    obstacle = [Obstacles(1.2, 0.1, 0.3)]
    mpc = MPCBase(robot, obstacle, N=12,
                  solver_config=SolverConfig(al_iters=8, ilqr_iters=15))
    x0 = np.zeros(6)
    target = np.array([2.5, 0.0, 0.0, 0, 0, 0])
    traj = np.linspace(x0, target, 13)
    u_ref = np.zeros((12, 2))
    u0 = mpc.solve(x0, traj, u_ref)

    params = dict(mpc.make_params(traj, u_ref), U_last=jnp.zeros((12, 2)))
    U_o, X_o, cost_o, _ = scipy_solve(mpc.ocp, jnp.asarray(x0),
                                      jnp.zeros((12, 2)), params, maxiter=3000)
    res = mpc.last_result
    np.testing.assert_allclose(float(res.cost), cost_o, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(U_o), atol=2e-2)


def test_base_set_weight_changes_solution():
    robot = Base(DT)
    mpc = MPCBase(robot, [], N=8)
    x0 = np.zeros(6)
    traj = np.linspace(x0, np.array([1.0, 0, 0, 0, 0, 0]), 9)
    u1 = mpc.solve(x0, traj, np.zeros((8, 2)))
    mpc.reset()
    mpc.setWeight(R=np.diag([100.0, 100.0]))
    u2 = mpc.solve(x0, traj, np.zeros((8, 2)))
    assert abs(u2[0]) < abs(u1[0])  # heavier input weight => smaller input


# ---------------------------------------------------------------- arm


def test_manipulator_controller_joint_tracking():
    robot = ManipulatorPanda3DoF(DT)
    mpc = MPCManipulator3DoF(robot, [], np.array([]), N=10)
    q0 = np.array([0.0, -0.5, 0.5])
    q_target = np.array([0.3, -1.0, 1.0])
    traj = np.linspace(q0, q_target, 11)
    u0 = mpc.solve(q0, traj, np.zeros((10, 3)))
    assert u0.shape == (3,)
    # moves every joint toward its target
    assert np.all(np.sign(u0) == np.sign(q_target - q0))
    # respects dq limits
    assert np.all(np.abs(u0) <= 1.0 + 1e-9)


def test_manipulator_convex_obstacle_pushes_away():
    robot = ManipulatorPanda3DoF(DT)
    # wedge obstacle straight in front of the arm (arm frame), two faces
    normals = [np.array([[1 / np.sqrt(2), 0, 1 / np.sqrt(2)]]),
               np.array([[-1 / np.sqrt(2), 0, 1 / np.sqrt(2)]])]
    point = np.array([0.0, 0, 0.35])
    free = MPCManipulator3DoF(robot, [], np.array([]), N=10)
    blocked = MPCManipulator3DoF(robot, normals, point, N=10,
                                 solver_config=SolverConfig(al_iters=8,
                                                            ilqr_iters=15))
    q0 = np.array([0.3, -1.2, 1.2])
    traj = np.tile(q0, (11, 1))
    # both must solve; the blocked one pays the obstacle penalty
    free.solve(q0, traj, np.zeros((10, 3)))
    blocked.solve(q0, traj, np.zeros((10, 3)))
    assert float(blocked.last_result.cost) >= float(free.last_result.cost) - 1e-9


# ---------------------------------------------------------------- wholebody


@pytest.fixture(scope="module")
def wb_robot():
    return MobileManipulator(DT)


def test_wholebody_qref_matches_oracle_smooth(wb_robot):
    """Whole-body qref with no active state constraint: the JAX solver must
    match the independent L-BFGS-B oracle on the same objective exactly.
    (scipy trust-constr under-converges on this problem class — see
    test_wholebody_qref_dominates_oracle_constrained — so the smooth-regime
    agreement check uses the quasi-Newton oracle.)"""
    N = 8
    mpc = MPCWholeBody(wb_robot, [Obstacles(5.0, 5.0, 0.4)], [], N=N,
                       solver_config=SolverConfig(al_iters=8, ilqr_iters=20))
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi, np.pi]
    target = np.concatenate([[0.6, 0.15, 0.0, 0, 0, 0], x0[6:]])
    traj = np.linspace(x0, target, N + 1)
    u_ref = np.zeros((N, 5))
    mpc.solve(x0, traj, u_ref)
    res = mpc.last_result
    assert float(res.max_violation) < 1e-8

    params = dict(mpc.make_params(traj, u_ref), U_last=jnp.zeros((N, 5)))
    U_o, X_o, cost_o, sres = lbfgs_solve(
        mpc.ocp, jnp.asarray(x0), jnp.zeros((N, 5)), params)

    np.testing.assert_allclose(float(res.cost), cost_o, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(U_o), atol=1e-3)


def test_wholebody_qref_dominates_oracle_constrained(wb_robot):
    """Whole-body qref with an active ground obstacle.  scipy trust-constr
    exits at its iteration cap (often infeasible) on the stiff relu^2 slack
    penalty, so the checks are: (a) our solution is feasible, (b) its cost is
    within the feasibility-enforcement gap of the L-BFGS relaxation that
    ignores the hard state boxes (a certified lower bound), and (c) it is no
    worse than whatever trust-constr found."""
    N = 8
    mpc = MPCWholeBody(wb_robot, [Obstacles(1.1, 0.15, 0.4)], [], N=N,
                       solver_config=SolverConfig(al_iters=8, ilqr_iters=20))
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi, np.pi]
    target = np.concatenate([[2.2, 0.0, 0.0, 0, 0, 0], x0[6:]])
    traj = np.linspace(x0, target, N + 1)
    u_ref = np.zeros((N, 5))
    mpc.solve(x0, traj, u_ref)
    res = mpc.last_result
    assert float(res.max_violation) < 1e-5

    params = dict(mpc.make_params(traj, u_ref), U_last=jnp.zeros((N, 5)))
    U_r, X_r, cost_relax, _ = lbfgs_solve(
        mpc.ocp, jnp.asarray(x0), jnp.zeros((N, 5)), params)
    # feasible solution must sit just above the box-relaxed lower bound
    assert cost_relax <= float(res.cost) <= cost_relax * 1.01

    U_o, X_o, cost_tc, sres = scipy_solve(
        mpc.ocp, jnp.asarray(x0), jnp.zeros((N, 5)), params, maxiter=600)
    assert float(res.cost) <= cost_tc * (1 + 1e-3)


def test_wholebody_qref_scenario1_local_optimality(wb_robot):
    """The stiff scenario-1 manipulate-phase problem (button cylinder under
    the parked base => large unavoidable slack, arm against the table
    half-planes).  scipy trust-constr fails here (goes infeasible), so
    instead of an oracle comparison we verify our solution is a feasible
    local optimum: no random control perturbation that stays within the
    input box may both reduce the objective and remain feasible."""
    N = 8
    mpc = MPCWholeBody(wb_robot, OBSTACLES, scenario1_halfplanes(), N=N,
                       solver_config=SolverConfig(al_iters=10, ilqr_iters=25))
    x0 = np.array([4.45, 5.06, -np.pi, 0, 0, 0, -np.pi / 4, -np.pi, np.pi])
    q_target = np.array([0.3, -1.0, 1.0])
    traj = np.linspace(x0, np.concatenate([x0[:6], q_target]), N + 1)
    u_ref = np.zeros((N, 5))
    mpc.solve(x0, traj, u_ref)
    res = mpc.last_result
    assert float(res.max_violation) < 1e-4

    from mmmpc_tpu.solver.al_ilqr import _objective, rollout

    def eval_U(U):
        X, Uc = rollout(mpc.ocp, jnp.asarray(np.clip(
            x0, mpc.xlim[0], mpc.xlim[1])), U, params)
        obj = _objective(mpc.ocp, X, Uc, params)
        ks = jnp.arange(N)
        viol = jnp.max(jax.vmap(
            lambda x, u, k: jnp.max(mpc.ocp.stage_ineq(x, u, k, params)))(
                X[:-1], Uc, ks))
        viol = jnp.maximum(viol, jnp.max(mpc.ocp.terminal_ineq(X[-1], params)))
        return float(obj), float(viol)

    params = dict(mpc.make_params(traj, u_ref), U_last=jnp.zeros((N, 5)))
    base_cost, base_viol = eval_U(res.U)
    rng = np.random.default_rng(7)
    for scale in (1e-3, 1e-2):
        for _ in range(20):
            dU = rng.normal(size=(N, 5)) * scale
            cand = jnp.clip(res.U + dU, mpc.ocp.u_lower, mpc.ocp.u_upper)
            c, v = eval_U(cand)
            # any strictly better neighbor must be infeasible
            assert c > base_cost - 1e-6 or v > 1e-5


def test_wholebody_qref_protocol(wb_robot):
    N = 10
    mpc = MPCWholeBody(wb_robot, OBSTACLES, [], N=N)
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi, np.pi]
    traj = np.linspace(x0, x0 + np.array([1, 0.5, 0, 0, 0, 0, 0, 0, 0.0]),
                       N + 1)
    u_ref = np.zeros((N, 5))
    u0 = mpc.solve(x0, traj, u_ref)
    assert u0.shape == (5,)
    # ulim respected
    assert -2 - 1e-9 <= u0[0] <= 2 + 1e-9
    assert np.all(np.abs(u0[2:]) <= 1 + 1e-9)
    # warm start feeds U_last: a second identical solve keeps improving /
    # stays consistent
    u1 = mpc.solve(x0, traj, u_ref)
    assert np.all(np.isfinite(u1))
    # infeasible sensor feedback is clamped, not fatal
    x_bad = x0.copy()
    x_bad[6] = 10.0  # way over q1's pi/2 bound
    u2 = mpc.solve(x_bad, traj, u_ref)
    assert np.all(np.isfinite(u2))


def test_wholebody_terminal_equality_toggle(wb_robot):
    N = 8
    mpc = MPCWholeBody(wb_robot, [], [], N=N,
                       solver_config=SolverConfig(al_iters=10, ilqr_iters=15))
    x0 = np.zeros(9)
    x0[6:] = [0, -1.0, 1.0]
    # must be dynamically reachable in N*dt = 0.8 s from rest under the
    # +-2 m/s^2 acceleration box (max ~0.64 m straight-line)
    target = x0 + np.array([0.4, 0.08, 0, 0, 0, 0, 0, 0, 0.0])
    traj = np.tile(target, (N + 1, 1))
    u_ref = np.zeros((N, 5))
    mpc.solve(x0, traj, u_ref)
    x_free = np.asarray(mpc.last_result.X[-1, :2])

    mpc2 = MPCWholeBody(wb_robot, [], [], N=N,
                        solver_config=SolverConfig(al_iters=10, ilqr_iters=15))
    mpc2.add_terminal_position_constraint()
    mpc2.solve(x0, traj, u_ref)
    x_pinned = np.asarray(mpc2.last_result.X[-1, :2])
    # pinned run must end (much) closer to the target position
    err_free = np.linalg.norm(x_free - target[:2])
    err_pinned = np.linalg.norm(x_pinned - target[:2])
    assert err_pinned < 1e-3
    assert err_pinned < err_free


def test_wholebody_endpoint_controller(wb_robot):
    N = 8
    mpc = MPCWholeBodyEndpoint(wb_robot, OBSTACLES, N=N)
    x0 = np.zeros(9)
    x0[6:] = [0, -0.6, 0.8]
    from mmmpc_tpu.models.mobile_manipulator import wholebody_fk
    pose0 = np.asarray(wholebody_fk(jnp.asarray(x0))[0])
    pose_target = pose0 + np.array([0.3, 0.0, 0.1, 0.0])
    traj = np.linspace(pose0, pose_target, N + 1)
    u0 = mpc.solve(x0, traj, np.zeros((N, 5)))
    assert u0.shape == (5,)
    # endpoint moves toward the target
    Xf = np.asarray(mpc.last_result.X[-1])
    posef = np.asarray(wholebody_fk(jnp.asarray(Xf))[0])
    assert (np.linalg.norm(posef[:3] - pose_target[:3])
            < np.linalg.norm(pose0[:3] - pose_target[:3]))


# ---------------------------------------------------------------- moving obs


def test_predict_obstacle_trajectory():
    obs = np.array([[1.0, 0.0, 0.3]])
    vel = np.array([[0.5, -0.1]])
    traj = predict_obstacle_trajectory(obs, vel, 4, 0.1)
    assert traj.shape == (5, 1, 3)
    np.testing.assert_allclose(np.asarray(traj[4, 0]),
                               [1.0 + 0.2, -0.04, 0.3], atol=1e-12)


def test_moving_obs_controller_anticipates(wb_robot):
    """An obstacle predicted to cross the robot's path must bend the plan
    more than the same obstacle standing still off to the side."""
    N = 10
    x0 = np.zeros(9)
    x0[6:] = [0, -1.0, 1.0]
    target = x0 + np.array([1.5, 0, 0, 0, 0, 0, 0, 0, 0.0])
    traj = np.linspace(x0, target, N + 1)
    u_ref = np.zeros((N, 5))
    obs0 = np.array([[0.9, -1.1, 0.3]])   # beside the path now

    cfg = SolverConfig(al_iters=6, ilqr_iters=12)
    static = MPCWholeBodyMovingObs(wb_robot, [Obstacles(*obs0[0])], [], N=N,
                                   solver_config=cfg)
    static.solve(x0, traj, u_ref)

    moving = MPCWholeBodyMovingObs(wb_robot, [Obstacles(*obs0[0])], [], N=N,
                                   solver_config=cfg)
    moving.observe_obstacles(obs0[:, :2], np.array([[0.0, 1.2]]))  # crossing
    moving.solve(x0, traj, u_ref)

    y_static = np.abs(np.asarray(static.last_result.X)[:, 1]).max()
    y_moving = np.abs(np.asarray(moving.last_result.X)[:, 1]).max()
    assert y_moving > y_static + 1e-4  # dodges the predicted crossing
