"""Panda-3DoF arm: closed-form FK, analytic-free Jacobians, batched IK.

Re-design of the reference ManipulatorPanda3DoF
(/root/reference/robot_models/manipulator_3DoF.py).  The reference pastes
sympy-generated trig expansions; here the same kinematics are written in
angle-sum form (mathematically identical — verified against an independent
sympy DH derivation in tests/test_kinematics.py):

    theta = q1 - q2          (elbow direction)
    beta  = q1 - q2 - q3     (end-effector direction)

    joint2 = [a2 s1 + a3 c1,                     0, a2 c1 - a3 s1]
    joint3 = joint2 + [-a3 cos(theta) + a5 sin(theta) ... ]
    ee     = joint3 + [a6 cos(beta) - a7 sin(beta), 0,
                       -a6 sin(beta) - a7 cos(beta)]

The arm moves in its local x-z plane (y == 0 throughout), matching the
reference's modeling assumption (mobile_manipulator.py:31-34).

The reference's IPOPT-based IK (`inverse_transformation`,
manipulator_3DoF.py:79-133) is replaced by a fixed-iteration, projected
Levenberg-Marquardt solve — fully jittable and vmappable over batches of
targets, no host round-trip.
"""

import jax
import jax.numpy as jnp
import numpy as np

# DH constants (reference manipulator_3DoF.py:18-22, from the Franka Panda
# dynamic-identification paper DH table).
A2 = 0.316
A3 = 0.0825
A5 = 0.384
A6 = 0.088
A7 = 0.107

# IK joint bounds (reference manipulator_3DoF.py:123 — note these differ from
# the MPC's xlim bounds on q).
ARM_IK_LOWER = jnp.array([-jnp.pi / 2, -3 * jnp.pi / 4, 0.0])
ARM_IK_UPPER = jnp.array([jnp.pi / 2, 0.0, 3 * jnp.pi / 2])

# MPC joint bounds (reference mpc_wholebody_qref.py:19-20).
ARM_JOINT_LOWER = jnp.array([-jnp.pi / 2, -jnp.pi, 0.0])
ARM_JOINT_UPPER = jnp.array([jnp.pi / 2, 0.0, 3 * jnp.pi / 2])


def arm_fk(q):
    """Positions of joint2, joint3 and the end point in the arm base frame.

    q: (3,) joint angles. Returns (ee, joint2, joint3), each (3,) with y == 0.
    Matches reference forward_tranformation (manipulator_3DoF.py:10-77).
    """
    q1, q2, q3 = q[0], q[1], q[2]
    s1, c1 = jnp.sin(q1), jnp.cos(q1)
    theta = q1 - q2
    st, ct = jnp.sin(theta), jnp.cos(theta)
    beta = theta - q3
    sb, cb = jnp.sin(beta), jnp.cos(beta)

    zero = jnp.zeros_like(q1)
    x2 = A2 * s1 + A3 * c1
    z2 = A2 * c1 - A3 * s1
    x3 = x2 - A3 * ct + A5 * st
    z3 = z2 + A3 * st + A5 * ct
    xe = x3 + A6 * cb - A7 * sb
    ze = z3 - A6 * sb - A7 * cb

    joint2 = jnp.stack([x2, zero, z2])
    joint3 = jnp.stack([x3, zero, z3])
    ee = jnp.stack([xe, zero, ze])
    return ee, joint2, joint3


def arm_fk_np(q):
    """Pure-numpy twin of :func:`arm_fk` for host-side consumers (plotting,
    the C++ runtime parity tests) that must not touch the device per call.
    Kept in lockstep by tests/test_kinematics.py."""
    q1, q2, q3 = float(q[0]), float(q[1]), float(q[2])
    s1, c1 = np.sin(q1), np.cos(q1)
    theta = q1 - q2
    st, ct = np.sin(theta), np.cos(theta)
    beta = theta - q3
    sb, cb = np.sin(beta), np.cos(beta)
    x2 = A2 * s1 + A3 * c1
    z2 = A2 * c1 - A3 * s1
    x3 = x2 - A3 * ct + A5 * st
    z3 = z2 + A3 * st + A5 * ct
    xe = x3 + A6 * cb - A7 * sb
    ze = z3 - A6 * sb - A7 * cb
    return (np.array([xe, 0.0, ze]), np.array([x2, 0.0, z2]),
            np.array([x3, 0.0, z3]))


def arm_step(q, dq, dt):
    """Euler joint integrator (reference manipulator_3DoF.py:189-191)."""
    return q + dq * dt


def ee_jacobian(q):
    """3x3 Jacobian of the end-point position w.r.t. q, in closed form.

    Replaces the reference's hand-pasted analytic `_get_xdot`
    (manipulator_3DoF.py:135-187).  The angle-sum FK differentiates by the
    chain rule on theta = q1 - q2 and beta = theta - q3, so each column is a
    signed partial sum of three link terms — 6 trig evaluations total instead
    of the 3 duplicated passes jax.jacfwd spends (verified equal to AD in
    tests/test_hand_jacobians.py).
    """
    q1, q2, q3 = q[0], q[1], q[2]
    s1, c1 = jnp.sin(q1), jnp.cos(q1)
    theta = q1 - q2
    st, ct = jnp.sin(theta), jnp.cos(theta)
    beta = theta - q3
    sb, cb = jnp.sin(beta), jnp.cos(beta)

    # d/dtheta of the x3/z3 link terms, d/dbeta of the ee link terms
    xt = A3 * st + A5 * ct
    zt = A3 * ct - A5 * st
    xb = -A6 * sb - A7 * cb
    zb = -A6 * cb + A7 * sb
    dx1 = A2 * c1 - A3 * s1
    dz1 = -A2 * s1 - A3 * c1

    zero = jnp.zeros_like(q1)
    return jnp.stack([
        jnp.stack([dx1 + xt + xb, -(xt + xb), -xb]),
        jnp.stack([zero, zero, zero]),
        jnp.stack([dz1 + zt + zb, -(zt + zb), -zb]),
    ])


def ee_velocity(q, dq):
    """End-point Cartesian velocity J(q) @ dq (reference _get_xdot)."""
    return ee_jacobian(q) @ dq


def ee_pitch_rate(dq):
    """Pitch rate of the end effector: dq1 - dq2 - dq3.

    (Reference _get_xdot's dx5 row, manipulator_3DoF.py:176-178.)
    """
    return dq[0] - dq[1] - dq[2]


def _ik_residual(q, x_target, z_target):
    ee, _, _ = arm_fk(q)
    return jnp.stack([ee[0] - x_target, ee[2] - z_target])


def arm_ik(q_init, x_target, iters: int = 300, lm_lambda: float = 1e-6):
    """Solve FK(q) == [x, 0, z] target for q within the IK bounds.

    Projected Levenberg-Marquardt: dq = -(J^T J + lam I)^-1 J^T r followed by
    clipping into the bounds each iteration, with a simple backtracking step
    (the full step is tried first, half steps if the residual grows).  Fixed
    iteration count => jit/vmap-safe; replaces the reference's per-call
    ``ca.nlpsol('ipopt')`` (manipulator_3DoF.py:110-123).

    x_target: (3,) with y == 0 (asserted by the reference; ignored here).
    Returns (3,) joint angles.
    """
    xt = x_target[0]
    zt = x_target[2]
    jac = jax.jacfwd(_ik_residual)

    def sqnorm(r):
        return jnp.sum(r * r)

    def body(_, q):
        r = _ik_residual(q, xt, zt)
        J = jac(q, xt, zt)                       # (2, 3)
        H = J.T @ J + lm_lambda * jnp.eye(3, dtype=q.dtype)
        dq = -jnp.linalg.solve(H, J.T @ r)
        lo = ARM_IK_LOWER.astype(q.dtype)
        hi = ARM_IK_UPPER.astype(q.dtype)
        # parallel backtracking: evaluate a few step sizes, keep the best
        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.05], dtype=q.dtype)
        cands = jnp.clip(q[None, :] + alphas[:, None] * dq[None, :], lo, hi)
        costs = jax.vmap(lambda qq: sqnorm(_ik_residual(qq, xt, zt)))(cands)
        return cands[jnp.argmin(costs)]

    q_init = jnp.asarray(q_init)
    q0 = jnp.clip(q_init, ARM_IK_LOWER.astype(q_init.dtype),
                  ARM_IK_UPPER.astype(q_init.dtype))
    # millimetre-accurate IK needs full-f32 multiplies (a float32 product
    # may run in TF32 on the GPU; see SolverConfig.matmul_precision)
    with jax.default_matmul_precision("highest"):
        return jax.lax.fori_loop(0, iters, body, q0)
