"""Batched on-device task FSM — thousands of full move->press-button tasks
in one compiled loop.

The reference runs its task state machine on the host, one scenario per
process (interface_wholebody_qref.py:146-228): move -> approach (inject the
terminal position equality) -> rotate (weight switch) -> move finish (IK +
joint-space plan + weight switch) -> manipulate -> manipulate finish.
sim/batch_engine.py batches single-phase windows; THIS engine runs the whole
task per scenario on device:

- the phase lives as per-scenario integer data; every phase-dependent
  quantity (weights, terminal-equality mask, local reference construction)
  is a select over that integer — one compiled program, no recompilation at
  phase switches (the same design that maps the reference's opti.parameter
  mechanism onto jit arguments);
- the IK at the move->manipulate boundary is the batched projected-LM solve
  (models/arm.py::arm_ik, replacing the reference's per-call IPOPT nlpsol)
  evaluated inside the tick and consumed only on the transition tick;
- solver warm starts (primal U and AL duals) carry across ticks per scenario.

Phases: 0 move, 1 approach, 2 rotate, 3 manipulate, 4 done.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mmmpc_tpu.models.arm import arm_ik
from mmmpc_tpu.models.mobile_manipulator import wholebody_fk
from mmmpc_tpu.solver import al_ilqr_solve_batched, shift_multipliers
from mmmpc_tpu.utils.configs import (
    BASELINK2JOINT1_X, BASELINK2JOINT1_Z, SolverConfig, WORKING_RADIUS,
)
from mmmpc_tpu.utils.math import angle_diff

PHASE_MOVE, PHASE_APPROACH, PHASE_ROTATE, PHASE_MANIP, PHASE_DONE = range(5)

# weight schedule (reference interface:175-185, 204-216): index 0 for
# move/approach, 1 for rotate, 2 for manipulate
_W_TABLE = np.stack([
    5.0 * np.diag([5, 5, 0, 0, 0, 1, 1, 1, 1.0]),
    np.diag([5, 5, 5, 0, 0, 1, 1, 1, 1.0]),
    np.diag([500, 500, 500, 0, 0, 1, 1, 1, 1.0]),
])


class TaskRolloutLog(NamedTuple):
    X: jnp.ndarray          # (B, T+1, nx)
    U: jnp.ndarray          # (B, T, nu)
    phase: jnp.ndarray      # (B, T) int32 phase AFTER each tick
    cost: jnp.ndarray       # (B, T)
    violation: jnp.ndarray  # (B, T)
    done_at: jnp.ndarray    # (B,) tick index of task completion (T if never)


def stand_off_target(x_start, global_pose_target):
    """Per-scenario base target in front of the button (interface:24-32)."""
    gx, gy, _, gpsi = (global_pose_target[..., 0], global_pose_target[..., 1],
                       global_pose_target[..., 2], global_pose_target[..., 3])
    zeros = jnp.zeros_like(gx)
    return jnp.stack([
        gx - WORKING_RADIUS * jnp.cos(gpsi),
        gy - WORKING_RADIUS * jnp.sin(gpsi),
        gpsi, zeros, zeros, zeros,
        x_start[..., 6], x_start[..., 7], x_start[..., 8],
    ], axis=-1)


def make_batch_task_loop(ocp, cfg: SolverConfig, shared_params,
                         t_move: float, t_manipulate: float, dt: float,
                         n_ticks: int, ik_iters: int = 60,
                         rotate_exit_pos_tol: float = 0.01,
                         rotate_exit_yaw_tol: float = 0.5 * np.pi / 180.0,
                         aim_at_button: bool = False,
                         stuck_ticks: int = 25,
                         host_parity_solver: bool = False):
    """Build run(x_start_b, global_pose_target_b) -> TaskRolloutLog.

    ocp: the whole-body qref OCP (MPCWholeBody(...).ocp); shared_params: the
    controller's make_params(...) minus X_ref / U_ref / U_last / Q / P /
    eq_mask, which the FSM owns per scenario per tick.

    Straggler recovery (off by default — host-parity behavior): ~10% of a
    joint-jittered fleet stalls in the rotate phase because the jittered-arm
    pose equilibrium leaves a 1-2.5 cm base offset, beyond the reference's
    brittle 1 cm / 0.5 deg exit tolerances
    (interface_wholebody_qref.py:192-197); the host Interface stalls
    identically from the same states
    (tests/test_task_engine.py::test_rotate_stall_host_parity).  Relaxing
    ``rotate_exit_pos_tol`` alone is NOT safe with the parity yaw target:
    the arm moves in the base's x-z plane, so a base displaced d
    perpendicular to the nominal heading leaves an uncompensable ~d lateral
    end-effector miss (at 0.6 m stand-off, 5 cm -> ~4.8 deg bearing error
    ~= 5 cm lateral — the 1 cm press-button check can never pass; measured:
    blanket 5 cm / 2 deg relaxation DROPS fleet completion to 42%).  The
    safe recovery is ``aim_at_button=True`` + relaxed pos tol: the rotate
    phase's yaw target (reference pose AND exit check) becomes the button
    bearing from the robot's ACTUAL position, so the arm plane contains the
    button wherever the base settled and the IK absorbs the range
    difference.
    """
    if host_parity_solver:
        # Pin the solver to the vmapped per-scenario path (no fused
        # kernels).  The task FSM's rotate-exit gates (1 cm / 0.5 deg,
        # reference interface:192-197) sit on a knife edge relative to the
        # solver's float32 lowering: the lanes kernels and the vmapped path
        # are equally-valid f32 solvers whose iterates diverge in the
        # near-infeasible rotate-equality regime, and parity-mode fleet
        # completion lands at a different point (recovery mode retires the
        # difference — see BASELINE.md).  Use this flag when reproducing
        # the host Interface's completion regime matters more than tick
        # cost.
        import dataclasses
        cfg = dataclasses.replace(cfg, use_kernels=False)
    N = ocp.N
    nx, nu = ocp.nx, ocp.nu
    T_move = int(round(t_move / dt))
    T_man = int(round(t_manipulate / dt))
    # float32 where it is made: under x64 a float64 table would promote
    # the whole fleet solve
    Wtab = jnp.asarray(_W_TABLE, jnp.float32)
    ks_traj = jnp.arange(N + 1)
    ks_u = jnp.arange(N)

    def window(traj, x, idx_cols):
        d = traj[:, idx_cols] - x[idx_cols]
        mi = jnp.argmin(jnp.sum(d * d, axis=1))
        rows = jnp.minimum(mi + ks_traj, traj.shape[0] - 1)
        return traj[rows]

    def fsm_pre(x, phase, traj_move, traj_man, gpt, x_target, aux):
        """Per-robot FSM transitions + reference construction (everything
        BEFORE the solve).  Returns the updated (phase, traj_man, aux) and
        this tick's per-robot solve parameters (X_ref, QP, eq_mask)."""
        # aux = (best_ee_err, stale_ticks, rot_ticks): the stuck detectors'
        # carry (recovery mode only; zeros-cost otherwise)
        best_err, stale, rot_ticks = aux
        # ---- transitions (host-FSM order, interface:152-213) ----------
        in_move = phase == PHASE_MOVE
        in_appr = phase == PHASE_APPROACH
        in_rot = phase == PHASE_ROTATE
        in_man = phase == PHASE_MANIP
        near2 = ((jnp.abs(x[0] - x_target[0]) <= 2.0)
                 & (jnp.abs(x[1] - x_target[1]) <= 2.0))
        pos_err = jnp.sqrt((x[0] - x_target[0]) ** 2
                           + (x[1] - x_target[1]) ** 2)
        phase = jnp.where(in_move & near2, PHASE_APPROACH, phase)
        phase = jnp.where((in_move | in_appr) & (pos_err <= 0.2),
                          PHASE_ROTATE, phase)
        yaw_tgt = x_target[2]
        exit_pos_ok = pos_err <= rotate_exit_pos_tol
        if aim_at_button:
            # bearing re-aim ONLY in the rotate phase AND only once the base
            # is near the stand-off point: phase-wide (or far-field) bearing
            # chasing is a moving target that makes robots spiral (measured:
            # both variants cost completions)
            bearing = jnp.arctan2(gpt[1] - x[1], gpt[0] - x[0])
            near = pos_err <= 3.0 * rotate_exit_pos_tol
            yaw_tgt = jnp.where(in_rot & near, bearing, yaw_tgt)
            # task-aware exit: besides the (relaxed) pos gate, the button
            # range must sit in the IK-reachable, collision-safe annulus —
            # exiting closer than ~0.55 m puts the base against the button
            # marker's own ground circle (r 0.1 + base 0.4 = 0.5), whose
            # push drifts the frozen-yaw arm plane off the button (measured:
            # the dominant relaxed-exit failure mode)
            range_b = jnp.sqrt((gpt[0] - x[0]) ** 2 + (gpt[1] - x[1]) ** 2)
            exit_pos_ok = exit_pos_ok & (range_b >= 0.55) & (range_b <= 0.68)
        yaw_ok = (jnp.abs(angle_diff(x[2], yaw_tgt))
                  <= rotate_exit_yaw_tol)
        to_manip = in_rot & yaw_ok & exit_pos_ok
        phase = jnp.where(to_manip, PHASE_MANIP, phase)

        # move finish: IK to the button-relative pose, joint-space linspace
        # (interface:188-216); consumed only on the transition tick
        local_target = jnp.stack([
            jnp.sqrt((gpt[0] - x[0]) ** 2 + (gpt[1] - x[1]) ** 2)
            - BASELINK2JOINT1_X,
            jnp.zeros_like(x[0]),
            gpt[2] - BASELINK2JOINT1_Z,
        ])
        q_goal = arm_ik(x[6:9], local_target, iters=ik_iters)
        x_goal = jnp.concatenate([x[:6], q_goal])
        traj_new = (x[None, :]
                    + (x_goal - x)[None, :]
                    * jnp.linspace(0.0, 1.0, T_man + 1, dtype=x.dtype)[:, None])
        traj_man = jnp.where(to_manip, traj_new, traj_man)

        ee = wholebody_fk(x)[0][:3]
        ee_err = jnp.linalg.norm(ee - gpt[:3])
        done = in_man & (ee_err <= 0.01)
        phase = jnp.where(done, PHASE_DONE, phase)

        if aim_at_button and stuck_ticks:
            # manipulate-phase stuck detector (recovery mode): if the
            # end-effector error has not improved for ``stuck_ticks``
            # control periods, drop back to ROTATE — the bearing re-aim
            # re-aligns the arm plane from wherever the base drifted, and
            # the next rotate->manipulate transition re-runs the IK from the
            # CURRENT joints (a fresh joint-space plan).  This is the
            # batched twin of "back off and re-approach"; truly blocked
            # scenarios just cycle and stay incomplete.
            improved = ee_err < best_err - 1e-4
            stale = jnp.where(in_man & ~improved & ~done, stale + 1, 0)
            re_approach = in_man & (stale >= stuck_ticks) & ~done
            phase = jnp.where(re_approach, PHASE_ROTATE, phase)
            best_err = jnp.where(in_man & improved, ee_err,
                                 jnp.where(re_approach | ~in_man,
                                           jnp.asarray(1e9, x.dtype),
                                           best_err))
            stale = jnp.where(re_approach, 0, stale)
            # rotate-orbit escape: a small population limit-cycles in the
            # rotate phase (yaw tracking x position pull at ~0.3 m produces
            # a persistent orbit); after 3x the stuck budget drop back to
            # APPROACH — its weight row has NO yaw term, so the orbit
            # decays and rotate re-enters cleanly at 0.2 m
            still_rot = phase == PHASE_ROTATE
            rot_ticks = jnp.where(still_rot, rot_ticks + 1, 0)
            orbit = still_rot & (rot_ticks >= 3 * stuck_ticks)
            phase = jnp.where(orbit, PHASE_APPROACH, phase)
            rot_ticks = jnp.where(orbit, 0, rot_ticks)
        aux = (best_err, stale, rot_ticks)

        # ---- phase-dependent references -------------------------------
        ref_move = window(traj_move, x, jnp.array([0, 1]))
        # pose tile with continuous yaw (runtime/reference.local_ref_pose);
        # under recovery the rotate target yaw is the actual-position button
        # bearing computed above
        pose = x_target.at[2].set(x[2] + angle_diff(yaw_tgt, x[2]))
        ref_pose = jnp.tile(pose, (N + 1, 1))
        ref_man = window(traj_man, x, jnp.array([6, 7, 8]))
        X_ref = jnp.where(phase[None, None] == PHASE_MOVE, ref_move,
                          jnp.where(phase[None, None] >= PHASE_MANIP,
                                    ref_man, ref_pose))
        U_ref = jnp.zeros((N, nu), x.dtype)

        widx = jnp.where(phase >= PHASE_MANIP, 2,
                         jnp.where(phase == PHASE_ROTATE, 1, 0))
        QP = Wtab[widx]
        eq_mask = (phase >= PHASE_APPROACH).astype(x.dtype)
        return phase, traj_man, aux, X_ref, QP, eq_mask

    def post_solve(x, U_warm, lams, phase, res):
        """Per-robot post-solve bookkeeping (fallback select, dual shift,
        done-hold, plant step)."""
        ok = jnp.all(jnp.isfinite(res.U)) & (res.max_violation < 1.0)
        u_shift = jnp.concatenate([U_warm[1:], U_warm[-1:]], axis=0)
        U_applied = jnp.where(ok, res.U, u_shift)
        lam_new = shift_multipliers(res.lam_stage, res.lam_term, res.lam_eq)
        lams = jax.tree.map(lambda new, old: jnp.where(ok, new, old),
                            lam_new, lams)
        # a finished scenario holds its state (the reference ends its run)
        is_done = phase == PHASE_DONE
        u0 = jnp.where(is_done, 0.0, U_applied[0])
        x_next = jnp.where(is_done, x, ocp.dynamics(x, U_applied[0]))
        return x_next, U_applied, lams, u0

    def run(x_start_b, global_pose_target_b, carry0=None):
        """One n_ticks segment of the fleet task loop.

        carry0=None starts fresh; passing the carry returned by a previous
        segment continues it (chunked dispatch: a 300-tick task at fleet
        batch is minutes of device time in ONE XLA execution — long past
        what the transport tolerates — so callers run bounded segments and
        thread the carry; it is also the fleet checkpoint payload).
        Returns (TaskRolloutLog for this segment, carry).

        Carry format: a 6-tuple (x, U, lams, phase, traj_man, aux); the
        stuck-detector ``aux`` was appended in round 4.  A legacy 5-tuple
        checkpoint (saved before aux existed) is accepted and upgraded with
        a fresh zero aux.
        """
        B = x_start_b.shape[0]
        dtype = x_start_b.dtype
        x_target_b = stand_off_target(x_start_b, global_pose_target_b)
        steps = jnp.linspace(0.0, 1.0, T_move + 1, dtype=dtype)[:, None]
        traj_move_b = (x_start_b[:, None, :]
                       + (x_target_b - x_start_b)[:, None, :] * steps[None])

        zx = jnp.zeros(nx, dtype)
        zu = jnp.zeros(nu, dtype)
        probe = dict(shared_params,
                     X_ref=jnp.zeros((N + 1, nx), dtype),
                     U_ref=jnp.zeros((N, nu), dtype),
                     U_last=jnp.zeros((N, nu), dtype),
                     Q=jnp.zeros((nx, nx), dtype),
                     P=jnp.zeros((nx, nx), dtype),
                     eq_mask=jnp.zeros((), dtype))
        nc = jax.eval_shape(ocp.stage_ineq, zx, zu, 0, probe).shape[0]
        nct = jax.eval_shape(ocp.terminal_ineq, zx, probe).shape[0]
        ne = jax.eval_shape(ocp.terminal_eq, zx, probe).shape[0]

        fresh_aux = (jnp.full((B,), 1e9, dtype), jnp.zeros((B,), jnp.int32),
                     jnp.zeros((B,), jnp.int32))
        if carry0 is None:
            carry0 = (
                x_start_b,
                jnp.zeros((B, N, nu), dtype),
                (jnp.zeros((B, N, nc), dtype), jnp.zeros((B, nct), dtype),
                 jnp.zeros((B, ne), dtype)),
                jnp.full((B,), PHASE_MOVE, jnp.int32),
                jnp.tile(x_start_b[:, None, :], (1, T_man + 1, 1)),
                fresh_aux,
            )
        elif len(carry0) == 5:
            # legacy (pre-aux) checkpoint: upgrade with a fresh detector
            # state instead of failing on the tree-structure mismatch
            carry0 = (*carry0, fresh_aux)

        def tick(carry, _):
            x_b, U_b, lam_b, phase_b, man_b, aux_b = carry
            # 1) per-robot FSM + references (vmapped — cheap elementwise)
            phase_n, man_n, aux_n, X_ref_b, QP_b, eqm_b = jax.vmap(fsm_pre)(
                x_b, phase_b, traj_move_b, man_b, global_pose_target_b,
                x_target_b, aux_b)
            # 2) ONE batched solve for the whole fleet with per-robot params
            # (batch-minor trailing axis).  On the GPU the forward pass runs
            # as the fused kernel (ops/wholebody_fwd.py; the per-robot X_ref
            # / Q / P / eq_mask / U_last arrive as lane operands) and the
            # backward as the vmapped XLA expansion plus backward_scan;
            # elsewhere al_ilqr_solve_batched's vmap path computes the same
            # per-robot solves.
            params_b = dict(
                shared_params,
                X_ref=jnp.moveaxis(X_ref_b, 0, -1),       # (N+1, nx, B)
                U_ref=jnp.zeros((N, nu), x_b.dtype),
                U_last=jnp.moveaxis(U_b, 0, -1),          # (N, nu, B)
                Q=jnp.moveaxis(QP_b, 0, -1),              # (nx, nx, B)
                P=jnp.moveaxis(QP_b, 0, -1),
                eq_mask=eqm_b)                            # (B,)
            res = al_ilqr_solve_batched(ocp, x_b, U_b, params_b, cfg,
                                        lam0_b=lam_b)
            # 3) per-robot post-solve bookkeeping (vmapped)
            x_n, U_n, lam_n, u0 = jax.vmap(post_solve)(
                x_b, U_b, lam_b, phase_n, res)
            return ((x_n, U_n, lam_n, phase_n, man_n, aux_n),
                    (x_n, u0, phase_n, res.cost, res.max_violation))

        carry, (Xs, Us, phases, costs, viols) = jax.lax.scan(
            tick, carry0, None, length=n_ticks)
        X = jnp.concatenate([carry0[0][:, None],
                             jnp.moveaxis(Xs, 0, 1)], axis=1)
        phase_t = jnp.moveaxis(phases, 0, 1)             # (B, T)
        done_mask = phase_t == PHASE_DONE
        done_at = jnp.where(jnp.any(done_mask, axis=1),
                            jnp.argmax(done_mask, axis=1),
                            n_ticks)
        return TaskRolloutLog(
            X=X, U=jnp.moveaxis(Us, 0, 1), phase=phase_t,
            cost=jnp.moveaxis(costs, 0, 1),
            violation=jnp.moveaxis(viols, 0, 1), done_at=done_at), carry

    return run
