"""Batched on-device task FSM: full move->approach->rotate->manipulate tasks
complete for a batch of scenarios in one compiled loop."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmmpc_tpu.controllers import MPCWholeBody
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import MobileManipulator
from mmmpc_tpu.models.mobile_manipulator import wholebody_fk
from mmmpc_tpu.sim.batch_task_engine import (
    PHASE_DONE, PHASE_MANIP, make_batch_task_loop, stand_off_target,
)
from mmmpc_tpu.utils.configs import SolverConfig, make_scenario


def test_fleet_task_completion():
    sc = make_scenario(0, N=10)           # debug scenario: no half-planes
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    cfg = SolverConfig(al_iters=3, ilqr_iters=8, ilqr_iters_later=5,
                       cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                       alpha_decay=0.35)
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, [], N=10,
                       solver_config=cfg)
    shared = mpc.make_params(np.zeros((11, 9)), np.zeros((10, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    run = make_batch_task_loop(mpc.ocp, cfg, shared, t_move=sc.t_move,
                               t_manipulate=sc.t_manipulate, dt=sc.dt,
                               n_ticks=90, ik_iters=40)

    B = 4
    rng = np.random.default_rng(2)
    x0 = np.tile(sc.x_start, (B, 1))
    # joint-space jitter: base-position jitter can strand the ROTATE phase
    # (its 1 cm / 0.5 deg exit tolerances are brittle) — verified to be
    # host-Interface parity, i.e. a reference-formulation trait, not an
    # engine bug (the host loop stalls identically from the same states)
    x0[:, 6] += 0.05 * rng.standard_normal(B)
    x0[:, 7] = np.minimum(x0[:, 7] + 0.05 * rng.standard_normal(B), 0.0)
    gpt = np.tile(sc.global_pose_target, (B, 1))
    # chunked dispatch: two segments threaded by the carry (the same
    # mechanism fleet benches use to keep each XLA execution bounded)
    jrun = jax.jit(run)
    log1, carry = jrun(jnp.asarray(x0), jnp.asarray(gpt))
    log2, _ = jrun(jnp.asarray(x0), jnp.asarray(gpt), carry)
    import jax as _jax
    log = _jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=1)
        if a.ndim > 1 else a, log1, log2)
    log = log._replace(done_at=jnp.where(
        log1.done_at < log1.phase.shape[1], log1.done_at,
        log1.phase.shape[1] + log2.done_at))

    done = np.asarray(log.phase[:, -1]) == PHASE_DONE
    assert done.all(), f"phases at end: {np.asarray(log.phase[:, -1])}"
    # completion means the end effector actually reached the button
    for b in range(B):
        t = int(np.asarray(log.done_at[b]))
        ee = np.asarray(wholebody_fk(log.X[b, t])[0][:3])
        assert np.linalg.norm(ee - gpt[b, :3]) <= 0.02
    # the task passed through the manipulate phase
    assert (np.asarray(log.phase) == PHASE_MANIP).any(axis=1).all()


def test_stand_off_target_matches_interface():
    sc = make_scenario(1, N=10)
    xt = stand_off_target(jnp.asarray(sc.x_start),
                          jnp.asarray(sc.global_pose_target))
    from mmmpc_tpu.runtime import Interface

    class _Dummy:
        class ocp:
            nu = 5
        N = 10

    # reference construction (interface:24-32) via the runtime Interface
    import mmmpc_tpu.runtime.interface as ri
    expect = np.array([
        sc.global_pose_target[0]
        - ri.WORKING_RADIUS * np.cos(sc.global_pose_target[3]),
        sc.global_pose_target[1]
        - ri.WORKING_RADIUS * np.sin(sc.global_pose_target[3]),
        sc.global_pose_target[3], 0, 0, 0,
        sc.x_start[6], sc.x_start[7], sc.x_start[8]])
    np.testing.assert_allclose(np.asarray(xt), expect, atol=1e-12)


def _scenario1_stall_setup():
    """The straggler state family from the fleet bench: AT the stand-off
    target with jittered arm joints and a few cm of base offset."""
    from mmmpc_tpu.utils.configs import SolverConfig

    sc = make_scenario(1, N=20)
    cfg = SolverConfig(al_iters=6, ilqr_iters=12, cost_scale=1e5,
                       constraint_tol=1e-3, n_alpha=3, alpha_decay=0.35)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=20,
                       solver_config=cfg)
    xt = np.asarray(stand_off_target(jnp.asarray(sc.x_start),
                                     jnp.asarray(sc.global_pose_target)))
    # seed-0 probe state measured to stall (steady-state pos err 2.4 cm >
    # the 1 cm exit tolerance) in both loops
    rng = np.random.default_rng(0)
    jb = rng.standard_normal(8), rng.standard_normal(8), \
        rng.standard_normal(8), rng.standard_normal((8, 3))
    x0 = xt.copy()
    x0[0] += 0.05 * jb[0][0]
    x0[1] += 0.05 * jb[1][0]
    x0[2] += 0.02 * jb[2][0]
    x0[6:] += 0.08 * jb[3][0]
    return sc, cfg, mpc, x0, xt


def _fleet_run(sc, cfg, mpc, x0, n_ticks, **loop_kw):
    shared = mpc.make_params(np.zeros((21, 9)), np.zeros((20, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    run = jax.jit(make_batch_task_loop(
        mpc.ocp, cfg, shared, t_move=sc.t_move,
        t_manipulate=sc.t_manipulate, dt=sc.dt, n_ticks=n_ticks,
        ik_iters=40, **loop_kw))
    gpt = np.asarray(sc.global_pose_target, float)[None]
    log, _ = run(jnp.asarray(x0[None]), jnp.asarray(gpt))
    return log


@pytest.mark.slow
def test_rotate_stall_host_parity_and_recovery():
    """Pins the fleet-bench straggler claim:

    (a) a state that stalls the fleet engine's rotate phase stalls the host
        Interface identically from the same state — the ~10% fleet
        stragglers are the reference's brittle 1 cm / 0.5 deg rotate-exit
        tolerances (interface_wholebody_qref.py:192-197), not an engine bug;
    (b) the opt-in relaxed-exit recovery config clears the same state
        (parity default unchanged).
    """
    from mmmpc_tpu.runtime import Interface
    from mmmpc_tpu.sim.batch_task_engine import PHASE_ROTATE

    sc, cfg, mpc, x0, xt = _scenario1_stall_setup()
    T = 40

    # (a1) fleet engine, parity tolerances: stuck in rotate
    log = _fleet_run(sc, cfg, mpc, x0, T)
    assert int(np.asarray(log.phase)[0, -1]) == PHASE_ROTATE
    pos_err = float(np.linalg.norm(np.asarray(log.X)[0, -1, :2] - xt[:2]))
    assert pos_err > 0.01        # steady-state offset beyond the tolerance

    # (a2) host Interface from the IDENTICAL state: same stall
    world = Interface(sc.dt, sc.t_move, sc.t_manipulate, x0,
                      sc.global_pose_target, mpc, physical_sim=False,
                      max_mpc_steps=T)
    world.run()
    assert world.task_flag == "rotate", world.task_flag
    host_err = float(np.linalg.norm(
        np.asarray(world.current_state)[:2] - xt[:2]))
    assert host_err > 0.01
    # both loops settle to the same out-of-tolerance equilibrium
    assert abs(host_err - pos_err) < 0.01

    # (b) opt-in recovery: aim-at-button rotate target + 5 cm exit position
    # tolerance (yaw tolerance unchanged) clears the stall AND completes
    # the press — the arm plane contains the button from the settled
    # position, so the 1 cm end-effector check passes despite the base
    # offset.  (A blanket yaw relaxation would exit rotate but leave an
    # uncompensable lateral miss; see the engine docstring.)
    from mmmpc_tpu.sim.batch_task_engine import PHASE_DONE as _DONE
    log_rec = _fleet_run(sc, cfg, mpc, x0, 100,      # completes at tick ~77
                         rotate_exit_pos_tol=0.05, aim_at_button=True)
    assert int(np.asarray(log_rec.phase)[0, -1]) == _DONE


@pytest.mark.slow
def test_host_fleet_completion_distribution():
    """Distribution-level host parity: jittered
    scenario-1 tasks through the HOST Interface loop, same jitter
    seeds/order as the fleet bench, completion compared against the
    engine's measured rate.

    The full K=64 measurement is scripts/host_fleet_parity.py (stall modes
    rotate + manipulate on both sides, BASELINE.md).  This slow test
    replays the FIRST K=8 of those robots: at the measured p ~= 0.9,
    P(X <= 4 | p=0.9) < 1%, so >= 5/8 completions is a sound guard that
    the host loop has not drifted from the engine's completion regime.
    """
    import importlib.util
    import multiprocessing as mp
    import os

    spec = importlib.util.spec_from_file_location(
        "host_fleet_parity", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts", "host_fleet_parity.py"))
    hfp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hfp)

    sc = make_scenario(1, N=hfp.N)
    rng = np.random.default_rng(0)
    x0 = np.tile(sc.x_start, (hfp.FLEET_BATCH, 1)).astype(np.float32)
    x0[:, 6:] += (0.05 * rng.standard_normal((hfp.FLEET_BATCH, 3))
                  ).astype(np.float32)
    K = 8
    jobs = [(i, x0[i].astype(float), 1, 400) for i in range(K)]
    with mp.get_context("spawn").Pool(2) as pool:
        results = list(pool.imap_unordered(hfp._worker, jobs))
    n_done = sum(r["done"] for r in results)
    assert n_done >= 5, (
        f"host Interface completed only {n_done}/8 jittered tasks "
        f"(engine parity rate 89.55%, host K=64 rate 93.75%); "
        f"flags: {[r['final_flag'] for r in results]}")
