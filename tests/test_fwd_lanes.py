"""Parity of the fused forward line-search kernel (ops/wholebody_fwd.py)
and the batch-minor lanes solver path against the pure-JAX implementations.

Runs the kernel in Pallas interpreter mode on CPU (``interpret=True``), in
float32 (the kernel's native precision — the f64 oracle comparisons live in
the solver tests).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmmpc_tpu.controllers import MPCWholeBody
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import MobileManipulator
from mmmpc_tpu.ops.wholebody_fwd import BLOCK
from mmmpc_tpu.solver import al_ilqr_solve_batched
from mmmpc_tpu.solver.al_ilqr import build_core, rollout
from mmmpc_tpu.solver.batched import solve_batched_lanes
from mmmpc_tpu.utils.configs import SolverConfig

B, N = 128, 5
F32 = jnp.float32


@pytest.fixture()
def problem():
    cfg = SolverConfig(al_iters=2, ilqr_iters=4, n_alpha=3, alpha_decay=0.4,
                       cost_scale=1e5, scan_unroll=5)
    # one ground obstacle + one half-plane so every constraint family is live
    mpc = MPCWholeBody(
        MobileManipulator(0.1), [Obstacles(1.0, 0.2, 0.3)],
        [(np.array([0.8, 0.1, 1.0]), np.array([[1.0, 0.0, 0.0]]))],
        N=N, solver_config=cfg)
    rng = np.random.default_rng(7)
    x0 = np.zeros(9)
    x0[6:] = [-np.pi / 4, -np.pi / 2, np.pi / 2]
    x0_b = jnp.asarray(
        x0[None] + 0.02 * rng.standard_normal((B, 9))
        * np.array([1, 1, 0.2, 0, 0, 0, 0.1, 0.1, 0.1]), F32)
    U0_b = jnp.asarray(0.1 * rng.standard_normal((B, N, 5)), F32)
    target = np.concatenate([[0.5, 0.1, 0, 0, 0, 0], x0[6:]])
    traj = jnp.asarray(np.linspace(x0, target, N + 1), F32)
    params = dict(mpc.make_params(traj, np.zeros((N, 5))),
                  U_last=jnp.zeros((N, 5), F32))
    params = jax.tree.map(lambda a: jnp.asarray(a, F32), params)
    return mpc, cfg, x0_b, U0_b, params


def _fwd_inputs(ocp, core, x0_b, U0_b, params, B):
    rng = np.random.default_rng(11)
    X_b, Uc_b = jax.vmap(lambda x0, U: rollout(ocp, x0, U, params))(
        x0_b, U0_b)
    kffs = jnp.asarray(0.05 * rng.standard_normal((B, N, 5)), F32)
    Ks = jnp.asarray(0.05 * rng.standard_normal((B, N, 5, 9)), F32)
    lam = jnp.asarray(np.abs(rng.standard_normal((B, N, core.nc))), F32)
    lam_t = jnp.asarray(np.abs(rng.standard_normal((B, core.nct))), F32)
    lam_e = jnp.zeros((B, core.ne), F32)
    return X_b, Uc_b, kffs, Ks, lam, lam_t, lam_e


def _bm(X_b, Uc_b, kffs, Ks, lam, lam_t, lam_e):
    """Batch-major kernel inputs -> the kernel's batch-minor layout."""
    t = jnp.transpose
    return (t(X_b[:, :-1], (1, 2, 0)), t(Uc_b, (1, 2, 0)),
            t(kffs, (1, 2, 0)), t(Ks, (1, 2, 3, 0)), t(lam, (1, 2, 0)),
            lam_t.T, lam_e.T)


def test_fwd_kernel_matches_fwd_pass(problem):
    """One fused-kernel call == vmapped core.fwd_pass for every candidate."""
    mpc, cfg, x0_b, U0_b, params = problem
    ocp = mpc.ocp
    core = build_core(ocp, params, cfg, F32)
    X_b, Uc_b, kffs, Ks, lam, lam_t, lam_e = _fwd_inputs(
        ocp, core, x0_b, U0_b, params, B)
    mu = jnp.asarray(10.0, F32)
    alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=F32)

    # reference: per-scenario fwd_pass vmapped over (alpha, batch)
    fwd_b = jax.vmap(core.fwd_pass, in_axes=(0, 0, 0, 0, 0, None, 0, None))
    Xr, Ur, cr = jax.vmap(
        lambda a: fwd_b(X_b[:, 0], X_b, Uc_b, kffs, Ks, a,
                        (lam, lam_t, lam_e), mu))(alphas)
    # Xr: (n_alpha, B, N+1, nx); cr: (n_alpha, B) including terminal AL cost

    # kernel: batch-minor; the terminal AL cost is fused in-kernel
    fwd_ls = ocp.lanes_fwd_factory(cfg, interpret=True)
    Xc, Uc, xlast, cc_tot = fwd_ls(
        *_bm(X_b, Uc_b, kffs, Ks, lam, lam_t, lam_e), mu, params)

    # Xc: (N, n_alpha, nx, B) -> (n_alpha, B, N, nx)
    Xk = np.transpose(np.asarray(Xc), (1, 3, 0, 2))
    Uk = np.transpose(np.asarray(Uc), (1, 3, 0, 2))
    xl = np.transpose(np.asarray(xlast), (0, 2, 1))  # (n_alpha, B, nx)

    np.testing.assert_allclose(Xk, np.asarray(Xr[:, :, :-1]), atol=2e-5)
    np.testing.assert_allclose(xl, np.asarray(Xr[:, :, -1]), atol=2e-5)
    np.testing.assert_allclose(Uk, np.asarray(Ur), atol=2e-5)
    # costs are ~1e4 in scaled units spread over N stages; f32 op-order
    # differences show up at ~1e-3 relative
    np.testing.assert_allclose(np.asarray(cc_tot), np.asarray(cr),
                               rtol=2e-3, atol=2e-3)


def test_lanes_solve_matches_batch_major(problem):
    """Full batch-minor lanes solve vs the batch-major (vmap) path."""
    mpc, cfg, x0_b, U0_b, params = problem
    res_lanes = solve_batched_lanes(mpc.ocp, x0_b, U0_b, params, cfg,
                                    interpret=True)
    res_major = al_ilqr_solve_batched(mpc.ocp, x0_b, U0_b, params, cfg)

    S = 64   # compare a slice (full-batch comparison is just more of same)
    np.testing.assert_allclose(np.asarray(res_lanes.U[:S]),
                               np.asarray(res_major.U[:S]),
                               atol=5e-3)
    np.testing.assert_allclose(np.asarray(res_lanes.cost[:S]),
                               np.asarray(res_major.cost[:S]),
                               rtol=5e-3)
    np.testing.assert_allclose(np.asarray(res_lanes.max_violation[:S]),
                               np.asarray(res_major.max_violation[:S]),
                               atol=1e-3)


def test_lanes_per_scenario_ulast(problem):
    """Fleet serving: per-scenario U_last (each robot's previous command
    sequence) through the fused kernel and the lanes backward matches the
    per-scenario vmap path."""
    mpc, cfg, x0_b, U0_b, params = problem

    rng = np.random.default_rng(3)
    ulast_b = jnp.asarray(0.2 * rng.standard_normal((N, 5, B)), F32)
    params_ps = dict(params, U_last=ulast_b)

    res_lanes = solve_batched_lanes(mpc.ocp, x0_b, U0_b, params_ps, cfg,
                                    interpret=True)

    # oracle: per-scenario vmap of the scan solver with mapped U_last
    res_ref = al_ilqr_solve_batched(mpc.ocp, x0_b, U0_b, params_ps, cfg)
    S = 64
    np.testing.assert_allclose(np.asarray(res_lanes.U[:S]),
                               np.asarray(res_ref.U[:S]), atol=5e-3)
    np.testing.assert_allclose(np.asarray(res_lanes.cost[:S]),
                               np.asarray(res_ref.cost[:S]), rtol=5e-3)
    # and differs from the shared-U_last solve (the feature has an effect)
    res_shared = solve_batched_lanes(mpc.ocp, x0_b, U0_b, params, cfg,
                                     interpret=True)
    assert float(jnp.max(jnp.abs(res_shared.U - res_lanes.U))) > 1e-4


@pytest.mark.slow
def test_lanes_per_scenario_task_params(problem):
    """Fleet TASK serving: per-scenario X_ref / U_ref / Q / P / eq_mask /
    U_last (each robot's phase owns its reference window, weight-table row
    and terminal-equality mask — sim/batch_task_engine.py) through the
    lanes path matches the per-scenario vmap path.

    Tolerance note: the comparison is quantile-based.  A ~1e-6 float
    reassociation in the per-candidate costs (scalar-broadcast vs tile
    multiply) can flip near-tied line-search argmins, and one flipped
    iterate diverges two otherwise-identical solver trajectories — the
    same knife-edge class BASELINE.md documents for batch-vs-single
    lowering.  Exact per-operand wiring is pinned separately by
    test_lanes_ps_mask_invariant below."""
    mpc, cfg, x0_b, U0_b, params = problem

    rng = np.random.default_rng(5)
    # per-robot reference windows NEAR each robot's own start so the
    # injected terminal equality is feasible (an infeasible equality puts
    # the AL loop in the high-penalty knife-edge regime where unrelated
    # 1e-6 differences flip line-search argmins and trajectories diverge)
    xref_b = jnp.asarray(
        np.moveaxis(np.asarray(x0_b), 0, -1)[None, :, :]
        + 0.02 * rng.standard_normal((N + 1, 9, B)), F32)
    uref_b = jnp.asarray(0.05 * rng.standard_normal((N, 5, B)), F32)
    ulast_b = jnp.asarray(0.2 * rng.standard_normal((N, 5, B)), F32)
    # per-robot DIAGONAL weight rows (the task engine's Wtab selections)
    wtab = np.stack([
        5.0 * np.diag([5, 5, 0, 0, 0, 1, 1, 1, 1.0]),
        np.diag([5, 5, 5, 0, 0, 1, 1, 1, 1.0]),
        np.diag([500, 500, 500, 0, 0, 1, 1, 1, 1.0]),
    ])
    widx = rng.integers(0, 3, B)
    q_b = jnp.asarray(np.moveaxis(wtab[widx], 0, -1), F32)   # (9, 9, B)
    eqm_b = jnp.asarray((rng.random(B) < 0.5).astype(np.float32))
    params_ps = dict(params, X_ref=xref_b, U_ref=uref_b, U_last=ulast_b,
                     Q=q_b, P=q_b, eq_mask=eqm_b)

    res_lanes = solve_batched_lanes(mpc.ocp, x0_b, U0_b, params_ps, cfg,
                                    interpret=True)

    # oracle: per-scenario vmap of the scan solver with every entry mapped
    res_ref = al_ilqr_solve_batched(mpc.ocp, x0_b, U0_b, params_ps, cfg)
    per_robot = np.max(np.abs(np.asarray(res_lanes.U - res_ref.U)),
                       axis=(1, 2))
    assert np.median(per_robot) < 1e-4
    assert np.mean(per_robot > 5e-3) < 0.05, (
        f"{np.mean(per_robot > 5e-3):.1%} of robots diverged > 5e-3")
    # and differs from the shared-params solve (the features have effect)
    res_shared = solve_batched_lanes(mpc.ocp, x0_b, U0_b, params, cfg,
                                     interpret=True)
    assert float(jnp.max(jnp.abs(res_shared.U - res_lanes.U))) > 1e-4


def test_lanes_ps_mask_invariant(problem):
    """EXACT per-operand wiring check, kernel level: per-scenario all-ones
    eq_mask / all-identical diagonal Q,P must reproduce the shared-scalar /
    shared-dense kernel outputs on identical inputs (forward candidate
    costs to float-reassociation tolerance)."""
    mpc, cfg, x0_b, U0_b, params = problem

    rng = np.random.default_rng(9)
    X_bm = jnp.asarray(0.1 * rng.standard_normal((N + 1, 9, B)), F32)
    U_bm = jnp.asarray(0.1 * rng.standard_normal((N, 5, B)), F32)
    lam_bm = jnp.abs(jnp.asarray(
        0.1 * rng.standard_normal((N, 28, B)), F32))
    lamt_bm = jnp.abs(jnp.asarray(0.1 * rng.standard_normal((18, B)), F32))
    lame_bm = jnp.asarray(0.1 * rng.standard_normal((2, B)), F32)
    kff_bm = jnp.asarray(0.01 * rng.standard_normal((N, 5, B)), F32)
    K_bm = jnp.asarray(0.01 * rng.standard_normal((N, 5, 9, B)), F32)
    mu = 50.0

    wrow = np.diag([5, 5, 5, 0, 0, 1, 1, 1, 1.0])
    p_shared = dict(params, eq_mask=jnp.asarray(1.0, F32),
                    Q=jnp.asarray(wrow, F32), P=jnp.asarray(wrow, F32))
    p_ps = dict(
        params, eq_mask=jnp.ones((B,), F32),
        Q=jnp.asarray(np.repeat(wrow[:, :, None], B, axis=2), F32),
        P=jnp.asarray(np.repeat(wrow[:, :, None], B, axis=2), F32))

    fwd = mpc.ocp.lanes_fwd_factory(cfg, interpret=True)
    o1 = fwd(X_bm[:-1], U_bm, kff_bm, K_bm, lam_bm, lamt_bm, lame_bm, mu,
             p_shared)
    o2 = fwd(X_bm[:-1], U_bm, kff_bm, K_bm, lam_bm, lamt_bm, lame_bm, mu,
             p_ps)
    for a, b in zip(o1, o2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("batch", [1, 100, 300])
def test_fwd_kernel_pads_any_batch(problem, batch):
    """The wrapper takes any batch: it pads to the kernel block, and each
    scenario's outputs are those it gets inside a block-aligned batch."""
    mpc, cfg, x0_b, U0_b, params = problem
    ocp = mpc.ocp
    core = build_core(ocp, params, cfg, F32)
    big = -(-batch // BLOCK) * BLOCK
    reps = -(-big // B)
    x0_big = jnp.tile(x0_b, (reps, 1))[:big]
    U0_big = jnp.tile(U0_b, (reps, 1, 1))[:big]
    inputs = _bm(*_fwd_inputs(ocp, core, x0_big, U0_big, params, big))
    fwd_ls = ocp.lanes_fwd_factory(cfg, interpret=True)
    mu = jnp.asarray(10.0, F32)
    out_big = fwd_ls(*inputs, mu, params)
    out = fwd_ls(*[a[..., :batch] for a in inputs], mu, params)
    shapes = [(N, cfg.n_alpha, 9, batch), (N, cfg.n_alpha, 5, batch),
              (cfg.n_alpha, 9, batch), (cfg.n_alpha, batch)]
    for a, b, shape in zip(out, out_big, shapes):
        assert a.shape == shape
        np.testing.assert_array_equal(np.asarray(a),
                                      np.asarray(b[..., :batch]))
