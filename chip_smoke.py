"""Smoke test of the whole-body MPC main path on an NVIDIA GPU.

Run from the root of a checkout on a machine with one card:

    python chip_smoke.py

Phases, none of whose failures is caught:

1. print the card's name and power limit (nvidia-smi), the JAX version and
   the XLA flags in force;
2. refuse to go on unless JAX's first device is a GPU;
3. at bench.py's shapes (batch 8192, N = 20, scenario-1 constraint stack):
   - the fused forward kernel against the plain vmapped rollout +
     candidate cost;
   - the whole two-stage solve through ``batch_solve_refined_fn`` on the
     kernel path and on the plain XLA path;
   - the fleet task loop, 1024 robots for 30 ticks with per-robot params,
     on both paths;
4. one single-robot tick through ``solve_fn``, as scripts/rt_latency.py.

``--four-cards`` runs instead, and nothing else, the data-parallel path over
a 1-D mesh of four cards, as bench.py runs it on four cards
(``sharded_solve_fn`` of the two-stage solve at batch 4 x 8192, then
``sharded_task_loop_fn``), against the same inputs on one card.  Cold, it
compiles for more than seven minutes: give it a time limit of 20 minutes.

The programs of a run are compiled in parallel threads before any is run.
The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from mmmpc_tpu.controllers import MPCWholeBody  # noqa: E402
from mmmpc_tpu.models.obstacles import Obstacles  # noqa: E402
from mmmpc_tpu.models.robots import MobileManipulator  # noqa: E402
from mmmpc_tpu.parallel import (  # noqa: E402
    make_mesh, sharded_solve_fn, sharded_task_loop_fn,
)
from mmmpc_tpu.parallel.data_parallel import _with_stats  # noqa: E402
from mmmpc_tpu.sim.batch_task_engine import make_batch_task_loop  # noqa: E402
from mmmpc_tpu.solver import al_ilqr_solve  # noqa: E402
from mmmpc_tpu.solver.al_ilqr import build_core, rollout  # noqa: E402
from mmmpc_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from mmmpc_tpu.utils.configs import SolverConfig, make_scenario  # noqa: E402

F32 = jnp.float32
FLEET_CFG = SolverConfig(al_iters=6, ilqr_iters=12, cost_scale=1e5,
                         constraint_tol=1e-3, n_alpha=3, alpha_decay=0.35)
RT_CFG = SolverConfig(al_iters=3, ilqr_iters=6, ilqr_iters_later=4,
                      cost_scale=1e5, constraint_tol=1e-3, n_alpha=3,
                      alpha_decay=0.35, scan_unroll=10)


def log(*a):
    print(*a, flush=True)


def card_header():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; compile cache {enable_compile_cache()}")


def compile_all(jobs):
    """jobs: name -> (fn, args).  Traces each in turn, then compiles all in
    parallel threads.  Returns name -> compiled executable."""
    t0 = time.perf_counter()
    lowered = {n: jax.jit(f).lower(*a) for n, (f, a) in jobs.items()}
    t1 = time.perf_counter()
    with ThreadPoolExecutor(len(lowered)) as ex:
        futs = {n: ex.submit(low.compile) for n, low in lowered.items()}
        out = {n: f.result() for n, f in futs.items()}
    log(f"traced {len(jobs)} programs in {t1 - t0:.1f} s, compiled them in "
        f"{time.perf_counter() - t1:.1f} s")
    return out


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def refine_cfg_of(cfg):
    from mmmpc_tpu.solver.refine import continue_mu
    return continue_mu(cfg, cfg.al_iters, al_iters=bench.REFINE_ROUNDS,
                       ilqr_iters=bench.REFINE_SWEEPS,
                       ilqr_iters_later=bench.REFINE_SWEEPS,
                       ilqr_iters_final=None)


def solve_program(mpc, use_kernels):
    """The batched solve bench.py times, on the kernel or the XLA path."""
    cfg = dataclasses.replace(bench.SOLVER_CFG, use_kernels=use_kernels)
    ctl = MPCWholeBody(mpc.robot_model, mpc.obstacle_list,
                       mpc.obstacle_manipulation_list, N=mpc.N,
                       solver_config=cfg)
    rc = dataclasses.replace(refine_cfg_of(bench.SOLVER_CFG),
                             use_kernels=use_kernels)
    return ctl.batch_solve_refined_fn(refine_cfg=rc)


def fleet_problem(batch, n_ticks, use_kernels, cfg=FLEET_CFG):
    sc = make_scenario(1, N=bench.N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    mpc = MPCWholeBody(MobileManipulator(sc.dt),
                       [Obstacles(*row) for row in sc.ground_obstacles], hp,
                       N=bench.N, solver_config=cfg)
    shared = mpc.make_params(np.zeros((bench.N + 1, 9)),
                             np.zeros((bench.N, 5)))
    for k in ("X_ref", "U_ref"):
        shared.pop(k)
    shared = jax.tree.map(lambda a: jnp.asarray(a, F32), shared)
    loop = make_batch_task_loop(
        mpc.ocp, dataclasses.replace(cfg, use_kernels=use_kernels),
        shared, t_move=sc.t_move, t_manipulate=sc.t_manipulate, dt=sc.dt,
        n_ticks=n_ticks, ik_iters=40)
    rng = np.random.default_rng(0)
    x0 = np.tile(sc.x_start, (batch, 1)).astype(np.float32)
    x0[:, 6:] += (0.05 * rng.standard_normal((batch, 3))).astype(np.float32)
    gpt = np.tile(np.asarray(sc.global_pose_target, np.float32), (batch, 1))
    return loop, jnp.asarray(x0), jnp.asarray(gpt)


def check_solve(name, res, stats, batch):
    conv = float(stats.n_converged) / batch
    viol = float(stats.max_violation)
    log(f"{name}: converged {conv}, max violation {viol}, "
        f"mean cost {float(stats.mean_cost)}")
    assert bool(jnp.all(jnp.isfinite(res.U))), name
    assert conv == 1.0 and viol <= 1e-3, (name, conv, viol)


def compare_costs(a, b, label):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
    frac = float(np.mean(rel <= 5e-3))
    log(f"{label}: cost rel diff <= 5e-3 for {frac:.4%}, "
        f"p99 {np.percentile(rel, 99):.3e}, max {rel.max():.3e}")
    assert frac >= 0.99, (label, frac)


def fleet_spread(log_a, log_b):
    """Per-robot max |dX| of two fleet runs after each tick: (B, T + 1)."""
    Xa, Xb = np.asarray(log_a.X), np.asarray(log_b.X)
    assert np.isfinite(Xa).all() and np.isfinite(Xb).all()
    return np.abs(Xa - Xb).max(axis=2)


def compare_fleets(log_k, log_x, label, log_c=None):
    """log_k: the run under test; log_x: its reference; log_c: the
    reference run again from start states moved by ~1e-5 (the control).

    The first tick starts both from the same states, so its states must
    agree.  Later ticks are reported, not asserted one by one: closed-loop
    float32 runs drift apart, and the control measures how far rounding
    alone takes them.  The run under test must stay within ten times the
    control's median spread at the last tick, and the task phases must
    agree."""
    err = fleet_spread(log_k, log_x)
    first = float(np.mean(err[:, 1] <= 1e-2))
    last = float(np.mean(err[:, -1] <= 1e-2))
    pk, px = np.asarray(log_k.phase)[:, -1], np.asarray(log_x.phase)[:, -1]
    n_bins = int(max(pk.max(), px.max())) + 1
    hist_k = np.bincount(pk, minlength=n_bins)
    hist_x = np.bincount(px, minlength=n_bins)
    moved = int(np.abs(hist_k - hist_x).sum()) / 2
    log(f"{label}: X within 1e-2 after tick 1 for {first:.2%} of robots "
        f"(worst {err[:, 1].max():.3e}), after the last tick for {last:.2%} "
        f"(median {np.median(err[:, -1]):.3e}, worst robot "
        f"{err[:, -1].max():.3e}); final phase histograms "
        f"{hist_k.tolist()} vs {hist_x.tolist()}")
    assert first >= 0.99, (label, first)
    assert moved <= 0.01 * len(pk), (label, hist_k, hist_x)
    if log_c is not None:
        ctl = fleet_spread(log_c, log_x)
        log(f"{label} control (reference vs itself from start states moved "
            f"by 1e-5): after tick 1 worst {ctl[:, 1].max():.3e}; after the "
            f"last tick within 1e-2 for {np.mean(ctl[:, -1] <= 1e-2):.2%}, "
            f"median {np.median(ctl[:, -1]):.3e}, worst robot "
            f"{ctl[:, -1].max():.3e}")
        assert np.median(err[:, -1]) <= 10 * np.median(ctl[:, -1]), label


def fwd_parity_programs(mpc, x0_b, U0_b, params):
    """The fused forward kernel and its plain equivalent (vmapped rollout
    + candidate cost) on the same random gains and multipliers."""
    cfg = bench.SOLVER_CFG
    ocp = mpc.ocp
    N = ocp.N
    B = x0_b.shape[0]
    core = build_core(ocp, params, cfg, F32)
    rng = np.random.default_rng(1)
    X_b, Uc_b = jax.jit(jax.vmap(
        lambda x0, U: rollout(ocp, x0, U, params)))(x0_b, U0_b)
    kffs = jnp.asarray(0.05 * rng.standard_normal((B, N, 5)), F32)
    Ks = jnp.asarray(0.05 * rng.standard_normal((B, N, 5, 9)), F32)
    lam = jnp.asarray(0.5 * np.abs(rng.standard_normal((B, N, core.nc))),
                      F32)
    lam_t = jnp.asarray(0.5 * np.abs(rng.standard_normal((B, core.nct))),
                        F32)
    lam_e = jnp.asarray(0.1 * rng.standard_normal((B, core.ne)), F32)
    mu = jnp.asarray(10.0, F32)
    alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=F32)
    fwd_k = ocp.lanes_fwd_factory(cfg)

    def plain(X_b, Uc_b, kffs, Ks, lam, lam_t, lam_e, mu):
        with jax.default_matmul_precision("highest"):
            fwd_b = jax.vmap(core.fwd_pass,
                             in_axes=(0, 0, 0, 0, 0, None, 0, None))
            return jax.vmap(lambda a: fwd_b(
                X_b[:, 0], X_b, Uc_b, kffs, Ks, a, (lam, lam_t, lam_e),
                mu))(alphas)

    def kernel(X_b, Uc_b, kffs, Ks, lam, lam_t, lam_e, mu):
        t = jnp.transpose
        return fwd_k(t(X_b[:, :-1], (1, 2, 0)), t(Uc_b, (1, 2, 0)),
                     t(kffs, (1, 2, 0)), t(Ks, (1, 2, 3, 0)),
                     t(lam, (1, 2, 0)), lam_t.T, lam_e.T, mu, params)

    args = (X_b, Uc_b, kffs, Ks, lam, lam_t, lam_e, mu)
    return (plain, args), (kernel, args)


def check_fwd_parity(ref, out):
    Xr, Ur, cr = (np.asarray(a) for a in ref)
    Xc, Uc, xl, cc = (np.asarray(a) for a in out)
    errs = dict(
        X=np.abs(np.transpose(Xc, (1, 3, 0, 2)) - Xr[:, :, :-1]).max(),
        U=np.abs(np.transpose(Uc, (1, 3, 0, 2)) - Ur).max(),
        xlast=np.abs(np.transpose(xl, (0, 2, 1)) - Xr[:, :, -1]).max())
    log("fwd kernel vs plain: max |dX| {X:.3e}, |dU| {U:.3e}, "
        "|dxlast| {xlast:.3e}".format(**errs)
        + f", max |dcc| {np.abs(cc - cr).max():.3e}")
    assert all(v <= 1e-4 for v in errs.values()), errs
    np.testing.assert_allclose(cc, cr, rtol=2e-3, atol=2e-3)


def single_card(B=bench.BATCH, fleet=1024, ticks=30):
    mpc, x0_b, U0_b, params = bench.build_problem(B)
    fwd_plain, fwd_kernel = fwd_parity_programs(mpc, x0_b, U0_b, params)
    loop_k, fx, fg = fleet_problem(fleet, ticks, True)
    loop_x, _, _ = fleet_problem(fleet, ticks, False)
    ocp = mpc.ocp
    x1, U1 = x0_b[0], jnp.zeros((bench.N, 5), F32)
    progs = compile_all({
        "fwd_plain": fwd_plain, "fwd_kernel": fwd_kernel,
        "solve_kernel": (_with_stats(solve_program(mpc, True)),
                         (x0_b, U0_b, params)),
        "solve_xla": (_with_stats(solve_program(mpc, False)),
                      (x0_b, U0_b, params)),
        "fleet_kernel": (lambda x, g: loop_k(x, g)[0], (fx, fg)),
        "fleet_xla": (lambda x, g: loop_x(x, g)[0], (fx, fg)),
        "tick": (lambda x, u, p: al_ilqr_solve(ocp, x, u, p, RT_CFG),
                 (x1, U1, params)),
    })

    check_fwd_parity(progs["fwd_plain"](*fwd_plain[1]),
                     progs["fwd_kernel"](*fwd_kernel[1]))

    (res_k, st_k), t_k = timed(progs["solve_kernel"], x0_b, U0_b, params)
    (res_x, st_x), t_x = timed(progs["solve_xla"], x0_b, U0_b, params)
    log(f"two-stage solve at batch {B}: kernel path {t_k:.4f} s, XLA path "
        f"{t_x:.4f} s (one call each, after compilation)")
    check_solve("kernel path", res_k, st_k, B)
    check_solve("XLA path", res_x, st_x, B)
    compare_costs(res_k.cost, res_x.cost, "kernel vs XLA solve")

    log_k, t_fk = timed(progs["fleet_kernel"], fx, fg)
    log_x, t_fx = timed(progs["fleet_xla"], fx, fg)
    log(f"fleet {fleet} robots x {ticks} ticks: kernel path {t_fk:.3f} s, "
        f"XLA path {t_fx:.3f} s")
    kick = np.random.default_rng(2).standard_normal(fx.shape)
    log_c = progs["fleet_xla"](fx + jnp.asarray(1e-5 * kick, F32), fg)
    compare_fleets(log_k, log_x, "fleet", log_c)

    res1, t1 = timed(progs["tick"], x1, U1, params)
    log(f"single-robot tick: {t1 * 1e3:.2f} ms, violation "
        f"{float(res1.max_violation):.3e}")
    assert res1.U.shape == (bench.N, 5)
    assert bool(jnp.all(jnp.isfinite(res1.U)))


def four_cards(per_card=bench.BATCH, fleet_per_card=256):
    """bench.py's sharded solve against bench.py's one-card program.

    Each shard runs the two-stage solve on its own 8192 scenarios and
    refines its own worst 1024, so the one-card reference is the one-card
    program run on each quarter of the batch in turn."""
    devices = jax.devices()
    assert len(devices) == 4, f"--four-cards needs 4 devices, {len(devices)}"
    mesh = make_mesh(devices)
    B = 4 * per_card
    mpc, x0_b, U0_b, params = bench.build_problem(B)
    impl = solve_program(mpc, True)
    sharded = sharded_solve_fn(mpc.solve_fn(), mesh, batch_impl=impl)
    single = jax.jit(_with_stats(impl))         # default device: card 0
    # a short fleet schedule keeps the four-card compile short; the path
    # (kernel per shard, sharded carry) is the same
    loop, fx, fg = fleet_problem(
        4 * fleet_per_card, 5, True,
        dataclasses.replace(FLEET_CFG, al_iters=1, ilqr_iters=12))
    loop_sh = sharded_task_loop_fn(loop, mesh)
    quarters = [slice(i * per_card, (i + 1) * per_card) for i in range(4)]

    def run_single(x0, U0):
        outs = [single(x0[q], U0[q], params) for q in quarters]
        res = jax.tree.map(lambda *a: jnp.concatenate(a), *[r for r, _ in outs])
        return jax.block_until_ready(res)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        futs = {
            "sharded solve": ex.submit(lambda: jax.block_until_ready(
                sharded(x0_b, U0_b, params))),
            "one-card solve": ex.submit(run_single, x0_b, U0_b),
            "sharded fleet": ex.submit(lambda: jax.block_until_ready(
                loop_sh(fx, fg))),
            "one-card fleet": ex.submit(lambda: jax.block_until_ready(
                jax.jit(loop)(fx, fg))),
        }
        names = {f: n for n, f in futs.items()}
        for f in as_completed(names):
            f.result()
            log(f"{names[f]}: compiled and ran by "
                f"{time.perf_counter() - t0:.1f} s")
    (res_s, st_s), t_s = timed(sharded, x0_b, U0_b, params)
    res_1, t_1 = timed(run_single, x0_b, U0_b)
    log(f"two-stage solve at batch {B}: 4 cards {t_s:.4f} s, 1 card "
        f"{t_1:.4f} s (4 calls of {per_card})")

    # the psum / pmax / pmean stats against the gathered per-scenario results
    assert float(st_s.n_solved) == B
    assert float(st_s.n_converged) == float(np.sum(np.asarray(res_s.converged)))
    assert float(st_s.max_violation) == float(np.max(np.asarray(
        res_s.max_violation)))
    np.testing.assert_allclose(float(st_s.mean_cost),
                               float(np.mean(np.asarray(res_s.cost))),
                               rtol=1e-4)
    log(f"4 cards: converged {float(st_s.n_converged) / B}, max violation "
        f"{float(st_s.max_violation)}; 1 card: converged "
        f"{float(np.mean(np.asarray(res_1.converged)))}, max violation "
        f"{float(np.max(np.asarray(res_1.max_violation)))}")
    assert bool(jnp.all(jnp.isfinite(res_s.U)))
    dU = np.abs(np.asarray(res_s.U) - np.asarray(res_1.U)).max(axis=(1, 2))
    log(f"per-scenario |dU| 4 cards vs 1 card: max {dU.max():.3e}, "
        f"share <= 1e-3 {np.mean(dU <= 1e-3):.4%}")
    compare_costs(res_s.cost, res_1.cost, "4 cards vs 1 card solve")
    (log_s, _), (log_1, _) = (futs["sharded fleet"].result(),
                              futs["one-card fleet"].result())
    compare_fleets(log_s, log_1, "fleet 4 cards vs 1 card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the data-parallel path on four cards")
    args = ap.parse_args()

    if shutil.which("nvidia-smi") is None:
        sys.exit("chip_smoke: nvidia-smi not found; this needs an NVIDIA "
                 "GPU")
    card_header()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: JAX's first device is {dev.platform!r}, "
                 "not a GPU")
    if args.four_cards:
        four_cards()
    else:
        single_card()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
