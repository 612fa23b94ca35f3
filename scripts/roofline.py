"""Work counters for the flagship qref solver: FLOPs and bytes per solve.

- exact implementation FLOPs of the fused forward kernel, counted from its
  kernel jaxpr (every float elementwise primitive x its element count, the
  in-kernel horizon loop x its trip count, x the number of programs);
- device-memory bytes per kernel call from the pallas_call operand/result
  avals;
- the remaining FLOPs (the XLA backward sweep, AL re-basing, constraint
  evaluation, candidate selection, stats) from XLA's own cost model, which
  EXCLUDES custom calls — i.e. it is exactly the non-kernel remainder.

Dividing these by the card's published peaks gives a roofline share; the
peak table belongs with the benchmark and is not kept here.

Run on the GPU:  python scripts/roofline.py [batch] [reps]
Emits one JSON dossier on stdout.
"""

import json
import sys
import time
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

# --- kernel-jaxpr FLOP accounting -----------------------------------------

FLOP_PRIMS = {
    "add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1, "max": 1, "min": 1,
    "abs": 1, "and": 0, "or": 0, "xor": 0, "not": 0,
    "pow": 1, "integer_pow": 1, "add_any": 1,
}
TRANS_PRIMS = {"sqrt", "rsqrt", "sin", "cos", "tan", "exp", "log", "tanh",
               "logistic", "cbrt"}


def _is_float(aval):
    return hasattr(aval, "dtype") and jnp.issubdtype(aval.dtype,
                                                     jnp.floating)


def _count_jaxpr(jaxpr, mult=1.0):
    """(flops, transcendentals) of one static execution of a jaxpr."""
    flops = trans = 0.0
    for eq in jaxpr.eqns:
        sub = []
        for v in eq.params.values():
            if hasattr(v, "jaxpr"):
                sub.append(v.jaxpr)
            elif isinstance(v, (list, tuple)):
                sub += [x.jaxpr for x in v if hasattr(x, "jaxpr")]
        if sub:
            inner_mult = mult
            if eq.primitive.name == "scan":
                inner_mult = mult * eq.params.get("length", 1)
            for sj in sub:
                f, t = _count_jaxpr(sj, inner_mult)
                flops += f
                trans += t
            continue
        name = eq.primitive.name
        outs = [o.aval for o in eq.outvars]
        if not outs or not _is_float(outs[0]):
            continue
        n = float(np.prod(outs[0].shape)) if outs[0].shape else 1.0
        if name in FLOP_PRIMS:
            flops += mult * FLOP_PRIMS[name] * n
        elif name in TRANS_PRIMS:
            trans += mult * n
        elif name == "dot_general":
            a = eq.invars[0].aval
            b = eq.invars[1].aval
            # 2 * prod(out) * contracted_dim
            ((lc, _), _) = eq.params["dimension_numbers"]
            k = float(np.prod([a.shape[i] for i in lc]))
            flops += mult * 2.0 * n * k
    return flops, trans


def _find_pallas(jaxpr, found):
    for eq in jaxpr.eqns:
        if eq.primitive.name == "pallas_call":
            found.append(eq)
        for v in eq.params.values():
            if hasattr(v, "jaxpr"):
                _find_pallas(v.jaxpr, found)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if hasattr(x, "jaxpr"):
                        _find_pallas(x.jaxpr, found)


def kernel_cost(fn, *args):
    """(flops, trans, hbm_bytes, grid) of ONE call of a function whose body
    is a single pallas kernel (counted per grid step x grid size)."""
    jaxpr = jax.make_jaxpr(fn)(*args)
    found = []
    _find_pallas(jaxpr.jaxpr, found)
    assert len(found) == 1, f"expected 1 pallas_call, found {len(found)}"
    eq = found[0]
    grid_mapping = eq.params["grid_mapping"]
    grid = int(np.prod(grid_mapping.grid))
    f, t = _count_jaxpr(eq.params["jaxpr"])
    hbm = sum(float(np.prod(v.aval.shape)) * v.aval.dtype.itemsize
              for v in list(eq.invars) + list(eq.outvars)
              if hasattr(v.aval, "shape"))
    return f * grid, t * grid, hbm, grid


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 10

    import bench
    from mmmpc_tpu.parallel import controller_batched_fn
    from mmmpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    mpc, x0_b, U0_b, params = bench.build_problem(batch)
    cfg = bench.SOLVER_CFG
    ocp = mpc.ocp
    N = ocp.N

    # --- static kernel accounting (per batched call) ---
    from mmmpc_tpu.solver.al_ilqr import build_core, rollout
    core = build_core(ocp, params, cfg, jnp.float32)
    nc, nct, ne = core.nc, core.nct, core.ne
    X_bm, Uc_bm = jax.vmap(lambda x0, U: rollout(ocp, x0, U, params),
                           in_axes=(-1, -1), out_axes=-1)(
                               x0_b.T, jnp.transpose(U0_b, (1, 2, 0)))
    lam = (jnp.zeros((N, nc, batch), jnp.float32),
           jnp.zeros((nct, batch), jnp.float32),
           jnp.zeros((ne, batch), jnp.float32))
    mu = jnp.asarray(10.0, jnp.float32)
    kffs = jnp.zeros((N, ocp.nu, batch), jnp.float32)
    Ks = jnp.zeros((N, ocp.nu, ocp.nx, batch), jnp.float32)
    fwd = ocp.lanes_fwd_factory(cfg)
    fwd_f, fwd_t, fwd_b, fwd_grid = kernel_cost(
        lambda *a: fwd(*a), X_bm[:-1], Uc_bm, kffs, Ks,
        lam[0], lam[1], lam[2], mu, params)

    # --- schedule: kernel calls per solve ---
    later = (cfg.ilqr_iters_later if cfg.ilqr_iters_later is not None
             else cfg.ilqr_iters)
    final = (cfg.ilqr_iters_final if cfg.ilqr_iters_final is not None
             else later)
    iters = cfg.ilqr_iters + max(cfg.al_iters - 2, 0) * later + (
        final if cfg.al_iters > 1 else 0)

    # --- the remainder from XLA's cost model (custom calls excluded) ---
    run = jax.jit(controller_batched_fn(mpc))
    compiled = run.lower(x0_b, U0_b, params).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    glue_flops = float(ca.get("flops", 0.0)) / batch
    glue_trans = float(ca.get("transcendentals", 0.0)) / batch
    glue_bytes = float(ca.get("bytes accessed", 0.0)) / batch

    res, stats = run(x0_b, U0_b, params)
    jax.block_until_ready(res.U)
    t0 = time.perf_counter()
    for _ in range(reps):
        res, stats = run(x0_b, U0_b, params)
    jax.block_until_ready(res.U)
    dt = time.perf_counter() - t0

    dev = jax.devices()[0]
    out = {
        "platform": dev.platform, "device_kind": dev.device_kind,
        "batch": batch, "horizon": N, "iters_per_solve": iters,
        "solves_per_s": batch * reps / dt,
        "fwd_kernel_flops_per_solve": (fwd_f + fwd_t) * iters / batch,
        "fwd_kernel_bytes_per_solve": fwd_b * iters / batch,
        "xla_flops_per_solve": glue_flops,
        "xla_transcendentals_per_solve": glue_trans,
        "xla_bytes_per_solve": glue_bytes,
        "fwd_kernel_per_call": {"flops": fwd_f + fwd_t, "bytes": fwd_b,
                                "programs": fwd_grid},
        "converged_frac": float(stats.n_converged) / float(stats.n_solved),
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
