"""Host-Interface fleet parity: the distribution-level check behind the
fleet task engine's completion claim.

Round 4 pinned ONE engine rotate-stall as host-identical
(tests/test_task_engine.py::test_rotate_stall_host_parity); this script
upgrades that n=1 claim to a distribution: it drives >=64 jittered
scenario-1 tasks through the HOST ``Interface`` loop (runtime/interface.py
— the reference's interface_wholebody_qref.py:65-228 twin, model-only) with
EXACTLY the fleet bench's jitter (same rng seed/order as
scripts/bench_fleet_tasks.py), and reports completion rate + final-flag
(stall-mode) histogram next to the engine's number.

Run on CPU:  JAX_PLATFORMS=cpu python scripts/host_fleet_parity.py [K] [scenario]
             [--ticks=400] [--procs=N]
Emits one JSON line.
"""

import json
import multiprocessing as mp
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = 20          # fleet bench horizon (scripts/bench_fleet_tasks.py)
FLEET_BATCH = 1024   # jitter is drawn at fleet batch and the first K taken


def _worker(args):
    idx, x0, scenario, max_ticks = args
    # late imports: each pool worker builds and jits its own controller once
    import jax
    jax.config.update("jax_platforms", "cpu")
    from mmmpc_tpu.controllers import MPCWholeBody
    from mmmpc_tpu.models.obstacles import Obstacles
    from mmmpc_tpu.models.robots import MobileManipulator
    from mmmpc_tpu.runtime import Interface
    from mmmpc_tpu.utils.configs import make_scenario

    sc = make_scenario(scenario, N=N)
    hp = [(sc.hp_points[j], sc.hp_normals[j][None, :])
          for j in range(int(sc.hp_mask.sum()))]
    obstacles = [Obstacles(*row) for row in sc.ground_obstacles]
    mpc = MPCWholeBody(MobileManipulator(sc.dt), obstacles, hp, N=N)
    world = Interface(sc.dt, sc.t_move, sc.t_manipulate, x0,
                      sc.global_pose_target, mpc, physical_sim=False,
                      max_mpc_steps=max_ticks)
    t0 = time.perf_counter()
    world.run()
    # "manipulate finish" == button pressed (ee within 1 cm,
    # interface.py:204-208) — the exact twin of the engine's done check
    done = world.task_flag == "manipulate finish"
    return {
        "idx": idx,
        "done": bool(done),
        "final_flag": world.task_flag,
        "steps": int(world.mpc_step_counter),
        "wall_s": round(time.perf_counter() - t0, 1),
    }


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    K = int(args[0]) if args else 64
    scenario = int(args[1]) if len(args) > 1 else 1
    max_ticks = 400
    procs = max(1, os.cpu_count() - 0)
    for a in sys.argv[1:]:
        if a.startswith("--ticks="):
            max_ticks = int(a.split("=")[1])
        elif a.startswith("--procs="):
            procs = int(a.split("=")[1])

    from mmmpc_tpu.utils.configs import make_scenario
    sc = make_scenario(scenario, N=N)
    # EXACT fleet-bench jitter: same seed, same draw shape, first K rows
    rng = np.random.default_rng(0)
    x0 = np.tile(sc.x_start, (FLEET_BATCH, 1)).astype(np.float32)
    x0[:, 6:] += (0.05 * rng.standard_normal((FLEET_BATCH, 3))
                  ).astype(np.float32)

    jobs = [(i, x0[i].astype(float), scenario, max_ticks) for i in range(K)]
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(procs) as pool:
        results = list(pool.imap_unordered(_worker, jobs))
    wall = time.perf_counter() - t0

    flags = {}
    for r in results:
        flags[r["final_flag"]] = flags.get(r["final_flag"], 0) + 1
    done = [r for r in results if r["done"]]
    out = {
        "scenario": scenario, "K": K, "max_ticks": max_ticks,
        "host_completion_rate": round(len(done) / K, 4),
        "median_done_steps": (float(np.median([r["steps"] for r in done]))
                              if done else None),
        "final_flag_histogram": flags,
        "wall_s": round(wall, 1),
    }
    for a in sys.argv[1:]:
        if a.startswith("--dump="):
            # per-robot rows for the individual-level comparison against
            # the engine's --dump-done npz (same robot indices)
            with open(a.split("=", 1)[1], "w") as fh:
                json.dump(sorted(results, key=lambda r: r["idx"]), fh)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
