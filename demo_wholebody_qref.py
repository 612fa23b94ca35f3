"""Experiment entry point — mirror of the reference demo
(/root/reference/demo_wholebody_qref.py) on the JAX stack.

Usage:
    python demo_wholebody_qref.py [scenario] [--physical-sim] [--plots DIR]

scenario: 1 (table corner, default), 2 (wedge obstacle), 0 (debug).
"""

import argparse
import math

import numpy as np

from mmmpc_tpu.controllers import MPCWholeBody
from mmmpc_tpu.models.obstacles import Obstacles
from mmmpc_tpu.models.robots import MobileManipulator
from mmmpc_tpu.runtime import Interface
from mmmpc_tpu.utils.configs import make_scenario

PI = math.pi


def build_world(experiment_scenario=1, dt=0.1, N=20, t_move=5,
                t_manipulate=2, physical_sim=True):
    sc = make_scenario(experiment_scenario, dt=dt, N=N, t_move=t_move,
                       t_manipulate=t_manipulate)
    obstacle_manipulation_list = [
        (sc.hp_points[j], sc.hp_normals[j][None, :])
        for j in range(int(sc.hp_mask.sum()))
    ]
    obstacle_list = [Obstacles(*row) for row in sc.ground_obstacles]

    robot = MobileManipulator(dt)
    controller = MPCWholeBody(robot, obstacle_list,
                              obstacle_manipulation_list, N=N)
    world = Interface(dt, t_move, t_manipulate, sc.x_start,
                      sc.global_pose_target, controller,
                      physical_sim=physical_sim)
    return world


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("scenario", nargs="?", type=int, default=1)
    ap.add_argument("--physical-sim", action="store_true", default=True)
    ap.add_argument("--model-only", dest="physical_sim",
                    action="store_false")
    ap.add_argument("--plots", default=None,
                    help="directory to write result plots into")
    ap.add_argument("--animate", action="store_true",
                    help="also write the 3-D scene GIF (scene3d.gif)")
    args = ap.parse_args()

    world = build_world(args.scenario, physical_sim=args.physical_sim)
    world.run()
    print("task finished:", world.task_flag,
          "after", world.mpc_step_counter, "MPC steps")
    print("metrics:", world.metrics.summary())
    if args.plots:
        world.plot3D(save_dir=args.plots, animate=args.animate)
