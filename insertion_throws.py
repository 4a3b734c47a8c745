#!/usr/bin/env python3
"""How many TactileInsertion lanes throw the box off the pads in one vector
step, at the lanes stepper's chord refresh 5 and 1 (ROADMAP queue 3, item
2: the flung insertion boxes).

    python3 insertion_throws.py [--envs 8]

``TactileInsertionLanes`` on the CPU in float64, seed 0, ``--envs`` envs
(twice as many lanes: the step side and the reset side), one
``vec_step_autoreset`` with uniform actions: per lane, how far the box
moved against the gripper over the last script; a lane counts as thrown
past 5 mm (or when its state is not finite). Imports nothing of JAX; one
CPU thread; about 3 minutes at 8 envs.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def throws(envs, refresh):
    from tactilesimulation_tpu_torch.envs import tactile_insertion_lanes
    lenv = tactile_insertion_lanes.make(device="cpu", dtype=torch.float64,
                                        seed=0, refresh=refresh)
    seen = []
    run = lenv._lane_execute

    def spy(model, q_cmd, grasp_force, noise):
        out = run(model, q_cmd, grasp_force, noise)
        seen.append((q_cmd, out[0]))
        return out

    lenv._lane_execute = spy
    t0 = time.perf_counter()
    state, obs = lenv.vec_reset(envs)
    act = torch.as_tensor(np.random.RandomState(0).uniform(
        -1, 1, (envs, lenv.ndof_u)))
    lenv.vec_step_autoreset(state, obs, torch.zeros(envs, dtype=torch.long),
                            act)
    sec = time.perf_counter() - t0
    q_cmd, q = seen[-1]                                  # (12, lanes)
    drift = torch.linalg.norm((q[6:9] - q[0:3]) - (q_cmd[6:9] - q_cmd[0:3]),
                              dim=0)
    thrown = ~torch.isfinite(q).all(dim=0) | (drift > 5e-3)
    print(f"refresh {refresh}: {int(thrown.sum())} of {q.shape[1]} lanes "
          f"throw the box (moved > 5 mm against the gripper); per lane (mm) "
          f"{np.round(drift.numpy() * 1e3, 2).tolist()}; reset and vector "
          f"step {sec:.1f} s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=8)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for refresh in (5, 1):
        throws(args.envs, refresh)


if __name__ == "__main__":
    main()
