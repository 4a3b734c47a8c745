"""Random-policy run of StableGrasp on the port (the JAX package's
``examples/StableGraspExp/test_stable_grasp_env.py``): random actions and a
reset whenever an episode ends, through the gym wrapper.

    python -m tactilesimulation_tpu_torch.examples.stable_grasp_env \
        [--steps 20] [--seed 0] [--device cuda|cpu]

Each step is a scripted 180-substep grasp; the reset runs one too. Runs in
float32 on the CUDA card and raises without one unless ``--device cpu`` is
given (then the plain PyTorch path runs).
"""

import argparse

import numpy as np


def random_run(env_id, steps, seed, device, every=1, **kw):
    """``steps`` random actions on ``env_id`` with reset-on-done; prints
    every ``every``-th step and returns the rewards."""
    from .. import envs
    from ..envs.gym_wrapper import GymEnv

    env = GymEnv(envs.make(env_id, device=device, seed=seed, **kw),
                 seed=seed)
    rng = np.random.RandomState(seed)
    env.reset()
    rewards = []
    for t in range(steps):
        action = rng.uniform(-1, 1, env.ndof_u)
        _, reward, done, info = env.step(action)
        rewards.append(reward)
        if t % every == 0:
            print(f"step {t}: reward={reward:.2f} done={done} "
                  f"success={bool(info.get('success', False))}", flush=True)
        if done:
            env.reset()
    return rewards


def parse(argv, steps):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv, 20)
    return random_run("StableGrasp-v1", args.steps, args.seed, args.device,
                      observation_type="tactile_map")


if __name__ == "__main__":
    main()
