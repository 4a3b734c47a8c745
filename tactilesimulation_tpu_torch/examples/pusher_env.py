"""Constant-action run of TactilePush on the port (the JAX package's
``examples/TactilePushExp/test_pusher_env.py``): the pad driven along +x
through the gym wrapper, printing every 20th step.

    python -m tactilesimulation_tpu_torch.examples.pusher_env \
        [--steps 100] [--seed 0] [--device cuda|cpu]

Runs in float32 on the CUDA card and raises without one unless
``--device cpu`` is given (then the plain PyTorch path runs).
"""

import numpy as np

from .stable_grasp_env import parse


def main(argv=None):
    from ..envs import tactile_push
    from ..envs.gym_wrapper import GymEnv

    args = parse(argv, 100)
    env = GymEnv(tactile_push.make("tactile_flatten", device=args.device,
                                   seed=args.seed), seed=args.seed)
    env.reset()
    total = 0.0
    for t in range(args.steps):
        _, reward, _, info = env.step(np.array([1.0, 0.0, 0.0]))
        total += reward
        if t % 20 == 0:
            print(f"step {t}: reward={reward:.3f} "
                  f"pos_err={float(info['final_pos_error']):.4f}",
                  flush=True)
    print(f"episode reward: {total:.2f}")
    return total


if __name__ == "__main__":
    main()
