"""Train TactilePush with PPO on the port (the JAX package's
``examples/TactilePushExp/train_tactile_push_ppo.py``).

    python -m tactilesimulation_tpu_torch.examples.train_tactile_push_ppo \
        [--cfg examples/TactilePushExp/cfg/ppo_tactile.yaml] \
        [--logdir ./trained_models/] [--seed 0] [--device cuda|cpu] \
        [--stop-update N] [--resume DIR/checkpoint.pt] \
        [--play --checkpoint DIR/models/best_model.pt [--num-games N]]

Runs in float32 on the CUDA card and raises without one unless
``--device cpu`` is given (then the plain PyTorch path runs). The config
file is read where it lies; ``--cfg`` names another.
"""

import os
import sys

CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "examples", "TactilePushExp", "cfg", "ppo_tactile.yaml")


def main(argv=None):
    from .. import envs
    from ..algorithms.ppo import PPO
    from ..utils import config as cfgutil
    from ..utils.logging import print_ok

    argv = sys.argv[1:] if argv is None else list(argv)
    args_list = ["--cfg", os.path.normpath(CFG),
                 "--logdir", "./trained_models/",
                 "--seed", "0"]
    cfgutil.solve_argv_conflict(args_list, argv)
    args = cfgutil.get_rl_parser().parse_args(args_list + argv)

    cfg = cfgutil.load_cfg(args)
    cfgutil.set_random_seed(args.seed)

    env_params = dict(cfg["params"]["env"])
    name = env_params.pop("name")
    env = envs.make(name, device=args.device, seed=args.seed, **env_params)

    algo = PPO(env, cfg["params"], logdir=args.logdir if args.train else None,
               seed=args.seed)
    if args.checkpoint:
        algo.load(args.checkpoint)
    if args.resume:
        algo.resume(args.resume)
    if args.train:
        cfgutil.dump_cfg(cfg, args.logdir)
        return algo.train(stop_update=args.stop_update)
    rewards = []
    for g in range(args.num_games):
        r, length, info = algo.play_once(args.seed + g,
                                         deterministic=not args.stochastic)
        rewards.append(r)
    print_ok(f"[Summary] Avg reward = {sum(rewards) / len(rewards):.3f}")
    return sum(rewards) / len(rewards)


if __name__ == "__main__":
    main()
