"""Train TactileInsertion with recurrent PPO on the port (the JAX package's
``examples/TactileInsertionExp/train_tactile_insertion_ppo.py``).

    python -m tactilesimulation_tpu_torch.examples.train_tactile_insertion_ppo \
        [--cfg examples/TactileInsertionExp/cfg/tactile_insertion_trans_and_rot.yaml] \
        [--logdir ./trained_models/] [--seed 0] [--device cuda|cpu] \
        [--stop-update N] [--resume DIR/checkpoint.pt] \
        [--play --checkpoint DIR/models/best_model.pt [--num-games N]]

Runs in float32 on the CUDA card and raises without one unless
``--device cpu`` is given (then the plain PyTorch path runs). The env is
the lane-major vec env (``TactileInsertionLanes``: one batched scripted
execution per vector step, the contact kernel K1 and its adjoint K1T on
the card) unless the config's env section says ``lane_vec: false``, which
steps single instances one after another.
"""

import os
import sys

CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "examples", "TactileInsertionExp", "cfg",
                   "tactile_insertion_trans_and_rot.yaml")


def main(argv=None):
    from .. import envs
    from ..algorithms.ppo_rnn import PPORNN
    from ..envs.tactile_insertion_lanes import TactileInsertionLanes
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
    lane_vec = env_params.pop("lane_vec", True)
    env = envs.make(name, device=args.device, seed=args.seed, **env_params)
    if lane_vec:
        env = TactileInsertionLanes(env)

    algo = PPORNN(env, cfg["params"],
                  logdir=args.logdir if args.train else None, seed=args.seed)
    if args.checkpoint:
        algo.load(args.checkpoint)
    if args.resume:
        algo.resume(args.resume)
    if args.train:
        cfgutil.dump_cfg(cfg, args.logdir)
        sr = algo.train(stop_update=args.stop_update)
        print_ok(f"final success rate: {sr:.3f}")
        return sr
    return algo.play(num_games=args.num_games,
                     stochastic=args.stochastic)["success_rate"]


if __name__ == "__main__":
    main()
