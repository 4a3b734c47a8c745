"""Train TactilePush with GD (BPTT through the simulator) on the port (the
JAX package's ``examples/TactilePushExp/train_tactile_push_gd.py``).

    python -m tactilesimulation_tpu_torch.examples.train_tactile_push_gd \
        [--cfg examples/TactilePushExp/cfg/gd_tactile.yaml] \
        [--logdir ./trained_models/] [--seed 0] [--device cuda|cpu] \
        [--stop-update N] [--resume DIR/checkpoint.pt] \
        [--play --checkpoint DIR/models/best_model.pt [--num-games N]]

The env comes from the registry (``TactilePush-v1``); GD trains through
its lane env (``TactilePushLanes``: on the card the megastep, K2/K3) and
plays single-instance episodes. Runs in float32 on the CUDA card and
raises without one unless ``--device cpu`` is given; on the CPU it runs
the plain PyTorch path in float64, as the JAX CLI enables x64 on its CPU.
The config file is read where it lies; ``--cfg`` names another
(``gd_no_tactile.yaml``, ``gd_privilege.yaml``).
"""

import os
import sys

import torch

CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "examples", "TactilePushExp", "cfg", "gd_tactile.yaml")


def main(argv=None):
    from .. import envs
    from ..algorithms.gd import GD
    from ..envs.base import resolve_device
    from ..utils import config as cfgutil
    from ..utils.logging import print_ok

    argv = sys.argv[1:] if argv is None else list(argv)
    args_list = ["--cfg", os.path.normpath(CFG),
                 "--logdir", "./trained_models/",
                 "--seed", "0"]
    cfgutil.solve_argv_conflict(args_list, argv)
    args = cfgutil.get_gd_parser().parse_args(args_list + argv)
    device = resolve_device(args.device)
    dtype = torch.float64 if device.type == "cpu" else torch.float32

    cfg = cfgutil.load_cfg(args)
    cfgutil.set_random_seed(args.seed)

    env_params = dict(cfg["params"]["env"])
    name = env_params.pop("name")
    env = envs.make(name, device=device, dtype=dtype, seed=args.seed,
                    **env_params)

    algo = GD(env, cfg["params"], logdir=args.logdir if args.train else None,
              seed=args.seed)
    if args.checkpoint:
        algo.load(args.checkpoint)
    if args.resume:
        algo.resume(args.resume)
    if args.train:
        cfgutil.dump_cfg(cfg, args.logdir)
        return algo.train(stop_epoch=args.stop_update)
    total = algo.evaluate(num_games=args.num_games)
    print_ok(f"[Summary] Avg reward = {total:.3f}")
    return total


if __name__ == "__main__":
    main()
