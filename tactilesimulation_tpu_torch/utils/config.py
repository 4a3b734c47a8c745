"""Config/flag system: script-embedded defaults, CLI overrides via
``solve_argv_conflict``, argparse flags, and the YAML experiment config
with sections ``params.env`` / ``params.network`` / ``params.config``.

Port of ``tactilesimulation_tpu/utils/config.py``. ``--device`` names the
torch device (the card unless ``cpu``).
"""

from __future__ import annotations

import argparse
import copy
import os
import random
import time

import numpy as np
import torch
import yaml


def solve_argv_conflict(args_list, argv):
    """Drop default args that the command line overrides."""
    arguments_to_be_removed = []
    arguments_size = []
    for argv_item in argv:
        if argv_item.startswith("-"):
            for i, args_item in enumerate(args_list):
                if args_item == argv_item:
                    size = 1
                    while (i + size < len(args_list)
                           and not args_list[i + size].startswith("-")):
                        size += 1
                    arguments_to_be_removed.append(args_item)
                    arguments_size.append(size)
                    break
    for args_item, size in zip(arguments_to_be_removed, arguments_size):
        i = args_list.index(args_item)
        del args_list[i:i + size]
    return args_list


def get_base_parser(desc=""):
    parser = argparse.ArgumentParser(desc)
    parser.add_argument("--cfg", type=str, required=True)
    parser.add_argument("--logdir", type=str, default="./trained_models/")
    parser.add_argument("--play", action="store_true")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--record", action="store_true")
    parser.add_argument("--stochastic", action="store_true")
    parser.add_argument("--num-games", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-time-stamp", action="store_true")
    parser.add_argument("--log-interval", type=int, default=1)
    parser.add_argument("--save-interval", type=int, default=50)
    parser.add_argument("--render-interval", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, the default, or cpu)")
    parser.add_argument("--resume", type=str, default=None,
                        help="full-state checkpoint to resume training from "
                             "(continues exactly: optimizer + vec-env + "
                             "normalizer + counters + generators)")
    parser.add_argument("--stop-update", type=int, default=None,
                        help="stop after this many PPO updates / GD epochs "
                             "(chunked crash-resilient training)")
    return parser


get_gd_parser = get_base_parser
get_rl_parser = get_base_parser


def get_time_stamp():
    t = time.localtime()
    return (f"{t.tm_mon:02d}-{t.tm_mday:02d}-{t.tm_year}-"
            f"{t.tm_hour:02d}-{t.tm_min:02d}-{t.tm_sec:02d}")


def load_cfg(args, defaults_list=None, argv=None):
    """Merge defaults + CLI + YAML into the reference cfg dict layout."""
    with open(args.cfg) as f:
        cfg = yaml.safe_load(f)
    if not args.no_time_stamp:
        args.logdir = os.path.join(args.logdir, get_time_stamp())
    args.train = not args.play
    cfg["params"]["general"] = dict(vars(args))
    return cfg


def set_random_seed(seed):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def dump_cfg(cfg, logdir):
    os.makedirs(logdir, exist_ok=True)
    save_cfg = copy.deepcopy(cfg)
    with open(os.path.join(logdir, "cfg.yaml"), "w") as f:
        yaml.dump(save_cfg, f)
