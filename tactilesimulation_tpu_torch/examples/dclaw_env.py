"""Random-policy run of DClaw cap rotation on the port (the JAX package's
``examples/DClawExp/test_dclaw_env.py``): random actions and a reset
whenever an episode ends, through the gym wrapper.

    python -m tactilesimulation_tpu_torch.examples.dclaw_env \
        [--steps 100] [--seed 0] [--device cuda|cpu]

Runs in float32 on the CUDA card and raises without one unless
``--device cpu`` is given (then the plain PyTorch path runs).
"""

from .stable_grasp_env import parse, random_run


def main(argv=None):
    args = parse(argv, 100)
    return random_run("TactileRotation-v1", args.steps, args.seed,
                      args.device, every=10, observation_type="tactile")


if __name__ == "__main__":
    main()
