"""Policy optimisation: GD on the lane-major envs, PPO on the
single-instance envs."""
