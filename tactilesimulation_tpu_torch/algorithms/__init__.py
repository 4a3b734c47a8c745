"""Policy optimisation on the lane-major envs."""
