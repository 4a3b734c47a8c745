"""Policy and trajectory optimisation: GD (BPTT, through an env's lane-major
twin where it has one), PPO and PPO-RNN on the envs; Adam shooting and iLQR
on the single-instance simulator."""
