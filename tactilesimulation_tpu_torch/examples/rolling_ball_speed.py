"""RollingBall sim-speed benchmark on the port, the reference's protocol
(examples/RollingBallExp/test_sim_speed.py): a sphere under a
force-controlled tactile pad of resolution^2 markers (200 x 200 = 40,000),
BDF2, h = 5e-3, 350 steps of piecewise-constant pad forces, the tactile
field read every 5 steps; prints the wall-clock FPS. ``--grad`` also times
BPTT: the gradient of a loss through the dense tactile field and the final
ball position with respect to the chunk controls, over ``--grad-steps``
steps.

    python -m tactilesimulation_tpu_torch.examples.rolling_ball_speed \
        [--steps 350] [--resolution 200 | --scene PATH] [--f64] [--cpu] \
        [--batch B] [--lanes] [--viz DIR] [--grad [--grad-steps 100]]

``--scene PATH`` loads the scene from a redmax XML file (e.g. the
reference's assets/tactile_pad/tactile_pad.xml) in place of the bundled
``task_scenes.rolling_ball(resolution)``; every other option works as with
the bundled scene.

``--batch B`` runs B copies of the scene at once through the batched
single-instance core (states (B, n); the JAX CLI ``vmap``s its rollout),
each chunk's field of every copy in one tactile read; FPS counts B x the
steps. ``--lanes`` runs the B copies through the lane-major stepper
instead (``sim/lanes.py``: ``lanes.build_step``, BDF2), its plain lane
field every 5 steps, as the JAX CLI does (no read kernel). ``--viz DIR``
writes ``depth.png`` and ``force.png`` of the last frame (copy 0, the
first sensor's rows x cols).

Runs on the CUDA card (the tactile reads of the forward run go through the
read kernel; BPTT takes the differentiable field) and raises without one
unless ``--cpu`` is given (then the plain PyTorch path runs).
"""

import argparse
import os
import time

import numpy as np
import torch

# piecewise-constant control schedule (reference test_sim_speed.py:43-48)
ACTIONS = [(0.0, 0.0, 0.2), (0.1, 0.0, 0.2), (-0.2, 0.0, 0.2),
           (0.0, 0.1, 0.2), (0.0, -0.2, 0.2)]
STEPS = [0, 100, 150, 200, 250, 350]
STRIDE = 5                      # tactile acquired every 5 steps (ref :73)


def control_chunks(steps: int, nu: int) -> np.ndarray:
    """(steps // STRIDE, nu): the schedule's control of each chunk."""
    us = np.zeros((STEPS[-1], nu))
    for i in range(len(STEPS) - 1):
        us[STEPS[i]:STEPS[i + 1]] = ACTIONS[i]
    us = us[:steps]
    K = us.shape[0] // STRIDE
    return us[:K * STRIDE:STRIDE]


def repeat_controls(us, runs: int = 4, seed: int = 100):
    """The controls of the timed repeats: each run's are the run before's
    moved by 1e-4 x a standard normal draw (``RandomState(seed)``), the
    JAX CLI's repeat protocol."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(runs):
        us = us + torch.as_tensor(1e-4 * rng.randn(*us.shape),
                                  dtype=us.dtype, device=us.device)
        out.append(us)
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bptt_loss(sim, model, state0, remat=True):
    """loss(us (K, nu)) of the ``--grad`` protocol: the dense tactile field
    at every chunk end and the final ball position, through
    ``make_rollout_strided(STRIDE, fast_tactile=False)``."""
    rollout = sim.make_rollout_strided(STRIDE, remat=remat,
                                       fast_tactile=False)

    def loss(us):
        state, _, _, tacs = rollout(model, state0, us)
        return torch.sum(tacs ** 2) * 1e3 + torch.sum(state.q[3:6] ** 2)

    return loss


def lane_rollout(struct, B):
    """(model, us (K, nu), state=None) -> (state, tactiles (K, ntac, 3,
    B)): B lanes (of the scene's initial state unless ``state`` is given)
    through ``lanes.build_step``, each control held for STRIDE steps, the
    plain lane field at every chunk end (the JAX CLI's ``--lanes``)."""
    from tactilesimulation_tpu_torch.sim import lanes
    step = lanes.build_step(struct)

    def rollout(model, us, state=None):
        if state is None:
            q0 = model.q_init[:, None].expand(struct.ndof_q, B).contiguous()
            v0 = torch.zeros_like(q0)
            state = lanes.LaneSimState(
                q=q0, qdot=v0, q_prev=q0, qdot_prev=v0,
                t=torch.zeros(B, dtype=torch.int32, device=q0.device))
        tacs = []
        for u in us:
            u_l = u[:, None].expand(struct.ndof_u, B)
            for _ in range(STRIDE):
                state = step(model, state, u_l)
            tacs.append(lanes.tactile_field(struct, model, state.q,
                                            state.qdot))
        return state, torch.stack(tacs)

    return rollout


def grad_of(loss, us):
    us = us.detach().requires_grad_()
    (g,) = torch.autograd.grad(loss(us), us)
    return g


def main(argv=None):
    """Returns the timed forward rollout's outputs and, with ``--grad``,
    (controls, gradient) of the last BPTT run (else None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=350)
    ap.add_argument("--resolution", type=int, default=200)
    ap.add_argument("--scene", type=str, default="",
                    help="a redmax XML scene file to load in place of the "
                         "bundled scene (--resolution is then unused)")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--grad", action="store_true",
                    help="also time BPTT: d(loss through the dense tactile "
                         "field + final ball position)/d(controls) over "
                         "--grad-steps steps")
    ap.add_argument("--grad-steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=1,
                    help="batched copies of the sim (the batched core; "
                         "with --lanes, the lane count)")
    ap.add_argument("--lanes", action="store_true",
                    help="run the batch through the lane-major (batch-last) "
                         "core (sim/lanes.py) instead of the batched core")
    ap.add_argument("--viz", type=str, default="",
                    help="write tactile depth/force images of the final "
                         "frame into this folder")
    args = ap.parse_args(argv)
    if args.batch < 1:
        ap.error("--batch takes 1 or more")

    from tactilesimulation_tpu_torch.envs.base import (load_scene,
                                                       resolve_device)
    from tactilesimulation_tpu_torch.model import task_scenes
    from tactilesimulation_tpu_torch.sim.simulation import Simulator

    device = resolve_device("cpu" if args.cpu else "cuda")
    dtype = torch.float64 if args.f64 else torch.float32
    struct, model = load_scene(args.scene, lambda: task_scenes.rolling_ball(
        resolution=args.resolution))
    model = model.to(device, dtype)
    sim = Simulator(struct, model)
    print(f"scene '{struct.name}': ndof_r={struct.ndof_q} "
          f"ndof_u={struct.ndof_u} markers={struct.ndof_tactile // 3}")

    us_chunks = torch.as_tensor(control_chunks(args.steps, struct.ndof_u),
                                dtype=dtype, device=device)
    K = us_chunks.shape[0]
    B = args.batch
    state0 = sim.init_state(batch=B if B > 1 else None)
    if args.lanes:
        lanes_run = lane_rollout(struct, B)
        run = lambda us: lanes_run(model, us)
    else:
        rollout = sim.make_rollout_strided(STRIDE, remat=False,
                                           fast_tactile=True)
        run = lambda us: rollout(model, state0, us)

    print("first run...")
    t0 = time.time()
    out = run(us_chunks)
    sync(device)
    print(f"first run: {time.time() - t0:.1f}s")

    # the JAX CLI's repeat protocol: perturbed controls, median of the later
    # runs (here fenced by torch.cuda.synchronize)
    times = []
    for us_chunks in repeat_controls(us_chunks):
        t0 = time.time()
        out = run(us_chunks)
        sync(device)
        times.append(time.time() - t0)
    t1 = float(np.median(times[1:]))

    nsteps = K * STRIDE * B
    print(f"time elapsed = {t1:.3f} , FPS = {nsteps / t1:.1f}")
    if args.lanes:
        state, tactiles = out
        print("final q:", state.q.cpu().numpy()[:6, 0])
        tac = tactiles[-1][..., 0].cpu().numpy()        # (M, 3) lane 0
    else:
        state, qs, vars_, tactiles = out
        print("final q:", state.q.cpu().numpy()[..., :6])
        tac = (tactiles[-1] if B == 1 else tactiles[0, -1]).reshape(
            -1, 3).cpu().numpy()
    print(f"tactile: max |normal| = {np.abs(tac[:, 2]).max():.4g}, "
          f"max |shear| = {np.linalg.norm(tac[:, :2], axis=1).max():.4g}, "
          f"active markers = {(np.abs(tac[:, 2]) > 1e-9).sum()}")
    if args.viz:
        from tactilesimulation_tpu_torch.utils import tactile_viz
        sensor = struct.sensors[0]
        arr = tac.reshape(sensor.rows, sensor.cols, 3)
        os.makedirs(args.viz, exist_ok=True)
        for name, img in (("depth", tactile_viz.visualize_depth_image(arr)),
                          ("force", tactile_viz.visualize_tactile_image(arr))):
            tactile_viz.save_png(os.path.join(args.viz, f"{name}.png"), img)
        print(f"tactile depth/force images -> {args.viz}/")
    if not args.grad:
        return out, None

    # BPTT: the gradient w.r.t. the first --grad-steps / STRIDE chunk
    # controls; a first run, then the median of the later repeats with
    # perturbed controls
    Kg = max(args.grad_steps // STRIDE, 1)
    us_g = us_chunks[:Kg]
    loss = bptt_loss(sim, model, sim.init_state())
    t0 = time.time()
    g = grad_of(loss, us_g)
    sync(device)
    print(f"BPTT first run: {time.time() - t0:.1f}s")
    rng = np.random.RandomState(200)
    gts = []
    for _ in range(3):
        us_g = us_g + torch.as_tensor(1e-4 * rng.randn(*us_g.shape),
                                      dtype=dtype, device=device)
        t0 = time.time()
        g = grad_of(loss, us_g)
        sync(device)
        gts.append(time.time() - t0)
    dt = float(np.median(gts[1:]))
    print(f"BPTT {Kg * STRIDE} steps: {dt:.3f}s "
          f"({Kg * STRIDE / dt:.1f} steps/s), "
          f"|g| = {float(torch.linalg.norm(g)):.4g}, "
          f"finite = {bool(torch.isfinite(g).all())}")
    return out, (us_g, g)


if __name__ == "__main__":
    main()
