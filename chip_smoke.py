#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure: exit code 1 and no result line):
 1. device  - a CUDA device must exist (no CPU fallback); prints the card's
              name and power limit (nvidia-smi) and turns TF32 off;
 2. build   - compiles every kernel of the path from csrc/ with nvcc, in
              parallel, and prints the build seconds and ptxas's report;
 3. kernels - K1 (csrc/lane_contact.cu) against its plain PyTorch version on
              the same card inputs, float32, at B = 1024: TactilePush
              (ground, cuboid), RollingBall 8x8 (sphere) and a hand-made
              cylinder scene, each with static and per-lane parameters; to
              1e-5 x the output's scale (the sums run in another order);
              kernel and plain times at the main path's shapes;
 4. slice   - the port's main path through its entry points: a
              TactilePush tactile_flatten forward policy rollout at B = 1024
              (DiagGaussianActor [64, 64] elu, random weights from a seed);
              K1 must launch 1 + 47 times per env step, outputs finite;
 5. cross   - 2 env steps at B = 16 on the card (K1, float32) against the
              port on the CPU (plain version, float64).

The line before the card's line is the kernel table as JSON; the last line
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

B_MAIN = 1024            # lanes of the main path
H_MAIN = 5               # env steps of the timed slice run
B_CROSS, H_CROSS = 16, 2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # non-tensor-core fp32 peak
ACTOR_CFG = {"actor_mlp": {"layer_sizes": [64, 64], "activation": "elu",
                           "layernorm": False},
             "actor_logstd_init": -1.0}
# flops per point of K1, counted from csrc/lane_contact.cu: point FK 33,
# point velocity 12, force law 41, wrench sums 15, plus the primitive's
# frame transform, relative velocity and SDF; +3 for a tactile row
K1_FLOPS_PER_POINT = {-1: 107, 0: 185, 1: 178, 2: 160}
K1_TOL = 1e-5

KERNELS = [dict(name="K1 lane_contact", lib="lane_contact", route="cuda",
                source="tactilesimulation_tpu_torch/csrc/lane_contact.cu",
                replaces="tactilesimulation_tpu/ops/lane_contact.py:413")]


def cylinder_probe(scenes):
    """A cube's contact lattice on a cylinder's top face: the cylinder SDF
    branch (face and rim), which no task scene uses as a primitive."""
    b = scenes.SceneBuilder("cylinder_probe", ground=(0, 0, 0))
    jc = b.add_joint("cyl", "translational", pos=(0, 0, 0.05))
    cyl = b.add_body("cyl", jc, "cylinder", size=(0.025, 0.04),   # r, length
                     density=500.0)
    jb = b.add_joint("cube", "free3d-exp", pos=(0, 0, 0.09))
    cube = b.add_body("cube", jb, "cuboid", size=(0.04, 0.04, 0.04),
                      density=500.0, contact_resolution=(3, 3, 3))
    b.add_contact(cube, cyl, kn=1e3, kt=2.0, mu=0.8, damping=5.0)
    return b.build()


def contact_state(name, q_init, B, seed):
    """(q, v) float64 (n, B) with active contacts in every lane."""
    rng = np.random.RandomState(seed)
    n = q_init.shape[0]
    q = q_init[:, None] + 1e-3 * rng.randn(n, B)
    if name == "tactile_push":
        q[1] = rng.uniform(0.0005, 0.004, B)     # pad into the box
        q[5] = rng.uniform(-0.001, 0.0, B)       # box into the ground
    elif name == "rolling_ball_8":
        q[2] = rng.uniform(-0.02, -0.016, B)     # pad onto the ball
        q[5] = rng.uniform(-0.001, 0.0, B)       # ball into the ground
    else:
        q[5] = rng.uniform(-0.002, 0.0, B)       # cube onto the cylinder
        q[6:9] = 0.05 * rng.randn(3, B)          # tilted: rim contacts
    return q, 0.1 * rng.randn(n, B)


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Smoke:
    def __init__(self):
        self.failed = []
        self.kernel_rows = {}
        self.card = None

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        try:
            return fn(*args)
        except Exception:                      # report and fail the run
            traceback.print_exc()
            self.failed.append(name)
            print(f"PHASE FAILED: {name}", flush=True)
            return None

    # 1 -------------------------------------------------------------------
    def device(self):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        self.card = smi.stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"card: {self.card}; torch {torch.__version__} cuda "
              f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
        print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2 -------------------------------------------------------------------
    def build(self):
        from tactilesimulation_tpu_torch.ops import _build
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as ex:
            futs = {k["lib"]: ex.submit(_build.build, k["lib"],
                                        ("-Xptxas", "-v"), True)
                    for k in KERNELS}
            for lib, fut in futs.items():
                fut.result()
        print(f"built {len(KERNELS)} kernel(s) in "
              f"{time.perf_counter() - t0:.2f} s")
        for k in KERNELS:
            lib = k["lib"]
            print(f"  {lib}: nvcc {_build.build_seconds[lib]:.2f} s")
            for line in _build.build_log[lib].splitlines():
                if "registers" in line or "spill" in line:
                    print("   ", line.strip())
            _build.load(lib)

    # 3 -------------------------------------------------------------------
    def _k1_args(self, name, dev):
        from tactilesimulation_tpu_torch.model import scenes, task_scenes
        from tactilesimulation_tpu_torch.ops import lane_contact
        from tactilesimulation_tpu_torch.sim import contact, lanes
        build = {"tactile_push": task_scenes.tactile_push,
                 "rolling_ball_8": lambda: task_scenes.rolling_ball(8),
                 "cylinder_probe": lambda: cylinder_probe(scenes)}[name]
        struct, model = build()
        q, v = contact_state(name, model.q_init.numpy(), B_MAIN, seed=0)
        model = model.to(dev, torch.float32)
        q = torch.as_tensor(q, dtype=torch.float32, device=dev)
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        with torch.no_grad():
            jp, jq, bp, bquat, _, _, _, Om, be = lanes._fused_small_stage(
                struct, model, q, v)
            op = lane_contact.PairWrenches(struct)
            params = contact.combined_params(model)
            xi = lane_contact.pack_points(struct, model, op.src_idx)
        args = [jp, jq, Om, be, bp, bquat, model.body_size, params,
                model.ground_pos, model.ground_normal, xi]
        rng = np.random.RandomState(1)
        per_lane = params[:, :, None] * torch.as_tensor(
            rng.uniform(0.5, 1.5, tuple(params.shape) + (B_MAIN,)),
            dtype=torch.float32, device=dev)
        return op, [a.contiguous() for a in args], per_lane.contiguous()

    def kernels(self, dev):
        worst = 0.0
        main = None
        for name in ("tactile_push", "rolling_ball_8", "cylinder_probe"):
            op, args, per_lane = self._k1_args(name, dev)
            for mode in ("static", "per-lane"):
                a = list(args)
                if mode == "per-lane":
                    a[7] = per_lane
                with torch.no_grad():
                    got = op(*a)
                    want = op.reference(*a)
                torch.cuda.synchronize()
                errs = []
                for g, w, out in zip(got, want, ("F", "Tau", "tac")):
                    if w.numel() == 0:
                        continue
                    scale = float(w.abs().max()) + 1e-6
                    err = float((g - w).abs().max())
                    errs.append((out, err, scale))
                    if not err <= K1_TOL * scale or not math.isfinite(err):
                        raise AssertionError(
                            f"K1 {name} {mode} {out}: |err| {err:.3e} > "
                            f"{K1_TOL:g} x {scale:.3e}")
                if float(got[0].abs().max()) <= 1e-3:
                    raise AssertionError(f"{name}: no active contact")
                rel = max(e / s for _, e, s in errs)
                worst = max(worst, rel)
                segs = sorted({s.gtype for s in op.segments})
                print(f"  K1 {name:15s} {mode:8s} B={B_MAIN} gtypes={segs} "
                      + " ".join(f"{o}:{e:.2e}/{s:.2e}" for o, e, s in errs)
                      + f" max rel {rel:.2e} (tol {K1_TOL:g}) ok")
                if name == "tactile_push" and mode == "static":
                    main = (op, a, max(e for _, e, _ in errs))
        op, a, max_abs = main
        k_ms = cuda_ms(lambda: op.run_kernel(*a), 200, warmup=10)
        with torch.no_grad():
            p_ms = cuda_ms(lambda: op.reference(*a), 20)
        bytes_moved = 4 * (sum(x.numel() for x in a)
                           + op._seg_np.size
                           + 2 * 3 * op.J * B_MAIN + 3 * op.ntac * B_MAIN)
        flops = B_MAIN * sum(s.n * (K1_FLOPS_PER_POINT[s.gtype]
                                    + (3 if s.tac0 >= 0 else 0))
                             for s in op.segments)
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        print(f"  K1 TactilePush B={B_MAIN}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms; moves {bytes_moved} B ({t_bytes:.5f} ms), "
              f"{flops} flop ({t_ops:.5f} ms); bound {bound:.5f} ms; "
              f"worst rel err {worst:.2e}")
        self.kernel_rows["lane_contact"] = dict(
            max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)

    # 4 -------------------------------------------------------------------
    def slice(self, dev):
        from tactilesimulation_tpu_torch.envs import tactile_push_lanes
        from tactilesimulation_tpu_torch.models.nets import DiagGaussianActor
        from tactilesimulation_tpu_torch.sim import lanes
        env = tactile_push_lanes.make("tactile_flatten", device=dev, seed=0)
        torch.manual_seed(0)
        actor = DiagGaussianActor(env.obs_size()[0], env.ndof_u,
                                  ACTOR_CFG).to(dev)
        pw = env.pair_wrenches
        per_step = 1 + env.frame_skip * (1 + env.max_iter) + 1
        # warm-up env step (device tables, library handles)
        env.batched_rollout_fn(actor.act, 1)(B_MAIN)
        torch.cuda.synchronize()

        run = env.batched_rollout_fn(actor.act, H_MAIN)
        pw.reset_counts()
        t0 = time.perf_counter()
        rewards, dones, infos = run(B_MAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, vjps, recomputes = (pw.launches, pw.twin_vjps,
                                      pw.twin_recomputes)
        want = 1 + per_step * H_MAIN
        print(f"  K1 launches {launches} (want 1 reset + {per_step} x "
              f"{H_MAIN} = {want}); twin VJPs {vjps}, twin recomputes "
              f"{recomputes}")
        if launches != want:
            raise AssertionError(f"K1 launched {launches} times, want {want}")
        if (vjps, recomputes) != (env.struct.ndof_q * H_MAIN, H_MAIN):
            raise AssertionError("twin VJP counts off")
        if tuple(rewards.shape) != (B_MAIN, H_MAIN):
            raise AssertionError(f"rewards {tuple(rewards.shape)}")
        for k, x in [("reward", rewards)] + list(infos.items()):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{k} not finite")
        self.kernel_rows["lane_contact"]["launches"] = launches
        steps_s = H_MAIN / wall
        print(f"  slice: B={B_MAIN} H={H_MAIN} in {wall:.3f} s: "
              f"{steps_s:.4f} env steps/s, {steps_s * B_MAIN:.1f} lane "
              f"steps/s, {B_MAIN * steps_s / 150:.3f} rollouts/s at H=150 "
              f"[{self.card}]")
        print(f"  mean reward {float(rewards.mean()):.4f}, mean final pos "
              f"error {float(infos['final_pos_error'][:, -1].mean()):.5f}")

        # where an env step's time goes, at the same shapes
        with torch.no_grad():
            state, obs = env.reset(B_MAIN)
            sim = state.sim
            u = torch.zeros((6, B_MAIN), device=dev)
            inputs = lanes.StepInputs(
                model=env.model, u=u, q_base=sim.q,
                p_base=lanes.momentum(env.struct, env.model, sim.q, sim.qdot),
                gamma=env.model.h.reshape(1, 1))
            residual = lanes.make_residual(env.struct, env._pw)
            r_ms = cuda_ms(lambda: residual(sim.qdot, inputs), 5)
            j_ms = cuda_ms(lambda: lanes.make_chord_lu(residual, inputs,
                                                      sim.qdot), 3)
            step_ms = wall / H_MAIN * 1e3
        k_ms = self.kernel_rows["lane_contact"]["ms"]
        print(f"  env step {step_ms:.1f} ms: chord factor (7 pullbacks) "
              f"{j_ms:.1f} ms, residual {r_ms:.2f} ms x "
              f"{per_step - 1}, K1 {k_ms * per_step:.3f} ms in all "
              f"({100 * k_ms * per_step / step_ms:.3f} %)")
        self.device_share(lambda: residual(sim.qdot, inputs), "residual")

    @staticmethod
    def device_share(fn, what):
        """Device busy share of one call of ``fn``, from torch.profiler."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        try:
            with torch.no_grad(), profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = prof.events()
            busy = sum(e.self_device_time_total for e in events
                       if e.device_type == DeviceType.CPU) / 1e6
            kernels = sum(1 for e in events
                          if e.device_type == DeviceType.CUDA)
        except Exception as e:    # a measurement, not a check: report it
            print(f"  {what}: device busy share not measured "
                  f"({type(e).__name__}: {e})")
            return
        if busy == 0:
            print(f"  {what}: device busy share not measured (the profiler "
                  "saw no device time)")
            return
        print(f"  {what} under the profiler: wall {wall * 1e3:.1f} ms, device "
              f"busy {busy * 1e3:.2f} ms ({100 * busy / wall:.2f} %), "
              f"{kernels} kernels")

    # 5 -------------------------------------------------------------------
    def cross(self, dev):
        from tactilesimulation_tpu_torch.envs import tactile_push_lanes
        from tactilesimulation_tpu_torch.models.nets import DiagGaussianActor
        B, H = B_CROSS, H_CROSS
        rng = np.random.RandomState(7)
        box_y = rng.uniform(-0.02, 0.02, B)
        gy = rng.uniform(-0.2, 0.2, B)
        goal = np.stack([rng.uniform(0.15, 0.25, B), gy,
                         gy * np.pi + rng.uniform(-np.pi / 16, np.pi / 16, B)])
        dist = [(rng.uniform(size=B) >= 0.5, rng.uniform(-1, 1, (2, B)))
                for _ in range(H)]
        torch.manual_seed(1)
        actor = DiagGaussianActor(393, 3, ACTOR_CFG)
        with torch.no_grad():
            # the pad backs away from the box: no contact switch in the
            # window (see the tolerance note below)
            actor.mean.bias.copy_(torch.tensor([-1.0, 0.0, 0.0]))
            actor.mean.weight.mul_(0.1)
        runs = []
        for where, dtype in ((dev, torch.float32),
                             (torch.device("cpu"), torch.float64)):
            env = tactile_push_lanes.make("tactile_flatten", device=where,
                                          dtype=dtype)
            draws = iter(dist)

            def injected(what, nb, where=where, dtype=dtype, draws=draws):
                t = lambda a: torch.as_tensor(a, device=where)
                if what == "reset":
                    return (t(box_y).to(dtype), t(goal).to(dtype))
                keep_zero, sampled = next(draws)
                return t(keep_zero), t(sampled).to(dtype)

            env._draw = injected
            pol = actor.to(where, dtype)
            pw = env.pair_wrenches
            pw.reset_counts()
            rewards = []
            with torch.no_grad():
                state, obs = env.reset(B)
                for _ in range(H):
                    state, obs, r, _, _ = env.step(state, pol.act(obs))
                    rewards.append(r)
            runs.append([x.double().cpu() for x in
                         (state.sim.q, state.sim.qdot, torch.stack(rewards),
                          obs)])
            print(f"  {where.type} {dtype}: K1 launches {pw.launches}")
        # Tolerance: f32 round-off through the chord solve, whose float32
        # stopping rule is 1e-4 x the first residual, gives about 1e-6
        # relative on q (3e-7 measured on the CPU, f32 against f64, with
        # these draws). At a contact switch under one chord factor per env
        # step, f32 and f64 part by ~1% even with 30 sweeps, so this window
        # keeps the pad away from the box; the pad-box branches are held to
        # the plain version in phase 3.
        tols = {"q": 1e-5, "qdot": 1e-4, "reward": 1e-5, "obs": 1e-5}
        for (name, tol), g, w in zip(tols.items(), *runs):
            scale = float(w.abs().max())
            err = float((g - w).abs().max())
            print(f"  {name:6s} |card - cpu| {err:.3e} scale {scale:.3e} "
                  f"rel {err / scale:.3e} (tol {tol:g})")
            if not err <= tol * scale:
                raise AssertionError(f"cross-check {name}: {err / scale:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import tactilesimulation_tpu_torch  # noqa: F401  (fails outside the repo)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    s = Smoke()
    s.phase("device", s.device)
    if s.failed:
        return 1
    s.phase("build", s.build)
    if not s.failed:
        s.phase("kernels", s.kernels, dev)
        s.phase("slice", s.slice, dev)
        s.phase("cross", s.cross, dev)
    print(f"total {time.perf_counter() - t0:.1f} s")
    if s.failed:
        print(f"FAILED phases: {s.failed}")
        return 1
    rows = []
    for k in KERNELS:
        r = s.kernel_rows[k["lib"]]
        rows.append(dict(name=k["name"], route=k["route"], source=k["source"],
                         replaces=k["replaces"], launches=r["launches"],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": rows}))
    print(s.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
