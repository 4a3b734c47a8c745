#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure: exit code 1 and no result line; each prints its
seconds):
 1. device  - a CUDA device must exist (no CPU fallback); prints the card's
              name and power limit (nvidia-smi) and turns TF32 off;
 2. build   - compiles every kernel library from csrc/ with nvcc, one
              process per source, all started together, and K2/K3's
              source as host C++ that counts operations (megastep_host.py,
              g++) beside them; prints the build seconds and ptxas's report;
 3. kernels - K1 and K1T (csrc/lane_contact.cu) against their plain
              PyTorch versions (the twin, its VJP) on the same card inputs,
              float32, at B = 1024: TactilePush (ground, cuboid),
              StableGrasp (markers in up to 11 segments), TactileInsertion,
              RollingBall 8x8 (sphere) and a hand-made cylinder scene, each
              with static and per-lane parameters; K1 to 1e-5 x the
              output's scale, K1T to K1T_TOL, on every lane but those where
              float32 rounding decides a jump of the contact law
              (K1_ROUNDING_LANES), where both are held to the float64
              twin (K1_F32_VS_F64); two launches bit-equal; times
              at B = 1024 and 16 (launched back to back from Python, and
              the device alone: device_ms), bounds from the operations the
              function needs at the timed inputs (megastep_host.py),
              registers,
              shared memory and resident clusters.
              K2 and K3 (csrc/megastep.cu) against theirs on TactilePush
              contact states: float64 at B = 64; float32 with K2 at
              B = 1024 and K3 at B = 128, the kernel and the f32 plain
              version each against the f64 plain version, and on resting
              contact directly against the f32 plain version. Kernel
              (back to back and device_ms) and plain times at the main
              path's shapes, bounds from the
              operations counted at the timed run's inputs; K2/K3 also at
              B = 16 (the GD width), and each instance's registers, stack,
              shared memory and resident blocks per SM. K4
              (csrc/dense_contact.cu) against its plain version for the 4
              primitive types, float32 and float64, at N = 40,000 and
              40,001 points with some in contact; kernel and plain times at
              N = 40,000 against a sphere, f32. The tactile read (K4R, the
              same source's read entry) against its plain version
              (tactile_query.tactile_field_ref) in float32 and float64 on
              RollingBall 200 x 200 and READ_SCENES, pressed (RollingBall
              8x8, TactilePush, StableGrasp with 11 pairs to a row,
              TactileInsertion, DClaw's cylinder, a pad on the ground and a
              coin, a pad on chains of 40 blocks with 45 coordinates, 41
              joints in 11 depths and 40 pairs): float64 to READ_TOL, float32 to READ_TOL on every row
              but those where float32 rounding decides a jump of the law
              (READ_ROUNDING_ROWS, held as K1's lanes are), one launch a
              read, two launches bit-equal; its times at RollingBall
              200 x 200 f32 (back to back and device_ms; StableGrasp's and
              the block chain's device times) beside its bound (the operations counted by
              megastep_host.HostTactileRead), and the eager aten ops per
              read (TorchDispatchMode);
 4. slice   - slice 1 through its entry points: a TactilePush
              tactile_flatten forward policy rollout at B = 1024 on the lanes
              stepper (``rebuild_solver(mega=False)``; DiagGaussianActor
              [64, 64] elu, random weights from a seed); K1 must launch
              1 + 47 times per env step and K1T 7 (the chord factor's
              pullbacks), the twin never, outputs finite;
 5. train   - slice 2: (a) a differentiable rollout at B = 1024, H = 5 on
              the mega path, -mean(sum of rewards) back to the actor's
              parameters: K2 = K3 = H launches, K1 = 1 + H (tactile obs)
              and K1T = H - 1 (the observations an action was taken on),
              the twin never, finite gradients; eager aten ops per env step
              (forward, backward) and the backward's top host costs;
              (b) the GD trainer
              with examples/TactilePushExp/cfg/gd_tactile.yaml (E = 16,
              H = 100) for 2 epochs: finite loss, the parameters move;
 6. cross   - 2 env steps at B = 16 on the card (mega path, float32)
              against the port on the CPU (lanes stepper and plain
              versions, float64): values, and the BPTT gradient w.r.t. the
              actor's parameters;
 7. rolling - slice 3: (a) the RollingBall sim-speed path at its published
              size (200 x 200 = 40,000 markers, BDF2, float32) through
              ``Simulator.make_rollout_strided(5, fast_tactile=True)``, 350
              steps (cut to ROLL_CUT, past the pad's reaching the ball at
              step 75, if the probe chunk predicts more than
              ROLL_BUDGET_S): one read-kernel launch per tactile read and
              no points-entry launch, q finite, the field nonzero by the
              end; steps/s, ms per step split into factor, sweeps and
              query, the device's busy share over a step; (b) the facade
              (``Simulation`` on the card): its tactile vector equals the
              Simulator's query, one read launch; (c) 10 steps with 2
              reads from the pad pressed onto the ball: the card in
              float64 (the read's double instance) against the CPU in
              float64 (the plain path); the card in float32 held to the
              CPU float32 run's distance from float64.
 8. adjoint - slice 7, the single-instance implicit-function adjoint: (a)
              RollingBall 200 x 200, float32, the CLI's --grad loss
              (``rolling_ball_speed.bptt_loss``: the dense field at every
              chunk end and the final ball position) from the pad pressed
              onto the ball, ADJ_STEPS steps of BPTT at stride 5 (cut to
              ADJ_CUT when the probe predicts past ADJ_BUDGET_S): forward
              and backward ms per step, steps/s, peak memory with remat on
              and off, |g| (finite and non-zero); eager aten ops and the
              device's busy share over one BPTT step (a one-step dense
              rollout with its field); no read kernel under grad;
              (b) ``make_rollout_dense``'s VJP on RollingBall 8 x 8
              pressed, 3 steps, seeded cotangents on q, vars and the field:
              the card in float64 within ADJ_F64_TOL of the CPU's, in
              float32 held to the CPU float32 run's distance from float64;
              (c) the facade's ``backward()`` and ``backward_steps(2)``
              with every flag on, card against CPU in float64.
 9. ppo     - slice 8, PPO on TactilePush (``envs.make("TactilePush-v1")``,
              the single-instance env stepped N = 8 times per vector step,
              ``algorithms.ppo.PPO`` from ppo_tactile.yaml at its widths,
              f32): (a) a probe env step (x N) picks T for PPO_BUDGET_S of
              rollout (at least PPO_T_MIN), num_mini_batch the largest
              divisor of N x T up to the config's 32; ``train(stop_update
              =1)`` and ``play_once`` for PPO_PLAY steps: one read-kernel
              launch per observation (N x (1 + T) + 1 + PPO_PLAY) and no
              points-entry launch; ms per vector step, env steps/s, the
              update's ms, peak memory, finite loss, parameters and
              rewards; the rollout's host seconds split into env steps,
              the policy's act and the obs normalisation; from the last
              vector state, the eager aten ops of an env step, the
              device's busy share over a substep, and its N reads held to
              the plain version (the read kernel's float64 instance at the
              same states on the float64 scene to READ_TOL on every row,
              some row in contact; the float32 observations by
              PPO_READ_F32_VS_F64);
              (b) the single-instance env from a seeded reset, 3 steps into
              the box: the card against the CPU, float64 within
              PPO_F64_TOL of scale (q, qdot, the tactile_flatten and
              privilege obs, the rewards), float32 held to the CPU float32
              run's distance from float64.
10. insertion - slice 9, recurrent PPO on TactileInsertion
              (``envs.make("Insertion-v3")`` in ``TactileInsertionLanes``,
              ``algorithms.ppo_rnn.PPORNN`` by INS_CFG at its widths, N = 8,
              f32): (a) a probe (a substep's momentum and chord, a chord
              factor and a capture at 2N lanes) predicts a script and picks
              T for INS_BUDGET_S of rollout (at least INS_T_MIN);
              ``train(stop_update=1)``: K1 = (1 + T) x (10 factors + 45 x
              11 residuals + 2 captures) and K1T = (1 + T) x 10 x 12
              launches, the twin and the read kernel never; ms per vector
              step split into the script, the policy and the
              normalisation, env steps/s, the update's ms, peak memory,
              eager ops per script (from the probe's parts), the device's
              busy share over a substep's chord; finite loss, parameters,
              rewards and observations, some capture row in contact;
              (b) at the main run's own states: K1 and K1T (per-lane
              parameters, 2N lanes, the first vector step's first capture)
              and their float32 plain versions, each against the float64
              plain version (INS_K1_F32_VS_F64), and their device times; the first vector step's first substep (its
              chord factor and chord from its recorded inputs, and its
              first capture) card against CPU, float64 within INS_F64_TOL,
              float32 (the main run's own values: K1, K1T) within
              ROLL_F32_VS_F64 of the CPU float32 run's distance from
              float64; the vector step around its script (commanded pose,
              reset draws, outcome, flags, merge) card against CPU in
              float64, the last lane at the time limit; (c) the settle on
              INS_SETTLE_CUT, card against CPU in float64; a read plan's
              build time; then ``play_once`` for INS_PLAY steps: the read
              kernel 2 per single-instance
              script, the points entry and K1 never.
11. grasp   - slice 10, StableGrasp (``envs.make("StableGrasp-v1")``,
              tactile_map, f32, through ``GymEnv``), in a second process
              started after kernels (CHILD_PHASES, its output printed
              when it is joined after insertion): (a) the reset's
              180-substep script from the shipped start pose, and one
              step's script if a probe substep predicts it within
              GRASP_BUDGET_S: the read kernel once per script (its
              capture), the points entry never, K1-K3 never (their
              libraries never loaded in that process); a finite (4, 13,
              10) obs, rows in contact at the capture; ms per script and
              substep, eager aten ops and the busy share over a substep;
              the capture's read held to the plain version (the float64
              read at the recorded state on the float64 model to
              READ_TOL, the float32 one by PPO_READ_F32_VS_F64); (b) a
              reset and one step on GRASP_SHORT from GRASP_DRAWS, card
              against CPU: densities, poses, both captured fields and
              obs, the reward (float64 within ADJ_F64_TOL of scale,
              float32 within ROLL_F32_VS_F64 of the CPU float32 run's
              distance from float64), success equal;
12. dclaw   - slice 10, DClaw cap rotation
              (``envs.make("TactileRotation-v1")``, tactile, f32, through
              ``GymEnv``), in the same second process: (a) a reset and
              DCLAW_STEPS random steps with reset-on-done, then a reset
              onto DCLAW_CONTACT: the read kernel once per observation,
              the points entry and K1-K3 never; finite obs of 3,618, in
              contact at DCLAW_CONTACT, where the read is held to the plain
              version as in grasp; env steps/s, eager aten ops and the
              busy share over a substep; (b) from DCLAW_CONTACT a reset and
              the steps DCLAW_CROSS_US, card against CPU as in grasp (q,
              qdot, every obs, the rewards; flags equal); then resets with
              the radii DCLAW_RADII on the card: each read equal to the
              plain version on its own Model, through a plan of its own.

The line before the card's line is the kernel table as JSON; the last line
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

B_MAIN = 1024            # lanes of the main path
H_MAIN = 2               # env steps of the timed slice-1 run
H_TRAIN = 5              # env steps of the timed differentiable rollout
B_CROSS, H_CROSS = 16, 2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # non-tensor-core fp32 peak
ACTOR_CFG = {"actor_mlp": {"layer_sizes": [64, 64], "activation": "elu",
                           "layernorm": False},
             "actor_logstd_init": -1.0}
K1_TOL = 1e-5
# K1T against the twin's VJP, float32: each cotangent sums up to 4,906
# points' terms (StableGrasp) and the twin's autograd sums them in another
# order (and pulls the box's R through quat_rotate where the kernel uses
# the matrix), so each is held to 1e-4 of its scale and by its cosine
K1T_TOL = {"rel": 1e-4, "cos": 0.99999}
# Inside a box the contact normal is the axis of least depth, a function
# that jumps where two axes tie; a point within float32 rounding of such a
# tie takes its axis from the rounding (StableGrasp, B = 1024, seed 0: lane
# 961's marker 13 of segment 60, 5.1 mm deep, its two deepest axes 1.9e-9
# apart). There the float32 plain version itself parts from the float64 one
# (by 5e-5 of F's scale, 5e-2 of the tactile rows'), and two float32
# implementations may take either side. The derivative jumps at every kink
# of the law (relu of the normal velocity, the friction cap's max, the
# box's axis), so the VJP meets more such points (StableGrasp: lanes 245
# and 354, bquat's cotangent 1.3e-4 of scale off float64). Such lanes (the
# float32 plain version, or its VJP's per-lane cotangents, off the float64
# one by more than K1_TOL, K1T_TOL["rel"], of the scale) are set aside,
# listed, and must be at most this share of the lanes; K1 and K1T are held
# to their plain versions on all the others. On the set-aside lanes they
# are held to the float64 twin, within K1_F32_VS_F64 x the jump the float64
# twin makes itself there when each per-lane input moves by up to K1_JITTER
# of itself (the largest over K1_JITTER_RUNS random moves), plus K1_TOL
# (K1T_TOL["rel"]), each over the output's scale. Not the float32 twin's
# distance: at a two-axis tie a float32 run may take either axis or, on an
# exact tie, their average, half way (lane 961: the float32 twin 5.0e-5 of
# F's scale off float64, the kernel 9.6e-5).
K1_ROUNDING_LANES = 0.01
K1_F32_VS_F64 = 1.25
K1_JITTER, K1_JITTER_RUNS = 2.0 ** -22, 32
# K2/K3 against their plain version. float64: the same algorithm in the same
# order to round-off (measured 2e-13 on values, 1e-14 on gradients); the
# chord's stop masks cannot flip at this precision.
K23_F64_TOL = {"fwd": 1e-9, "bwd": 1e-7}
# float32 on contact_state's states, where the f32 chord does not converge
# within 8 sweeps (f32 and f64 also ridge J differently, 1e-7 against 1e-12)
# and parts from f64 by up to 1.1e-1 of scale on K2, 1.4e-2 on K3: the
# kernel and the f32 plain version are each held to the f64 plain version,
# and the kernel's error (max abs over scale) must stay within 1.25x the
# plain version's plus 1e-5 of scale. Both are f32 runs of one algorithm
# that differ in summation order (and the plain version's index_add, whose
# atomics vary from run to run); on the card the two errors agreed to
# three digits (ratio 1.000), so a kernel that adds a quarter of f32's own
# error fails.
K23_F32_VS_F64 = (1.25, 1e-5)
# float32, directly against the f32 plain version, on resting contact
# (resting_contact), where the chord converges: f32's stop rule (1e-4 x the
# first residual) lets the two stop one sweep apart on a lane (1.2e-4 of
# scale measured on the card on K2's vs).
K23_F32_TOL = {"fwd": 1e-3, "fwd_cos": 0.99999, "bwd": 1e-3,
               "bwd_cos": 0.99999}
# card (mega, f32) against CPU (lanes, f64) BPTT gradient (see cross())
CROSS_GRAD_TOL = {"rel": 1e-3, "cos": 0.99999}
# K4 against its plain version: float64 runs the same arithmetic in the same
# order, only nvcc's fused multiply-adds round differently (measured 6e-16 of
# scale on the card); float32 the same at float's precision, where the
# cancellation r - radius near the surface costs up to |x| x 2^-24 against
# forces of order kn x penetration (measured 3.6e-7 of scale).
K4_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# flops per point of K4, counted from csrc/dense_contact.cu: the force law 41
# (as K1's), the ground plane 6; a primitive adds world to local 18, the
# primitive's surface velocity and the relative velocity 18, the normal back
# to world 15, and its SDF: sphere 11, cylinder 29, cuboid 36
K4_FLOPS_PER_POINT = {-1: 47, 0: 128, 1: 121, 2: 103}
K4_N = 40000             # RollingBall 200 x 200 markers against the sphere
# the tactile read against its plain version: float64 the same function to
# round-off (the kernel takes the marker velocities from its FK's dual part,
# the plain version from the joints' analytic twists; 2e-16 to 7e-15 of
# scale on the host build); float32 to float's precision, with the rows
# where float32 rounding decides a jump of the law (a cuboid's tied axes)
# set aside as K1's lanes are (at most READ_ROUNDING_ROWS of the rows; there
# held to the float64 plain version within K1_F32_VS_F64 of its own jump
# under K1_JITTER moves of q and v). The f32 host build of the kernel's
# source (g++ -mfma) stays within 1.8e-6 of scale of the f32 plain version
# on READ_SCENES.
READ_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
READ_ROUNDING_ROWS = 0.01
# an env's float64 read at its own recorded state, where the contact may be
# light (StableGrasp's capture: 260 rows at 7.5e-4 N of scale, the read
# 1.9e-12 of scale off the plain version on the card): held to READ_TOL of
# scale plus K1_F32_VS_F64 x the jump the plain version makes itself when
# q and v move by up to READ_F64_JITTER of themselves (K1_JITTER_RUNS moves)
READ_F64_JITTER = 2.0 ** -50
ROLL_RES, ROLL_STRIDE, ROLL_STEPS, ROLL_CUT = 200, 5, 350, 100
ROLL_BUDGET_S = 150.0    # cut the rolling main path to ROLL_CUT past this
# card against CPU over 10 RollingBall steps from the pad pressed onto the
# ball (see rolling()), each max abs over the CPU float64 run's scale.
# float64 on both: the same algorithm to round-off.
ROLL_F64_TOL = {"q": 1e-9, "qdot": 1e-9, "tactile": 1e-8}
# float32: in this window the light ball (3.4e-5 kg, 5e-9 kg m^2) is
# squeezed out sideways at step 7, and there float32 parts from float64 as
# a property of f32 itself: on the CPU alone, q by 2.0x its scale (the
# ball's spin), qdot by 1.2x, the markers by 0.95x (the f32 chord stops at
# 1e-4 x the first residual, whose norm the pad's dofs dominate). So, as
# for K2/K3 (K23_F32_VS_F64), the card's float32 run is held to the CPU's
# float32 run's distance from float64: within 1.25x of it plus 1e-5.
ROLL_F32_VS_F64 = (1.25, 1e-5)
# the adjoint phase: BPTT steps of the --grad protocol on RollingBall
# 200 x 200 (stride ROLL_STRIDE), cut to ADJ_CUT when the probe predicts
# the phase's BPTT runs past ADJ_BUDGET_S
ADJ_STEPS, ADJ_CUT = 10, 5
ADJ_BUDGET_S = 90.0
# card against CPU, float64, for the single-instance adjoint (the rollout's
# VJP and the facade's backward): the same algorithm to round-off, each
# gradient's max abs error over its CPU scale; float32 is held to the CPU
# float32 run's distance from float64 (ROLL_F32_VS_F64)
ADJ_F64_TOL = 1e-9
# the ppo phase: PPO on TactilePush by ppo_tactile.yaml (its nets and
# N = 8), the rollout cut to the vector steps a probe says fit
# PPO_BUDGET_S (at least PPO_T_MIN; one step on the hosts seen so far, to
# leave room for the insertion phase), one update, then play_once for
# PPO_PLAY steps; card against CPU over PPO_CROSS_US from a seeded reset
# (the pad reaches the box by the third step), float64 to PPO_F64_TOL of
# scale (the same algorithm to round-off), float32 held to the CPU float32
# run's distance from float64 (ROLL_F32_VS_F64)
PPO_BUDGET_S = 45.0
PPO_T_MIN = 1
PPO_PLAY = 1
PPO_CROSS_US = ((2.0, 0.3, -0.2), (2.0, -0.1, 0.1), (1.5, 0.0, 0.0))
PPO_F64_TOL = 1e-9
# the PPO run's float32 reads against the float64 plain version (the same
# float32 model, widened): within 3 x the float32 plain version's distance
# + 1e-5 of scale. Not the kernels phase's per-row rule: TactilePush's
# light contact (mN) takes its depth from a difference of near-equal
# coordinates, so the float32 plain version itself parts from float64 by
# more than READ_TOL on far more than READ_ROUNDING_ROWS of the rows (the
# phase prints how many). Not K23_F32_VS_F64's 1.25: K2/K3's plain version
# runs their algorithm, whose float32 error matches theirs to three
# digits, while the read's plain version takes the markers' velocities
# from analytic twists where the kernel takes FK's dual part, another
# rounding (the kernel's error was 0.87, 1.39, 2.08 and 2.12 x the plain
# version's in four runs on the card)
PPO_READ_F32_VS_F64 = (3.0, 1e-5)
# the insertion phase: recurrent PPO on TactileInsertion by INS_CFG (its
# nets, N = 8, f32) through the lane-major vec env, the rollout cut to the
# vector steps a probe says fit INS_BUDGET_S (at least INS_T_MIN), one
# update, then play_once for INS_PLAY steps (a step of the single-instance
# env is a ~1 minute script on the card's host: the whole script must stay
# under the 1,200 s limit on the slowest host). A script is 45 stiff substeps of a
# chord that refreshes its Jacobian every 5 and does not converge in its
# 10 sweeps; its discrete choices (the best iterate, frozen lanes) flip
# under round-off, and many lanes throw the box off the pads, so whole
# scripts part lane by lane at round-off (the JAX lanes env runs the same
# algorithm). The card is therefore held to the CPU per substep, at the
# main run's own recorded inputs: one chord factor, one chord and one
# capture, float64 (the plain lane contact: K1 has no float64 instance)
# within INS_F64_TOL of scale, float32 (K1, K1T) within ROLL_F32_VS_F64 of
# the CPU float32 run's distance from float64; the vector step around its
# script and the settle on INS_SETTLE_CUT (ramps, hold) in float64 within
# INS_F64_TOL
INS_BUDGET_S = 60.0
INS_T_MIN = 1
INS_PLAY = 1
INS_F64_TOL = ADJ_F64_TOL
# K1 and K1T at the path's own state, held as the PPO run's reads are
# (PPO_READ_F32_VS_F64): the pads' light contact takes its depth from a
# difference of near-equal coordinates, and the kernel (the box's matrix)
# and the plain version (quat_rotate) round it apart, so neither is held
# to the other row by row; each is held to the float64 plain version, the
# kernel within 3 x the float32 plain version's distance + K1_TOL of
# scale (K1T_TOL["rel"] for K1T). On the card (NVIDIA H100 80GB HBM3,
# 700.00 W) the kernels phase's rule failed here: the kernel 3.1e-5 of the
# tactile rows' scale off the float32 plain version on a lane where that
# version is within 1e-5 of float64, which parts by 2.0e-5 on another
INS_K1_F32_VS_F64 = 3.0
INS_SETTLE_CUT = ((2, 2, 2), 2)
# the grasp and dclaw phases run in a second process beside the phases after
# kernels (their eager dispatch is host work on another core; their device
# work is a small share of a substep): CHILD_PHASES, joined before the
# kernel table is printed
CHILD_PHASES = ("grasp", "dclaw")
CHILD_DEADLINE_S = 1140.0      # the child is stopped at this time of the run
# the grasp phase: StableGrasp-v1 (tactile_map, f32) through GymEnv; the
# reset's full script (180 substeps) always runs, a step's full script only
# when a probe substep predicts it within GRASP_BUDGET_S. Card against CPU
# on GRASP_SHORT (stage substeps, capture index: 20 substeps, the capture
# at the first substep of the lift) from GRASP_DRAWS (RandomState seed: a
# bar the pads hold at that substep; on this schedule the pads hold a bar
# for about 3 substeps, from substep 13 to 16 by its masses, and some bars
# not at all) and an action of
# GRASP_ACTION, float64
# within ADJ_F64_TOL of scale, float32 held to the CPU float32 run's
# distance from float64 (ROLL_F32_VS_F64)
GRASP_BUDGET_S = 150.0
GRASP_SHORT = ([2, 12, 2, 1, 1, 1, 1], 15)
GRASP_DRAWS = 4
GRASP_ACTION = 0.5
# the dclaw phase: TactileRotation-v1 (tactile, f32) through GymEnv, a reset
# and DCLAW_STEPS random steps with reset-on-done, then a reset onto
# DCLAW_CONTACT (the cap's radius 0.055 at the nominal finger pose: every
# fingertip on the cap's rim); card against CPU from DCLAW_CONTACT, 3 steps
# of DCLAW_CROSS_US, then resets with the radii DCLAW_RADII, each read held
# to the plain version on its own Model
DCLAW_STEPS = 3
DCLAW_CONTACT = {"noise": [0.0] * 9, "damping": 0.3, "radius": 0.055,
                 "dxy": [0.0, 0.0]}
DCLAW_CROSS_US = ((0.4, -0.3, 0.8, 0.1, 0.5, -0.6, 0.2, -0.2, 0.9),
                  (1.6, -0.5, 0.3, -1.3, 0.2, 0.7, 0.0, 1.2, -0.4),
                  (-0.2, 0.1, 0.0, 0.3, -0.4, 0.2, 0.5, 0.0, -0.1))
DCLAW_RADII = (0.03, 0.07)
MEGA = "tactilesimulation_tpu_torch/csrc/megastep.cu"
LANE = "tactilesimulation_tpu_torch/csrc/lane_contact.cu"
DENSE = "tactilesimulation_tpu_torch/csrc/dense_contact.cu"
KERNELS = [dict(name="K1 lane_contact", key="K1", lib="lane_contact",
                route="cuda", source=LANE,
                replaces="tactilesimulation_tpu/ops/lane_contact.py:413"),
           dict(name="K1T lane_contact adjoint", key="K1T",
                lib="lane_contact", route="cuda", source=LANE,
                replaces="tactilesimulation_tpu/ops/lane_contact.py:452"),
           dict(name="K2 megastep forward", key="K2", lib="megastep",
                route="cuda", source=MEGA,
                replaces="tactilesimulation_tpu/ops/megastep.py:799"),
           dict(name="K3 megastep adjoint", key="K3", lib="megastep",
                route="cuda", source=MEGA,
                replaces="tactilesimulation_tpu/ops/megastep.py:831"),
           dict(name="K4 dense_contact", key="K4", lib="dense_contact",
                route="cuda", source=DENSE,
                replaces="tactilesimulation_tpu/ops/dense_contact.py:174"),
           dict(name="K4 tactile read", key="K4R", lib="dense_contact",
                route="cuda", source=DENSE,
                replaces="tactilesimulation_tpu/ops/dense_contact.py:174")]
PPO_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "TactilePushExp", "cfg", "ppo_tactile.yaml")
INS_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "TactileInsertionExp", "cfg",
                       "tactile_insertion_trans_and_rot.yaml")
GD_CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                      "TactilePushExp", "cfg", "gd_tactile.yaml")


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


K1_SCENES = ("tactile_push", "stable_grasp", "tactile_insertion",
             "rolling_ball_8", "cylinder_probe")


def k1_scene(name):
    """(struct, model) of one of K1_SCENES."""
    from tactilesimulation_tpu_torch.model import scenes, task_scenes
    return {"tactile_push": task_scenes.tactile_push,
            "stable_grasp": task_scenes.stable_grasp,
            "tactile_insertion": task_scenes.tactile_insertion,
            "rolling_ball_8": lambda: task_scenes.rolling_ball(8),
            "cylinder_probe": lambda: cylinder_probe(scenes)}[name]()


def pair_wrench_inputs(name, B, seed=0, tie=False):
    """(op, args, per_lane): a PairWrenches for scene ``name``, its 11
    inputs (float64 CPU tensors) with contacts in every lane, and per-lane
    (K, 4, B) parameters (0.5-1.5 x the static ones).

    TactilePush, RollingBall and the cylinder probe take contact_state's
    bodies. StableGrasp and TactileInsertion start from q_init (fingers
    open, nothing touching), so each primitive is moved onto the points of
    the first segment that meets it, a quarter of its size off per lane,
    and the ground up to the mean height of its points: some points in
    contact and some out, and (StableGrasp) each pad marker against up to
    11 blocks.

    ``tie`` puts points exactly on kinks of the contact law, for float64
    checks of the tie rules: TactilePush's lane 0 first pad point inside
    the box exactly as deep on two axes (amax's tie); StableGrasp's and
    TactileInsertion's ground at the median height of its points, so one
    point lies on it (relu's tie at 0). In float32 the rounding of the
    inputs and of each implementation picks a side of such a kink, which
    moves a cotangent by that point's whole term (2e-4 of scale on
    TactileInsertion's jp), so float32 checks take ``tie=False``."""
    from tactilesimulation_tpu_torch.ops import lane_contact
    from tactilesimulation_tpu_torch.sim import contact, lanes
    struct, model = k1_scene(name)
    rng = np.random.RandomState(seed)
    if name in ("stable_grasp", "tactile_insertion"):
        n = struct.ndof_q
        q = model.q_init.numpy()[:, None] + 1e-3 * rng.randn(n, B)
        v = 0.1 * rng.randn(n, B)
    else:
        q, v = contact_state(name, model.q_init.numpy(), B, seed=seed)
    with torch.no_grad():
        jp, jq, bp, bquat, _, _, _, Om, be = lanes._fused_small_stage(
            struct, model, torch.as_tensor(q), torch.as_tensor(v))
        op = lane_contact.PairWrenches(struct)
        params = contact.combined_params(model)
        xi = lane_contact.pack_points(struct, model, op.src_idx)
    gpos = model.ground_pos.clone()
    off = np.cumsum([0] + [sg.n for sg in op.segments])

    def world(i):
        sg = op.segments[i]
        x = xi[off[i]:off[i] + sg.n].T[:, :, None]
        return jp[:, sg.joint][:, None] + lanes.quat_rotate(
            jq[:, sg.joint][:, None], x)                   # (3, n, B)

    if name in ("stable_grasp", "tactile_insertion"):
        placed = set()
        for i, sg in enumerate(op.segments):
            if sg.prim_body >= 0 and sg.prim_body not in placed:
                placed.add(sg.prim_body)
                size = model.body_size[sg.prim_body].numpy()
                bp[:, sg.prim_body] = world(i).mean(dim=1) + torch.as_tensor(
                    0.25 * size[:, None] * rng.randn(3, B))
        z = [world(i)[2] for i, sg in enumerate(op.segments)
             if sg.prim_body < 0]
        if z:
            z = torch.cat(z)
            gpos[2] = z.median() if tie else z.mean()
    if tie and name == "tactile_push":
        i = next(i for i, sg in enumerate(op.segments) if sg.gtype == 0)
        sg = op.segments[i]
        x0 = xi[off[i]].numpy()
        jq[:, sg.joint, 0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
        p = jp[:, sg.joint, 0].numpy().copy()
        p[1] = p[0] + x0[0] - x0[1]
        while p[1] + x0[1] != p[0] + x0[0]:        # x[0] == x[1] exactly
            p[1] = np.nextafter(p[1], np.inf if p[1] + x0[1] < p[0] + x0[0]
                                else -np.inf)
        jp[:, sg.joint, 0] = torch.as_tensor(p)
        x = p + x0
        depth = 0.5 * float(model.body_size[sg.prim_body, 0]) - 0.004
        bquat[:, sg.prim_body, 0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
        bp[:, sg.prim_body, 0] = torch.as_tensor(
            [x[0] - depth, x[1] - depth, x[2]])
    args = [jp, jq, Om, be, bp, bquat, model.body_size, params,
            gpos, model.ground_normal, xi]
    per_lane = params[:, :, None] * torch.as_tensor(
        np.random.RandomState(seed + 1).uniform(
            0.5, 1.5, tuple(params.shape) + (B,)))
    return op, [a.contiguous() for a in args], per_lane.contiguous()


def resting_contact(q_init, B, seed, pad_speed=0.0):
    """TactilePush (q, v) float64 (n, B) with the pad pressed 0.1-1 mm into
    the box and the box up to 0.3 mm into the ground, at rest but for the
    pad's velocity (``pad_speed`` x a standard normal draw per coordinate):
    contact in every lane, and the chord converges from the entry
    factor."""
    rng = np.random.RandomState(seed)
    q = np.repeat(q_init[:, None], B, axis=1)
    q[1] = rng.uniform(0.0001, 0.001, B)
    q[5] = rng.uniform(-0.0003, 0.0, B)
    v = np.zeros_like(q)
    v[:3] = pad_speed * rng.randn(3, B)
    return q, v


def ground_pad(scenes):
    """A pad with an 8 x 8 marker grid on its underside over the ground and
    a thin cuboid (a coin) sunk in the ground under part of it: the tactile
    read's ground pair, which no task scene has, and a second pair adding
    into the same rows."""
    b = scenes.SceneBuilder("ground_pad", ground=(0, 0, 0))
    jp = b.add_joint("pad", "free3d-exp", pos=(0, 0, 0.005))
    pad = b.add_body("pad", jp, "cuboid", size=(0.04, 0.04, 0.01),
                     density=500.0, contact_resolution=(2, 2, 2))
    jc = b.add_joint("coin", "fixed", pos=(0.01, 0, -0.002))
    coin = b.add_body("coin", jc, "cuboid", size=(0.02, 0.03, 0.006),
                      density=500.0)
    b.add_ground_contact(pad, kn=1e3, kt=1.0, mu=0.8, damping=0.3)
    b.add_contact(pad, coin, kn=1e3, kt=1.0, mu=0.8, damping=0.3)
    b.add_rect_tactile("pad", pad, rect_pos0=(-0.018, 0.018, -0.005),
                       rect_pos1=(0.018, -0.018, -0.005), axis0=(0, -1, 0),
                       axis1=(1, 0, 0), rows=8, cols=8, kn=1e2, kt=1.0,
                       mu=1.0, damping=1.0)
    return b.build()


def block_chain(scenes, blocks=40, link=10):
    """A pad with a 20 x 20 marker grid over a row of ``blocks`` thin
    cuboids: the first fixed, the others each on a revolute joint (about
    z), in chains of ``link`` under the first: more coordinates, joints and
    pairs than a warp has lanes, ``link`` tree depths below the root, and
    ``blocks`` pairs adding into the same rows. (In float32 a chain's
    error grows with its depth: at 40 deep the plain version itself parts
    from float64 by more than READ_TOL on 1.5 % of the rows.)"""
    b = scenes.SceneBuilder("block_chain", ground=(0, 0, 0))
    jp = b.add_joint("pad", "free3d-exp", pos=(0, 0, 0.009))
    pad = b.add_body("pad", jp, "cuboid", size=(0.04, 0.04, 0.01),
                     density=500.0, contact_resolution=(2, 2, 2))
    root = parent = b.add_joint("block0", "fixed", pos=(-0.0195, 0, 0.002))
    chain = [b.add_body("block0", parent, "cuboid",
                        size=(0.001, 0.03, 0.004), density=500.0)]
    for k in range(1, blocks):
        pos = (0.001 * k, 0, 0) if k % link == 0 else (0.001, 0, 0)
        parent = b.add_joint(f"block{k}", "revolute",
                             parent=root if k % link == 0 else parent,
                             pos=pos, axis=(0, 0, 1))
        chain.append(b.add_body(f"block{k}", parent, "cuboid",
                                size=(0.001, 0.03, 0.004), density=500.0))
    for blk in chain:
        b.add_contact(pad, blk, kn=1e3, kt=1.0, mu=0.8, damping=0.3)
    b.add_rect_tactile("pad", pad, rect_pos0=(-0.018, 0.018, -0.005),
                       rect_pos1=(0.018, -0.018, -0.005), axis0=(0, -1, 0),
                       axis1=(1, 0, 0), rows=20, cols=20, kn=1e2, kt=1.0,
                       mu=1.0, damping=1.0)
    return b.build()


# the tactile read's scenes, each with its sensors pressed (read_state)
READ_SCENES = ("rolling_ball_8", "tactile_push", "stable_grasp",
               "tactile_insertion", "dclaw", "ground_pad", "block_chain")


def read_scene(name, task_scenes, scenes):
    """(struct, model) of a READ_SCENES entry (or "rolling_ball_200"),
    built with the given scene modules (the port's or the JAX package's)."""
    if name.startswith("rolling_ball_"):
        return task_scenes.rolling_ball(resolution=int(name[13:]))
    if name == "ground_pad":
        return ground_pad(scenes)
    if name == "block_chain":
        return block_chain(scenes)
    return getattr(task_scenes, name)()


def read_state(name, struct, model, seed=0):
    """(q, v, edits) float64 numpy with the scene's tactile markers pressed
    into its primitives; ``edits`` maps model leaves to new values (numpy)
    that the state needs:
    - RollingBall: the pad's underside 1 mm into the ball's top, the ball
      off centre and turned;
    - TactilePush: the box face 1 mm into the pad (tests/test_ops.py:68-87);
    - StableGrasp: q = 0 but the gripper at z = 0.19 with its fingers
      closed 10 mm: each pad's 130 markers against the bar's 11 blocks,
      pairs that share rows;
    - TactileInsertion: the gripper at z = 0.15, fingers closed 10 mm;
    - DClaw: the cap widened from 0.04 to 0.055 m (the fingertips sweep at
      0.06 m from its axis and never reach a 0.04 m cap), fingers near 0;
    - ground_pad: the pad's underside 0.5 mm into the ground, tilted, and
      1.5 mm into the coin's top over the coin;
    - block_chain: the pad's underside 0.5 mm into the blocks' tops,
      tilted, the chain's joints turned by about a milliradian.
    Every state has velocities, so the shear is nonzero too."""
    from tactilesimulation_tpu_torch.sim import kinematics
    rng = np.random.RandomState(seed)
    q = model.q_init.detach().cpu().numpy().astype(np.float64).copy()
    edits = {}
    if name.startswith("rolling_ball_"):
        q[2] = -0.016
        q[3:6] += 1e-3 * rng.randn(3)
        q[6:9] = 0.1 * rng.randn(3)
        return q, 0.05 * rng.randn(q.shape[0]), edits
    if name == "tactile_push":
        var = kinematics.ee_positions(struct, model, torch.as_tensor(q))
        var = var.numpy().reshape(2, 3)
        off = struct.joint_dof_offset[struct.joint_index(
            "box_translational_joint")]
        q[off:off + 3] += var[0] - var[1] - np.array([0.001, 0.0, 0.0])
        return q, 0.1 * rng.randn(q.shape[0]), edits
    if name in ("stable_grasp", "tactile_insertion"):
        q[:] = 0.0
        q[2] = 0.19 if name == "stable_grasp" else 0.15
        q[4] = q[5] = -0.01
    elif name == "dclaw":
        size = model.body_size.detach().cpu().numpy().copy()
        size[struct.body_index("cap"), 0] = 0.055
        edits["body_size"] = size
        q = 0.02 * rng.randn(q.shape[0])
    elif name == "ground_pad":
        q[2] = -0.0005
        q[3:6] = 0.01 * rng.randn(3)
    elif name == "block_chain":
        q[2] = -0.0005
        q[3:6] = 0.01 * rng.randn(3)
        q[6:] = 1e-3 * rng.randn(q.shape[0] - 6)
    return q, 0.05 * rng.randn(q.shape[0]), edits


def read_case(name, dtype=torch.float64, dev="cpu", seed=0):
    """(struct, model, q, v) of read_scene(name) on ``dev`` in ``dtype``
    at read_state's pressed state, through the port's modules."""
    from tactilesimulation_tpu_torch.model import scenes, task_scenes
    struct, model = read_scene(name, task_scenes, scenes)
    q, v, edits = read_state(name, struct, model, seed)
    model = dataclasses.replace(model, **{
        k: torch.as_tensor(a, dtype=model.dtype) for k, a in edits.items()})
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev).contiguous()
    return struct, model.to(dev, dtype), t(q), t(v)


def _flat_model(model):
    from tactilesimulation_tpu_torch.sim.types import Model
    return torch.cat([getattr(model, f.name).detach().reshape(-1).double()
                      .cpu() for f in dataclasses.fields(Model)])


def dense_vjp(struct, model64, dev, dtype, q, v, us, seed=5):
    """``Simulator.make_rollout_dense``'s VJP from (q, v) under ``us`` with
    seeded cotangents on q, vars and the tactile field: {name: float64 CPU
    tensor} for q0, qdot0, u and the Model's cotangent (leaves flattened in
    field order)."""
    from tactilesimulation_tpu_torch.sim import simulation
    from tactilesimulation_tpu_torch.sim.types import Model
    model = model64.to(dev, dtype)
    sim = simulation.Simulator(struct, model)
    T = len(us)
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  dtype=dtype, device=dev)
    cots = [t(rng.randn(T, w) * scale) for w, scale in (
        (struct.ndof_q, 1.0), (struct.ndof_var, 1.0),
        (struct.ndof_tactile, 1e2))]
    q0, v0, u = (t(a).requires_grad_() for a in (q, v, us))
    m = Model(**{f.name: getattr(model, f.name).detach().clone()
                 .requires_grad_() for f in dataclasses.fields(Model)})
    state0 = sim.init_state(m, q=q, qdot=v).replace(q=q0, qdot=v0)
    _, qs, vars_, tacs = sim.make_rollout_dense()(m, state0, u)
    live = [(o, c) for o, c in zip((qs, vars_, tacs), cots)
            if o.requires_grad]
    wrt = [q0, v0, u] + [getattr(m, f.name) for f in dataclasses.fields(Model)]
    g = torch.autograd.grad([o for o, _ in live], wrt, [c for _, c in live],
                            materialize_grads=True)
    out = {k: y.detach().double().cpu() for k, y in
           zip(("q0", "qdot0", "u"), g[:3])}
    out["model"] = _flat_model(Model(*g[3:]))
    return out


def facade_backward(struct, model64, dev, dtype, q, v, seed=6):
    """The facade on RollingBall: ``reset(backward_flag=True)`` at (q, v),
    one step and then two in one call, ``backward()`` and
    ``backward_steps(2)`` with seeded q and tactile cotangents and every
    flag on: {name: float64 CPU tensor}."""
    from tactilesimulation_tpu_torch.sim import simulation
    fac = simulation.Simulation((struct, model64), device=dev, dtype=dtype)
    fac.set_state_init(q, v)
    fac.reset(backward_flag=True)
    fac.set_u([0.1, 0.0, 0.2])
    fac.forward(1)
    fac.set_u([0.0, 0.1, 0.25])
    fac.forward(2)
    rng = np.random.RandomState(seed)
    cq = rng.randn(3, struct.ndof_q)
    ctac = 1e2 * rng.randn(3, struct.ndof_tactile)
    bi = fac.backward_info
    bi.set_flags(flag_q0=True, flag_qdot0=True, flag_p=True, flag_u=True)
    bi.df_dvar = np.zeros(0)
    out = {}
    for name, T in (("backward", 3), ("backward_steps(2)", 2)):
        bi.df_dq, bi.df_dtactile = (cq[-T:].reshape(-1),
                                    ctac[-T:].reshape(-1))
        if T == 3:
            fac.backward()
        else:
            fac.backward_steps(T)
        r = fac.backward_results
        for k in ("df_dq0", "df_dqdot0", "df_du"):
            out[f"{name} {k}"] = torch.as_tensor(getattr(r, k)).double()
        out[f"{name} df_dp"] = _flat_model(r.df_dp)
    return out


def read_f64_tol(struct, m64, q64, v64, ref64):
    """(tolerance, jump) of a float64 read at (q64, v64) against its plain
    version ``ref64``: READ_TOL of scale plus K1_F32_VS_F64 x the jump the
    plain version makes itself when q and v move by up to READ_F64_JITTER
    of themselves (the largest of K1_JITTER_RUNS moves). Light contact
    takes a force of kn x a sub-micrometre depth, a difference of
    near-equal coordinates, which moves at round-off when they do."""
    from tactilesimulation_tpu_torch.ops import tactile_query
    gen = torch.Generator(device=q64.device).manual_seed(0)
    moved = lambda a: a * (1 + READ_F64_JITTER * (2 * torch.rand(
        a.shape, generator=gen, device=a.device, dtype=torch.float64) - 1))
    jump = max(float((tactile_query.tactile_field_ref(
        struct, m64, moved(q64), moved(v64)) - ref64).abs().max())
        for _ in range(K1_JITTER_RUNS))
    scale = float(ref64.abs().max())
    return READ_TOL[torch.float64] * scale + K1_F32_VS_F64 * jump, jump


def max_rel(got, want):
    """max |got - want| over max |want|, each a {name: tensor}."""
    return {k: float((got[k] - w).abs().max())
            / max(float(w.abs().max()), 1e-300) for k, w in want.items()}


class AtenCount:
    """Counts every aten op the host dispatches inside ``with``."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


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


def device_ms(fn, iters, warmup=3):
    """The device's time for one call of ``fn``: the calls are queued
    behind a sleep kernel (~0.1 s), so the card runs their kernels back to
    back whatever the host's pace (cuda_ms sees the slower of the two)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def insertion_env(dev, dtype):
    """The single-instance env of INS_CFG on ``dev`` in ``dtype``, and the
    cfg's ``params``."""
    import yaml
    from tactilesimulation_tpu_torch import envs
    with open(INS_CFG) as fp:
        cfg = yaml.safe_load(fp)["params"]
    kw = dict(cfg["env"])
    name = kw.pop("name")
    kw.pop("lane_vec", None)
    return envs.make(name, device=dev, dtype=dtype, seed=0, **kw), cfg


def insertion_lanes(dev, dtype):
    """The lane env of INS_CFG on ``dev`` in ``dtype``: K1 on the card in
    float32, the plain lane contact otherwise (K1 has no float64
    instance)."""
    from tactilesimulation_tpu_torch.envs.tactile_insertion_lanes import \
        TactileInsertionLanes
    return TactileInsertionLanes(insertion_env(dev, dtype)[0],
                                 fused="auto" if dtype == torch.float32
                                 else False)


def insertion_settle(dev):
    """The insertion scene's settle on INS_SETTLE_CUT, float64."""
    from tactilesimulation_tpu_torch.envs import tactile_insertion
    from tactilesimulation_tpu_torch.model import task_scenes
    struct, model = task_scenes.tactile_insertion()
    stages, hold = INS_SETTLE_CUT
    return tactile_insertion.settle(struct, model.to(dev, torch.float64),
                                    stages=stages, hold=hold).cpu()


def insertion_outputs(out, final_q):
    """{name: float64 CPU tensor} of a ``vec_step_autoreset`` output and
    its execution's final q (the step side's lanes)."""
    st, obs, t, reward, done, bad, success = out
    B = obs.shape[0]
    res = {"obs": obs, "reward": reward, "final_q": final_q[:, :B],
           "t": t, "done": done, "bad": bad, "success": success}
    for f in dataclasses.fields(st):
        res[f"state.{f.name}"] = getattr(st, f.name)
    return {k: v.detach().double().cpu() for k, v in res.items()}


def insertion_substep(lenv, inputs, v0, capture):
    """The first substep of a lane script from the main run's recorded
    inputs, on ``lenv``'s device and dtype: the chord factor at (inputs,
    v0), the chord from it, and the capture at the main run's recorded
    (model, q, v) -> {name: float64 CPU tensor}."""
    from tactilesimulation_tpu_torch.envs import tactile_insertion_lanes
    from tactilesimulation_tpu_torch.sim import lanes
    dev, dtype = lenv.device, lenv.dtype
    to = lambda x: x.to(dev, dtype)
    inputs = lanes.StepInputs(model=inputs.model.to(dev, dtype),
                              u=to(inputs.u), q_base=to(inputs.q_base),
                              p_base=to(inputs.p_base),
                              gamma=to(inputs.gamma))
    v0 = to(v0)
    with torch.no_grad():
        lu = lanes.make_chord_lu(lenv._residual, inputs, v0)
        v = lanes._chord(lenv._residual, lenv.max_iter,
                         tactile_insertion_lanes.chord_tol(lenv.struct,
                                                           dtype),
                         inputs, v0, lu)
        model, q, qd = capture
        field = lenv._tactile(model.to(dev, dtype), to(q), to(qd))
    return {k: x.detach().double().cpu()
            for k, x in (("factor", lu), ("v", v), ("capture", field))}


class Smoke:
    def __init__(self):
        self.failed = []
        self.kernel_rows = {}
        self.card = None

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:                      # report and fail the run
            traceback.print_exc()
            self.failed.append(name)
            print(f"PHASE FAILED: {name}", flush=True)
            return None
        finally:
            print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)

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
        import megastep_host
        libs = sorted({k["lib"] for k in KERNELS})
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(libs) + 2) as ex:
            futs = {lib: ex.submit(_build.build, lib, ("-Xptxas", "-v"),
                                   True) for lib in libs}
            # K2/K3's and the read's sources as host C++ that counts
            # operations (bounds)
            counter = ex.submit(megastep_host.Counter)
            read_counter = ex.submit(megastep_host.HostTactileRead)
            for lib, fut in futs.items():
                fut.result()
            self.counter = counter.result()
            self.read_counter = read_counter.result()
        print(f"built {len(libs)} librar(ies) for {len(KERNELS)} kernels and "
              f"the operation counters in {time.perf_counter() - t0:.2f} s")
        for lib in libs:
            print(f"  {lib}: nvcc {_build.build_seconds[lib]:.2f} s")
            for line in _build.build_log[lib].splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "spill" in line or "stack frame" in line):
                    print("   ", line.strip()[:160])
            _build.load(lib)

    # 3 -------------------------------------------------------------------
    def kernels(self, dev):
        self.k1_kernels(dev)
        self.megastep_kernels(dev)
        self.k4_kernels(dev)
        self.read_kernels(dev)

    @staticmethod
    def _k1_lanes(op, name, mode, a64, cots64, dev):
        """(float64 CPU inputs, float32 card inputs, float64 CPU cotangents)
        without the lanes on which float32 rounding decides a jump of the
        contact law or of its derivative (K1_ROUNDING_LANES), once K1 and
        K1T are held to the float64 twin there (K1_F32_VS_F64)."""
        def twin(args, cots):
            ins = [x.detach().requires_grad_() for x in args]
            outs = op.reference(*ins)
            live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
            grads = torch.autograd.grad([o for o, _ in live], ins,
                                        [c for _, c in live],
                                        allow_unused=True)
            return [o.detach() for o in outs], grads

        runs = [twin([x.to(dev, dt) for x in a64],
                     [c.to(dev, dt) for c in cots64])
                for dt in (torch.float64, torch.float32)]
        off = torch.zeros(a64[0].shape[-1], dtype=torch.bool, device=dev)
        (o64, g64), (o32, g32) = runs
        per_lane = [0, 1, 2, 3, 4, 5] + ([7] if a64[7].dim() == 3 else [])
        # (float32 twin, float64 twin, tolerance) of every output and
        # per-lane cotangent
        pick = lambda outs, grads: list(outs) + [grads[i] for i in per_lane]
        tols = [K1_TOL] * 3 + [K1T_TOL["rel"]] * len(per_lane)
        checks = [None if w is None or not w.numel() else
                  (g, w, tol, float(w.abs().max()) + 1e-6)
                  for g, w, tol in zip(pick(o32, g32), pick(o64, g64), tols)]
        for g, w, tol, scale in filter(None, checks):
            off |= (g.double() - w).abs().amax(dim=(0, 1)) > tol * scale
        lanes = torch.nonzero(off).flatten()
        if len(lanes) > K1_ROUNDING_LANES * len(off):
            raise AssertionError(f"{name} {mode}: {len(lanes)} lanes where "
                                 "float32 rounding decides the contact law")
        if len(lanes):
            # there K1 and K1T are held to the float64 twin, within the
            # jump it makes itself when its inputs move at float32's
            # rounding (K1_JITTER)
            at = lambda x: (x.to(dev).index_select(-1, lanes)
                            if x.dim() == 3 else x.to(dev))
            a32 = [x.to(dev, torch.float32).contiguous() for x in a64]
            with torch.no_grad():
                k_out = op(*a32)
            k_grad = op.run_adjoint(a32, [c.to(dev, torch.float32)
                                          for c in cots64], (True,) * 11)
            base = [at(x) for x in a64]
            cots = [at(c) for c in cots64]
            ref = pick(*twin(base, cots))
            # the moves as K1_JITTER_RUNS copies of the lanes, in one call
            tile = lambda x: (x.repeat(1, 1, K1_JITTER_RUNS) if x.dim() == 3
                              else x)
            gen = torch.Generator(device=dev).manual_seed(0)
            moved = [tile(x) * (1 + K1_JITTER * (2 * torch.rand(
                tile(x).shape, generator=gen, device=dev, dtype=x.dtype) - 1))
                     if x.dim() == 3 else x for x in base]
            jumps = [0.0] * len(ref)
            for e, j in enumerate(pick(*twin(moved, [tile(c) for c in cots]))):
                if checks[e]:
                    jumps[e] = float((j.unflatten(-1, (K1_JITTER_RUNS, -1))
                                      - ref[e][..., None, :]).abs().max())
            used, worst = 0.0, ""
            for e, k in enumerate(pick(k_out, k_grad)):
                if not checks[e]:
                    continue
                g, _, tol, scale = checks[e]
                dist = lambda t: float(
                    (at(t).double() - ref[e]).abs().max()) / scale
                jump = jumps[e] / scale
                allowed = K1_F32_VS_F64 * jump + tol
                if dist(k) / allowed >= used:
                    used, worst = dist(k) / allowed, (
                        f"kernel {dist(k):.3e}, float32 twin {dist(g):.3e}, "
                        f"float64's jump {jump:.3e} of scale")
                if not dist(k) <= allowed:
                    raise AssertionError(
                        f"{name} {mode}: on the set-aside lanes the kernel "
                        f"is {dist(k):.3e} of scale off float64, whose jump "
                        f"under K1_JITTER is {jump:.3e} (float32 twin "
                        f"{dist(g):.3e}; tol {K1_F32_VS_F64:g} x + {tol:g})")
            print(f"  {name} {mode}: lanes {lanes.tolist()} set aside (the "
                  "float32 plain version or its VJP parts from float64 "
                  "there: K1_ROUNDING_LANES); there K1 and K1T use "
                  f"{used:.3f} of what K1_F32_VS_F64 allows (most: {worst})")
            keep = torch.nonzero(~off.cpu()).flatten()
            a64 = [x.index_select(-1, keep).contiguous() if x.dim() == 3
                   else x for x in a64]
            cots64 = [c.index_select(-1, keep).contiguous() for c in cots64]
        return (a64, [x.to(dev, torch.float32).contiguous() for x in a64],
                cots64)

    def k1_kernels(self, dev):
        """K1 and K1T against their plain versions on the five scenes, two
        launches bit-equal, then their times at B = 1024 and 16 beside
        their bounds, and what the compiler and the card made of them."""
        from tactilesimulation_tpu_torch.ops import lane_contact
        worst = {"K1": 0.0, "K1T": 0.0}
        main = None
        f32 = lambda t: t.to(dev, torch.float32).contiguous()
        for name in K1_SCENES:
            op, args64, per_lane64 = pair_wrench_inputs(name, B_MAIN)
            for mode in ("static", "per-lane"):
                a64 = list(args64)
                if mode == "per-lane":
                    a64[7] = per_lane64
                cots64 = [torch.as_tensor(np.random.RandomState(2).randn(
                    3, n, B_MAIN)) for n in (op.J, op.J, op.ntac)]
                a64, a, cots64 = self._k1_lanes(op, name, mode, a64, cots64,
                                                dev)
                with torch.no_grad():
                    got = op(*a)
                    want = op.reference(*a)
                    again = op(*a)
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
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"K1 {name}: two launches differ")
                rel = max(e / s for _, e, s in errs)
                worst["K1"] = max(worst["K1"], rel)
                cots = [f32(c) for c in cots64]
                gk = op.run_adjoint(a, cots, (True,) * 11)
                gk2 = op.run_adjoint(a, cots, (True,) * 11)
                ins = [x.detach().requires_grad_() for x in a]
                outs = op.reference(*ins)
                live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
                gw = torch.autograd.grad([o for o, _ in live], ins,
                                         [c for _, c in live],
                                         allow_unused=True)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(gk, gk2)):
                    raise AssertionError(f"K1T {name}: two launches differ")
                berrs = []
                for g, w, what in zip(gk, gw, lane_contact._ARG_NAMES):
                    if w is None:
                        if float(g.abs().max()) != 0.0:
                            raise AssertionError(f"K1T {name} {what}: not 0")
                        continue
                    scale = float(w.abs().max())
                    err = float((g - w).abs().max())
                    cos = (float((g * w).sum() / (g.norm() * w.norm()))
                           if scale > 0 else 1.0)
                    berrs.append((what, err, scale, cos))
                    if not (err <= K1T_TOL["rel"] * scale
                            and cos >= K1T_TOL["cos"]):
                        raise AssertionError(
                            f"K1T {name} {mode} {what}: |err| {err:.3e} "
                            f"scale {scale:.3e} cos {cos:.9f} (tol "
                            f"{K1T_TOL})")
                brel = max(e / s for _, e, s, _ in berrs if s > 0)
                worst["K1T"] = max(worst["K1T"], brel)
                segs = sorted({sg.gtype for sg in op.segments})
                print(f"  K1 {name:17s} {mode:8s} B={a[0].shape[-1]} "
                      f"gtypes={segs} "
                      + " ".join(f"{o}:{e:.2e}/{s:.2e}" for o, e, s in errs)
                      + f" max rel {rel:.2e} (tol {K1_TOL:g}) ok")
                print(f"  K1T {name:16s} {mode:8s} max rel {brel:.2e}, min "
                      f"cos {min(c for *_, c in berrs):.9f} (tol "
                      f"{K1T_TOL['rel']:g}, {K1T_TOL['cos']}); bit-equal "
                      "launches ok")
                if name == "tactile_push" and mode == "static":
                    main = (op, a, a64, cots,
                            max(e for _, e, _ in errs),
                            max(e for _, e, _, _ in berrs))
        op, a, a64, cots, k1_err, k1t_err = main
        need = (True,) * 6 + (False,) * 5     # what the mega path asks
        import megastep_host
        host = megastep_host.HostLaneContact(op)
        for Bt in (B_MAIN, 16):
            sub = [x[..., :Bt].contiguous() if x.dim() == 3 else x
                   for x in a]
            csub = [c[..., :Bt].contiguous() for c in cots]
            k_ms = cuda_ms(lambda: op.run_kernel(*sub), 200, warmup=10)
            t_ms = cuda_ms(lambda: op.run_adjoint(sub, csub, need), 200,
                           warmup=10)
            kd_ms = device_ms(lambda: op.run_kernel(*sub), 100)
            td_ms = device_ms(lambda: op.run_adjoint(sub, csub, need), 100)
            with torch.no_grad():
                p_ms = cuda_ms(lambda: op.reference(*sub), 20)

            def twin_vjp():
                ins = [x.detach().requires_grad_(nd)
                       for x, nd in zip(sub, need + (False,) * 5)]
                outs = op.reference(*ins)
                return torch.autograd.grad(outs, ins[:6], csub)

            pt_ms = cuda_ms(twin_vjp, 20)
            t0 = time.perf_counter()
            ops1, ops1t = host.count(
                [x[..., :Bt].contiguous() if x.dim() == 3 else x
                 for x in a64],
                [c[..., :Bt].double().cpu().contiguous() for c in cots],
                need)
            count_s = time.perf_counter() - t0
            nbytes = lambda ts: 4 * sum(t.numel() for t in ts)
            plan_b = 4 * op.plan.size
            b1 = (nbytes(sub) + plan_b
                  + 4 * (2 * 3 * op.J + 3 * op.ntac) * Bt)
            b1t = (nbytes(sub) + plan_b + nbytes(csub)
                   + nbytes(sub[:6]))
            for key, ms, dms, plain, nb, nops, err in (
                    ("K1", k_ms, kd_ms, p_ms, b1, ops1, k1_err),
                    ("K1T", t_ms, td_ms, pt_ms, b1t, ops1t, k1t_err)):
                bound, by, t_b, t_o = self._bound(nb, nops)
                print(f"  {key} TactilePush f32 B={Bt}: kernel {ms:.4f} ms "
                      f"(device alone {dms:.4f} ms), "
                      f"plain {plain:.4f} ms; moves {nb} B ({t_b:.5f} ms), "
                      f"{nops} op ({t_o:.5f} ms); bound {bound:.5f} ms by "
                      f"{by}; {100 * bound / ms:.2f} % of it [{self.card}]")
                if Bt == B_MAIN:
                    self.kernel_rows.setdefault(key, {}).update(
                        max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bound, bound_by=by, library_ms=None)
            print(f"  (operations counted on the host in {count_s:.1f} s)")
        print(f"  worst rel err over the scenes: K1 {worst['K1']:.2e}, K1T "
              f"{worst['K1T']:.2e}")
        for key, d in lane_contact.kernel_info(op, a[7].shape[0],
                                               B_MAIN).items():
            print(f"  {key}: {d['registers']} registers, local "
                  f"{d['local_bytes']} B per thread, shared "
                  f"{d['dynamic_shared_bytes']} B per block of "
                  f"{32 * lane_contact.WARPS} threads, "
                  f"{int(op.header[2])} blocks per cluster (one 32-lane "
                  f"tile), {d['clusters']} clusters resident on the card; "
                  f"{int(op.header[1])} pieces in {int(op.header[3])} "
                  f"round(s)")

    @staticmethod
    def _bound(bytes_moved, ops):
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS_PER_S * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops)

    def megastep_kernels(self, dev):
        """K2 and K3 against their plain version (f64, f32), and their times
        at B = 1024 beside their bounds."""
        from tactilesimulation_tpu_torch.model import task_scenes
        from tactilesimulation_tpu_torch.ops import megastep
        struct, model = task_scenes.tactile_push()
        n, nu, K = struct.ndof_q, struct.ndof_u, 5
        ops = {dt: megastep.MegaStep(struct, model.to(dev, dt), K, 8)
               for dt in (torch.float64, torch.float32)}

        def case(B, seed, state=contact_state):
            if state is contact_state:
                q, v = contact_state("tactile_push", model.q_init.numpy(), B,
                                     seed=seed)
            else:
                q, v = state(model.q_init.numpy(), B, seed)
            rng = np.random.RandomState(seed + 1)
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                          dtype=torch.float64, device=dev)
            return [t(q), t(v), t(0.5 * rng.randn(nu, B))] + [
                t(x) for x in rng.randn(4, n, B)]

        def errs(got, want):
            out = []
            for a, b in zip(got, want):
                a, b = a.double(), b.double()
                scale = float(b.abs().max())
                err = float((a - b).abs().max())
                cos = float((a * b).sum() / (a.norm() * b.norm()))
                if not (math.isfinite(err) and math.isfinite(cos)):
                    raise AssertionError("non-finite kernel output")
                out.append((err, err / scale, cos))
            return out

        def show(name, res, tol=None, cos_min=None):
            print(f"  {name}: " + " ".join(
                f"|err| {e:.2e} rel {r:.2e} cos {c:.9f};" for e, r, c in res)
                + (f" (tol rel {tol:g}" if tol is not None else "")
                + (f", cos {cos_min}" if cos_min else "")
                + (")" if tol is not None else ""))

        def check(name, got, want, tol, cos_min=None):
            res = errs(got, want)
            show(name, res, tol, cos_min)
            if any(r > tol or (cos_min is not None and c < cos_min)
                   for _, r, c in res):
                raise AssertionError(f"{name} disagrees with its plain "
                                     "version")

        def three_way(name, kernel, plain32, plain64):
            """The f32 kernel and the f32 plain version, each against the
            f64 plain version: the kernel's error must stay within
            K23_F32_VS_F64 of the plain version's (see there)."""
            k, p = errs(kernel, plain64), errs(plain32, plain64)
            show(f"{name} f32 kernel vs f64 plain", k)
            show(f"{name} f32 plain  vs f64 plain", p)
            mult, floor = K23_F32_VS_F64
            for (_, rk, _), (_, rp, _) in zip(k, p):
                if rk > mult * rp + floor:
                    raise AssertionError(
                        f"{name}: f32 kernel {rk:.3e} of scale from f64, "
                        f"plain f32 {rp:.3e} (tol {mult:g} x + {floor:g})")
            return max(e for e, _, _ in errs(kernel, plain32))

        f32 = lambda xs: [x.float().contiguous() for x in xs]
        # float64 at B = 64: the algorithm, to round-off
        op = ops[torch.float64]
        q, v, u, *g = case(64, 0)
        want = op.fwd_ref(q, v, u)
        check("K2 f64 B=64 (q, qdot, vs)", op.run_fwd(q, v, u), want,
              K23_F64_TOL["fwd"])
        check("K3 f64 B=64 (g_q0, g_qdot0, g_u)",
              op.run_bwd(q, v, u, want[2], *g),
              op.bwd_ref(q, v, u, want[2], *g), K23_F64_TOL["bwd"])

        # float32 at the main path's width on the same kind of states, held
        # against float64: K2 at B = 1024, K3 at B = 128
        op = ops[torch.float32]
        x64 = case(B_MAIN, 0)
        q, v, u, *g = f32(x64)
        got = op.run_fwd(q, v, u)
        nres = op.last_residuals.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = op.fwd_ref(q, v, u)
        torch.cuda.synchronize()
        k2_plain = (time.perf_counter() - t0) * 1e3
        ref = ops[torch.float64].fwd_ref(*x64[:3])
        k2_err = three_way(f"K2 B={B_MAIN} (q, qdot, vs)", got, plain, ref)
        k2_ms = cuda_ms(lambda: op.run_fwd(q, v, u), 20, warmup=2)
        k2_dev = device_ms(lambda: op.run_fwd(q, v, u), 20, warmup=2)
        Bb = 128
        y64 = [a[..., :Bb].contiguous() for a in x64[:3] + [ref[2]] + x64[3:]]
        y32 = f32(y64)
        k3_err = three_way(f"K3 B={Bb} (g_q0, g_qdot0, g_u)",
                           op.run_bwd(*y32), op.bwd_ref(*y32),
                           ops[torch.float64].bwd_ref(*y64))
        vs32 = ref[2].float().contiguous()
        k3_ms = cuda_ms(lambda: op.run_bwd(q, v, u, vs32, *g), 20, warmup=2)
        k3_dev = device_ms(lambda: op.run_bwd(q, v, u, vs32, *g), 20,
                           warmup=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op.bwd_ref(q, v, u, vs32, *g)
        torch.cuda.synchronize()
        k3_plain = (time.perf_counter() - t0) * 1e3
        self.megastep_shapes(megastep, op, [q, v, u, vs32] + g)
        # and on resting contact, where the f32 chord converges: directly
        # against the f32 plain version
        q, v, u, *g = f32(case(B_MAIN, 0, resting_contact))
        got = op.run_fwd(q, v, u)
        want = op.fwd_ref(q, v, u)
        check(f"K2 f32 B={B_MAIN} resting (q, qdot, vs)", got, want,
              K23_F32_TOL["fwd"], K23_F32_TOL["fwd_cos"])
        sub = [a[..., :Bb].contiguous() for a in (q, v, u, want[2], *g)]
        check(f"K3 f32 B={Bb} resting (g_q0, g_qdot0, g_u)",
              op.run_bwd(*sub), op.bwd_ref(*sub), K23_F32_TOL["bwd"],
              K23_F32_TOL["bwd_cos"])

        # bounds from the timed run's inputs: bytes in and out once, the
        # operations its data needs (megastep_host.py), K2's residual
        # evaluations as the kernel counted them per lane
        import megastep_host
        t0 = time.perf_counter()
        need = megastep_host.needed(self.counter.units(
            op.tables, *(a.cpu().numpy() for a in x64[:3])), n)
        k2_ops, k3_ops = megastep_host.k2_k3_ops(need, n, K,
                                                 nres.cpu().numpy())
        print(f"  operations per lane counted at this run's inputs in "
              f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
                  f"{k} {float(np.mean(c)):.0f}" for k, c in need.items()))
        tables = sum(4 * t.numel() for t in op.tables.packed(dev,
                                                             torch.float32))
        k2_bytes = tables + 4 * B_MAIN * (2 * n + nu + 2 * n + K * n + 1)
        k3_bytes = tables + 4 * B_MAIN * (2 * n + nu + K * n + 4 * n
                                          + 2 * n + nu)
        for key, ms, dev_ms, plain_ms, err, bts, nops in (
                ("K2", k2_ms, k2_dev, k2_plain, k2_err, k2_bytes, k2_ops),
                ("K3", k3_ms, k3_dev, k3_plain, k3_err, k3_bytes, k3_ops)):
            bound, by, t_b, t_o = self._bound(bts, nops)
            print(f"  {key} TactilePush f32 B={B_MAIN}: kernel {ms:.3f} ms "
                  f"(device {dev_ms:.3f} ms), plain {plain_ms:.1f} ms; moves {bts} B ({t_b:.5f} ms), "
                  f"{nops:.4e} op ({t_o:.4f} ms); bound {bound:.4f} ms by "
                  f"{by}; {100 * bound / ms:.2f} % of it [{self.card}]")
            self.kernel_rows.setdefault(key, {}).update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)
        print(f"  K2 residual evaluations per lane: mean "
              f"{float(nres.float().mean()):.2f} of {K * 9} (chord stops "
              f"early on converged lanes)")

    def megastep_shapes(self, megastep, op, args):
        """K2/K3 at the GD width (B = 16, the first lanes of the timed
        states); then each instance's registers, local (stack) bytes, shared
        bytes and resident blocks per SM."""
        sub = [a[..., :16].contiguous() for a in args]
        t = [cuda_ms(fn, 20, warmup=2) for fn in (
            lambda: op.run_fwd(*sub[:3]), lambda: op.run_bwd(*sub))]
        print(f"  B=16: K2 {t[0]:.3f} ms, K3 {t[1]:.3f} ms [{self.card}]")
        for name, d in megastep.kernel_info().items():
            print(f"  {name}: {d['registers']} registers, local (stack) "
                  f"{d['local_bytes']} B per thread, shared "
                  f"{d['dynamic_shared_bytes']} B per block of "
                  f"{d['lanes_per_block']} lanes, {d['blocks_per_sm']} "
                  f"blocks ({d['blocks_per_sm'] * d['lanes_per_block']} "
                  f"lanes) per SM; device stack limit "
                  f"{d['stack_limit_bytes']} B per thread")

    @staticmethod
    def k4_inputs(gtype, N, dtype, dev, seed=0):
        """Points scattered over a primitive (or the ground plane) with
        random velocities: some inside it, some outside."""
        from tactilesimulation_tpu_torch.ops import dense_contact
        rng = np.random.default_rng(seed + 10 * (gtype + 1))
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        args = (t(rng.normal(scale=0.05, size=(N, 3))),
                t(rng.normal(scale=0.2, size=(N, 3))),
                (t(rng.normal(scale=0.01, size=3)), t(R)),
                (t(rng.normal(size=3) * 0.1), t(rng.normal(size=3) * 0.5)),
                t([0.06, 0.04, 0.05]), t([1e4, 5e2, 1.2, 1e3]),
                (t(np.zeros(3)), t([0.0, 0.0, 1.0])))
        return dense_contact, args

    def k4_kernels(self, dev):
        """K4 against its plain version (4 primitive types, f32 and f64,
        N = 40,000 and 40,001), then kernel and plain times at the main
        path's shape with the bound."""
        names = {-1: "ground", 0: "cuboid", 1: "cylinder", 2: "sphere"}
        worst = {}
        for N in (K4_N, K4_N + 1):
            for dtype in (torch.float32, torch.float64):
                for g in (-1, 0, 1, 2):
                    dc, args = self.k4_inputs(g, N, dtype, dev)
                    got = dc.dense_point_contact(g, *args)
                    want = dc.dense_point_contact_ref(g, *args)
                    torch.cuda.synchronize()
                    scale = float(want.abs().max())
                    err = float((got - want).abs().max())
                    active = int((want.abs().sum(dim=1) > 0).sum())
                    tol = K4_TOL[dtype]
                    if not (math.isfinite(err) and err <= tol * scale
                            and 0 < active < N):
                        raise AssertionError(
                            f"K4 {names[g]} {dtype} N={N}: |err| {err:.3e} "
                            f"> {tol:g} x {scale:.3e} or {active} in "
                            "contact")
                    worst[dtype] = max(worst.get(dtype, 0.0), err / scale)
                    print(f"  K4 {names[g]:8s} {str(dtype)[6:]:7s} N={N}: "
                          f"|err| {err:.3e} of scale {scale:.3e} (rel "
                          f"{err / scale:.2e}, tol {tol:g}); {active} "
                          "points in contact")
        # the main path's shape: 40,000 markers against a sphere, float32
        dc, args = self.k4_inputs(2, K4_N, torch.float32, dev)
        scal = dc.pack_scalars(*args[2:])
        x, xd = args[0], args[1]
        max_abs = float((dc.dense_point_contact(2, *args)
                         - dc.dense_point_contact_ref(2, *args)).abs().max())
        k_ms = cuda_ms(lambda: dc._run_kernel(2, x, xd, scal), 500,
                       warmup=20)
        d_ms = device_ms(lambda: dc._run_kernel(2, x, xd, scal), 500,
                         warmup=20)
        p_ms = cuda_ms(lambda: dc.dense_point_contact_ref(2, *args), 50)
        bytes_moved = 4 * (3 * K4_N * 3 + scal.numel())
        bound, by, t_b, t_o = self._bound(bytes_moved,
                                          K4_N * K4_FLOPS_PER_POINT[2])
        print(f"  K4 sphere f32 N={K4_N}: kernel {k_ms:.4f} ms (device "
              f"alone {d_ms:.4f} ms), plain "
              f"{p_ms:.4f} ms; moves {bytes_moved} B ({t_b:.5f} ms), "
              f"{K4_N * K4_FLOPS_PER_POINT[2]} flop ({t_o:.5f} ms); bound "
              f"{bound:.5f} ms by {by}; worst rel err f32 "
              f"{worst[torch.float32]:.2e}, f64 {worst[torch.float64]:.2e} "
              f"[{self.card}]")
        self.kernel_rows.setdefault("K4", {}).update(
            max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
            bound_by=by, library_ms=None)

    def read_check(self, name, dev):
        """The tactile read kernel against its plain version at
        read_state's state of ``name``, in float64 and float32 (READ_TOL,
        READ_ROUNDING_ROWS): one launch a read, two launches bit-equal.
        Returns the float32 kernel's max abs error from the float32 plain
        version on the rows kept."""
        from tactilesimulation_tpu_torch.ops import dense_contact
        from tactilesimulation_tpu_torch.ops import tactile_query
        struct, m64, q64, v64 = read_case(name, torch.float64, dev)
        plain = tactile_query.tactile_field_ref
        ref64 = plain(struct, m64, q64, v64)
        N = ref64.shape[0]
        scale = float(ref64.abs().max())
        active = int((ref64.abs().sum(dim=1) > 0).sum())
        if not (scale > 0 and active > 0
                and float(ref64[:, :2].abs().max()) > 0):
            raise AssertionError(f"read {name}: no contact or no shear")
        row = lambda a, b: (a.double() - b.double()).abs().amax(dim=1)
        errs, set_aside = {}, []
        for dtype in (torch.float64, torch.float32):
            m = m64 if dtype == torch.float64 else m64.to(dev, dtype)
            q, v = q64.to(dtype), v64.to(dtype)
            dense_contact.reset_counts()
            got = tactile_query.tactile_field(struct, m, q, v)
            again = tactile_query.tactile_field(struct, m, q, v)
            torch.cuda.synchronize()
            counts = (dense_contact.read_launches, dense_contact.launches)
            if counts != (2, 0):
                raise AssertionError(
                    f"read {name} {dtype}: {dense_contact.read_launches} "
                    f"read and {dense_contact.launches} points launches "
                    "for 2 reads")
            if got.dtype != dtype or tuple(got.shape) != (N, 3):
                raise AssertionError(f"read {name}: {got.dtype} "
                                     f"{tuple(got.shape)}")
            if not torch.equal(got, again):
                raise AssertionError(f"read {name} {dtype}: two launches "
                                     "differ")
            tol = READ_TOL[dtype] * scale
            if dtype == torch.float64:
                errs[dtype] = float(row(got, ref64).max())
                if not errs[dtype] <= tol:
                    raise AssertionError(
                        f"read {name} f64: |err| {errs[dtype]:.3e} > "
                        f"{READ_TOL[dtype]:g} x {scale:.3e}")
                continue
            ref32 = plain(struct, m, q, v)
            off = (row(ref32, ref64) > tol) | (row(got, ref64) > tol)
            rows = torch.nonzero(off).flatten()
            if len(rows) > READ_ROUNDING_ROWS * N:
                raise AssertionError(
                    f"read {name} f32: {len(rows)} of {N} rows where float32 "
                    "parts from float64")
            errs[dtype] = float(row(got, ref32)[~off].max()) \
                if bool((~off).any()) else 0.0
            if not errs[dtype] <= tol:
                raise AssertionError(
                    f"read {name} f32: |err| {errs[dtype]:.3e} > "
                    f"{READ_TOL[dtype]:g} x {scale:.3e}")
            if len(rows):
                # there the kernel is held to the float64 plain version,
                # within the jump that one makes itself when q and v move
                # at float32's rounding
                gen = torch.Generator(device=dev).manual_seed(0)
                moved = lambda a: a * (1 + K1_JITTER * (2 * torch.rand(
                    a.shape, generator=gen, device=dev,
                    dtype=torch.float64) - 1))
                jump = torch.zeros(N, dtype=torch.float64, device=dev)
                for _ in range(K1_JITTER_RUNS):
                    jump = torch.maximum(jump, row(plain(
                        struct, m64, moved(q64), moved(v64)), ref64))
                dist = row(got, ref64)[rows]
                allowed = K1_F32_VS_F64 * jump[rows] + tol
                if not bool((dist <= allowed).all()):
                    raise AssertionError(
                        f"read {name} f32: on the set-aside rows "
                        f"{rows.tolist()} the kernel is "
                        f"{(dist / scale).tolist()} of scale off float64, "
                        f"allowed {(allowed / scale).tolist()}")
                set_aside = rows.tolist()
        print(f"  read {name:17s} N={N:5d}: {active} rows in contact; f64 "
              f"{errs[torch.float64] / scale:.2e} of scale {scale:.3e}, f32 "
              f"{errs[torch.float32] / scale:.2e} (tols "
              f"{READ_TOL[torch.float64]:g}, {READ_TOL[torch.float32]:g}); "
              f"f32 rows set aside {set_aside}; one launch a read, "
              "bit-equal")
        return errs[torch.float32]

    def read_kernels(self, dev):
        """The tactile read against its plain version on RollingBall 200 x
        200 and READ_SCENES, f32 and f64; its times at the main path's shape
        (RollingBall 200 x 200, f32) beside its bound, and the eager aten
        ops per read."""
        from tactilesimulation_tpu_torch.ops import dense_contact
        from tactilesimulation_tpu_torch.ops import tactile_query
        from tactilesimulation_tpu_torch.sim import simulation
        max_abs = self.read_check("rolling_ball_200", dev)
        for name in READ_SCENES:
            self.read_check(name, dev)
        struct, m64, q64, v64 = read_case("rolling_ball_200", torch.float64,
                                          dev)
        model = m64.to(dev, torch.float32)
        q, v = q64.float(), v64.float()
        plan = tactile_query.read_plan(struct, model)
        read = lambda: dense_contact.tactile_read(plan, q, v)
        k_ms = cuda_ms(read, 500, warmup=20)
        d_ms = device_ms(read, 500, warmup=20)
        query_ms = cuda_ms(lambda: tactile_query.tactile_field(
            struct, model, q, v), 500, warmup=20)
        p_ms = cuda_ms(lambda: tactile_query.tactile_field_ref(
            struct, model, q, v), 20)
        sim = simulation.Simulator(struct, model)
        state = sim.init_state(q=q64.cpu().numpy(), qdot=v64.cpu().numpy())
        sim.tactile(model, state)
        with AtenCount() as c_query:
            tactile_query.tactile_field(struct, model, q, v)
        with AtenCount() as c_sim:
            sim.tactile(model, state)
        with AtenCount() as c_plain:
            tactile_query.tactile_field_ref(struct, model, q, v)
        torch.cuda.synchronize()
        nbytes = (4 * plan.ints.numel() + 4 * plan.floats.numel()
                  + 4 * 2 * plan.n + 4 * 3 * plan.N)
        ops = self.read_counter.count(struct, m64, q64.cpu().numpy(),
                                      v64.cpu().numpy())
        bound, by, t_b, t_o = self._bound(nbytes, ops)
        print(f"  read RollingBall 200x200 f32: {k_ms:.4f} ms back to back, "
              f"{d_ms:.4f} ms on the device; through tactile_field "
              f"{query_ms:.4f} ms; plain {p_ms:.4f} ms; moves "
              f"{nbytes} B ({t_b:.5f} ms), {ops} op ({t_o:.5f} ms); bound "
              f"{bound:.5f} ms by {by}; eager aten ops per read: "
              f"tactile_field {c_query.n}, Simulator.tactile {c_sim.n}, the "
              f"plain version {c_plain.n} [{self.card}]")
        # the longest FK prologues: StableGrasp's (21 joints, 6 depths, 22
        # pairs) and the block chain's (41 joints, 11 depths, 40 pairs)
        for name in ("stable_grasp", "block_chain"):
            st, m_st, q_st, v_st = read_case(name, torch.float32, dev)
            st_plan = tactile_query.read_plan(st, m_st)
            st_ms = device_ms(lambda: dense_contact.tactile_read(
                st_plan, q_st, v_st), 500, warmup=20)
            print(f"  read {name} f32 ({st.njoints} joints, "
                  f"{int(st_plan.ints[st.njoints:2 * st.njoints].max()) + 1}"
                  f" depths, {len(st.tactile_pairs)} pairs, {st_plan.N} "
                  f"rows): {st_ms:.4f} ms on the device [{self.card}]")
        self.kernel_rows["K4R"] = dict(
            max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
            bound_by=by, library_ms=None)

    # 4 -------------------------------------------------------------------
    def slice(self, dev):
        from tactilesimulation_tpu_torch.envs import tactile_push_lanes
        from tactilesimulation_tpu_torch.models.nets import DiagGaussianActor
        from tactilesimulation_tpu_torch.sim import lanes
        env = tactile_push_lanes.make("tactile_flatten", device=dev, seed=0)
        env.rebuild_solver(mega=False)          # slice 1: the lanes stepper
        torch.manual_seed(0)
        actor = DiagGaussianActor(env.obs_size()[0], env.ndof_u,
                                  ACTOR_CFG).to(dev)
        pw = env.pair_wrenches
        per_step = 1 + env.frame_skip * (1 + env.max_iter) + 1
        # warm-up env step (device tables, library handles)
        with torch.no_grad():
            env.batched_rollout_fn(actor.act, 1)(B_MAIN)
        torch.cuda.synchronize()

        run = env.batched_rollout_fn(actor.act, H_MAIN)
        pw.reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            rewards, dones, infos = run(B_MAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, bwd, vjps, recomputes = (pw.launches, pw.bwd_launches,
                                           pw.twin_vjps, pw.twin_recomputes)
        want = 1 + per_step * H_MAIN
        want_bwd = env.struct.ndof_q * H_MAIN    # the chord factors' rows
        print(f"  K1 launches {launches} (want 1 reset + {per_step} x "
              f"{H_MAIN} = {want}); K1T launches {bwd} (want "
              f"{env.struct.ndof_q} per chord factor x {H_MAIN} = "
              f"{want_bwd}); twin VJPs {vjps}, twin recomputes {recomputes}")
        if launches != want:
            raise AssertionError(f"K1 launched {launches} times, want {want}")
        if (bwd, vjps, recomputes) != (want_bwd, 0, 0):
            raise AssertionError("the chord factor's pullbacks did not all "
                                 "run through K1T")
        if tuple(rewards.shape) != (B_MAIN, H_MAIN):
            raise AssertionError(f"rewards {tuple(rewards.shape)}")
        for k, x in [("reward", rewards)] + list(infos.items()):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{k} not finite")
        self.kernel_rows.setdefault("K1", {})["launches"] = launches
        self.kernel_rows.setdefault("K1T", {})["launches"] = bwd
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
        k_ms = self.kernel_rows.get("K1", {}).get("ms", float("nan"))
        kt_ms = self.kernel_rows.get("K1T", {}).get("ms", float("nan"))
        nq = env.struct.ndof_q
        print(f"  env step {step_ms:.1f} ms: chord factor ({nq} pullbacks) "
              f"{j_ms:.1f} ms, residual {r_ms:.2f} ms x "
              f"{per_step - 1}, K1 {k_ms * per_step:.3f} ms and K1T "
              f"{kt_ms * nq:.3f} ms in all "
              f"({100 * (k_ms * per_step + kt_ms * nq) / step_ms:.3f} %)")
        self.device_share(lambda: residual(sim.qdot, inputs), "residual")

    @staticmethod
    def device_share(fn, what, grad=False):
        """Device busy share of one call of ``fn``, from torch.profiler."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        try:
            with torch.set_grad_enabled(grad), profile(activities=[
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
    def train(self, dev):
        """Slice 2: BPTT through the mega path, then the GD trainer."""
        import yaml
        from tactilesimulation_tpu_torch.algorithms.gd import GD
        from tactilesimulation_tpu_torch.envs import tactile_push_lanes
        from tactilesimulation_tpu_torch.models.nets import DiagGaussianActor
        env = tactile_push_lanes.make("tactile_flatten", device=dev, seed=0)
        if not env.solver_mega:
            raise AssertionError("the card's env did not pick the megastep")
        torch.manual_seed(0)
        actor = DiagGaussianActor(env.obs_size()[0], env.ndof_u,
                                  ACTOR_CFG).to(dev)
        params = list(actor.parameters())
        pw, mega = env.pair_wrenches, env.megastep

        def rollout_grad(B, H):
            t0 = time.perf_counter()
            rewards = env.batched_rollout_fn(actor.act, H)(B)[0]
            loss = -torch.mean(torch.sum(rewards, dim=1))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            torch.cuda.synchronize()
            return loss, grads, t1 - t0, time.perf_counter() - t1

        rollout_grad(B_MAIN, 1)                   # warm-up
        mega.reset_counts()
        pw.reset_counts()
        loss, grads, t_fwd, t_bwd = rollout_grad(B_MAIN, H_TRAIN)
        counts = dict(K2=mega.fwd_launches, K3=mega.bwd_launches,
                      K1=pw.launches, K1T=pw.bwd_launches,
                      twin=pw.twin_recomputes + pw.twin_vjps)
        # K1 runs for every observation (reset + H); K1T for each one an
        # action was taken on after the reset (the reset's carries no graph
        # and the last one feeds no action): H - 1; the twin never
        want = dict(K2=H_TRAIN, K3=H_TRAIN, K1=1 + H_TRAIN, K1T=H_TRAIN - 1,
                    twin=0)
        print(f"  launches {counts} (want {want})")
        if counts != want:
            raise AssertionError("the differentiable rollout did not run "
                                 "through K2/K3/K1/K1T as expected")
        live = [g for g in grads if g is not None]
        if not live or not all(bool(torch.isfinite(g).all()) for g in live):
            raise AssertionError("non-finite or missing gradients")
        gnorm = float(torch.sqrt(sum(torch.sum(g * g) for g in live)))
        if not gnorm > 0:
            raise AssertionError("zero gradient")
        for key in ("K2", "K3"):
            self.kernel_rows.setdefault(key, {})["launches"] = counts[key]
        wall = t_fwd + t_bwd
        steps_s = H_TRAIN / wall
        print(f"  differentiable rollout B={B_MAIN} H={H_TRAIN}: loss "
              f"{float(loss.detach()):.4f}, |grad| {gnorm:.4e}; forward "
              f"{t_fwd:.3f} s, "
              f"backward {t_bwd:.3f} s: {steps_s:.3f} env steps/s, "
              f"{steps_s * B_MAIN:.1f} lane steps/s, "
              f"{B_MAIN * steps_s / 150:.3f} differentiable rollouts/s at "
              f"H=150 [{self.card}]")
        k2, k3, k1, k1t = (self.kernel_rows.get(key, {}).get(
            "ms", float("nan")) for key in ("K2", "K3", "K1", "K1T"))
        step_ms = wall / H_TRAIN * 1e3
        print(f"  per env step {step_ms:.1f} ms: K2 {k2:.2f} ms "
              f"({100 * k2 / step_ms:.1f} %), K3 {k3:.2f} ms "
              f"({100 * k3 / step_ms:.1f} %), K1 {k1:.3f} ms and K1T "
              f"{k1t:.3f} ms ({100 * (k1 + k1t) / step_ms:.2f} %), rest "
              f"{step_ms - k2 - k3 - k1 - k1t:.1f} ms")
        self.device_share(lambda: rollout_grad(B_MAIN, 1), "one env step "
                          "forward + backward", grad=True)
        self.host_work(env, actor, params)

        # (b) the GD trainer, gd_tactile.yaml protocol, 2 epochs
        with open(GD_CFG) as fp:
            cfg = yaml.safe_load(fp)["params"]
        genv = tactile_push_lanes.make(cfg["env"]["observation_type"],
                                       device=dev, seed=0)
        trainer = GD(genv, cfg, seed=0)
        before = [p.detach().clone() for p in trainer.actor.parameters()]
        genv.megastep.reset_counts()
        genv.pair_wrenches.reset_counts()
        t0 = time.perf_counter()
        mean_r = trainer.train(stop_epoch=2)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / 2
        moved = max(float((p.detach() - b).abs().max()) for p, b in
                    zip(trainer.actor.parameters(), before))
        E, H = trainer.num_episodes, trainer.horizon
        print(f"  GD E={E} H={H}: {sec:.2f} s per epoch, "
              f"{E * H / sec:.1f} lane steps/s, mean reward {mean_r:.4f}, "
              f"max parameter move {moved:.3e}; launches K2 "
              f"{genv.megastep.fwd_launches}, K3 {genv.megastep.bwd_launches}"
              f", K1 {genv.pair_wrenches.launches}, K1T "
              f"{genv.pair_wrenches.bwd_launches} [{self.card}]")
        if not (math.isfinite(mean_r) and moved > 0):
            raise AssertionError("GD: non-finite loss or the parameters did "
                                 "not move")
        if genv.megastep.fwd_launches != 2 * H:
            raise AssertionError("GD did not step through K2")
        # where a GD epoch's time goes: the same rollout, halves timed
        op = genv.megastep
        t0 = time.perf_counter()
        loss, _, _, _ = trainer.epoch_loss()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, list(trainer.actor.parameters()),
                            allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        q = genv.model.q_init[:, None].repeat(1, E).contiguous()
        qd = torch.zeros_like(q)
        u = torch.zeros((genv.struct.ndof_u, E), device=dev)
        qo, qdo, vs = op.run_fwd(q, qd, u)
        g = [torch.ones_like(q)] * 4
        k2e = cuda_ms(lambda: op.run_fwd(q, qd, u), 5, warmup=1)
        k3e = cuda_ms(lambda: op.run_bwd(q, qd, u, vs, *g), 5, warmup=1)
        print(f"  GD epoch halves: rollout {t1 - t0:.2f} s, backward "
              f"{t2 - t1:.2f} s; at B={E}: K2 {k2e:.2f} ms x {H} = "
              f"{k2e * H / 1e3:.2f} s, K3 {k3e:.2f} ms x {H} = "
              f"{k3e * H / 1e3:.2f} s (resting state)")

    @staticmethod
    def host_work(env, actor, params, H=2):
        """Eager aten ops per env step of a differentiable rollout at
        B_MAIN (forward, backward; TorchDispatchMode, every op the host
        dispatches), and the profiler's top host costs of one env step's
        backward."""
        from torch.profiler import ProfilerActivity, profile

        run = env.batched_rollout_fn(actor.act, H)
        with AtenCount() as fwd:
            loss = -torch.mean(torch.sum(run(B_MAIN)[0], dim=1))
        with AtenCount() as bwd:
            torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        print(f"  eager aten ops per env step (B={B_MAIN}, H={H}): forward "
              f"{fwd.n / H:.0f}, backward {bwd.n / H:.0f}, together "
              f"{(fwd.n + bwd.n) / H:.0f}")
        loss = -torch.mean(torch.sum(
            env.batched_rollout_fn(actor.act, 1)(B_MAIN)[0], dim=1))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.autograd.grad(loss, params, allow_unused=True)
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        if not rows:
            raise AssertionError("the profiler recorded no host op")
        total = sum(e.self_cpu_time_total for e in rows) / 1e3
        print(f"  one env step's backward, host self time {total:.1f} ms; "
              "top host costs:")
        for e in rows[:10]:
            print(f"    {e.key[:60]:60s} x{e.count:5d} "
                  f"{e.self_cpu_time_total / 1e3:8.2f} ms")

    # 6 -------------------------------------------------------------------
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
            state, obs = env.reset(B)
            for _ in range(H):
                state, obs, r, _, _ = env.step(state, pol.act(obs))
                rewards.append(r)
            rewards = torch.stack(rewards)
            loss = -torch.mean(torch.sum(rewards, dim=0))
            grads = torch.autograd.grad(loss, list(pol.parameters()),
                                        allow_unused=True)
            flat = torch.cat([g.reshape(-1) for g in grads if g is not None])
            runs.append([x.detach().double().cpu() for x in
                         (state.sim.q, state.sim.qdot, rewards, obs, flat)])
            mega = env.megastep
            if where.type == "cuda" and (
                    pw.twin_vjps or pw.twin_recomputes
                    or not pw.bwd_launches):
                raise AssertionError("the card's BPTT did not run through "
                                     "K1T alone")
            print(f"  {where.type} {dtype}: mega {env.solver_mega}, K1 "
                  f"launches {pw.launches}, K1T {pw.bwd_launches}, twin VJPs "
                  f"{pw.twin_vjps}"
                  + (f", K2 {mega.fwd_launches}, K3 {mega.bwd_launches}"
                     if mega else ""))
        if not float(runs[1][4].norm()) > 0:
            raise AssertionError("zero BPTT gradient")
        # Tolerance: f32 round-off through the chord solve, whose float32
        # stopping rule is 1e-4 x the first residual, gives about 1e-6
        # relative on q (3e-7 measured on the CPU, f32 against f64, with
        # these draws); the card's megastep stops the chord at 1e-7, the
        # CPU's lanes stepper at 1e-8 (f64). At a contact switch under one
        # chord factor per env step, f32 and f64 part by ~1% even with 30
        # sweeps, so this window keeps the pad away from the box; the
        # pad-box branches are held to the plain version in phase 3. The
        # gradient goes through 2 x 5 adjoint solves in f32: it is held by
        # cosine and by its relative error (norm of the difference over
        # the norm of the f64 gradient).
        tols = {"q": 1e-5, "qdot": 1e-4, "reward": 1e-5, "obs": 1e-5}
        for (name, tol), g, w in zip(tols.items(), *runs):
            scale = float(w.abs().max())
            err = float((g - w).abs().max())
            print(f"  {name:6s} |card - cpu| {err:.3e} scale {scale:.3e} "
                  f"rel {err / scale:.3e} (tol {tol:g})")
            if not err <= tol * scale:
                raise AssertionError(f"cross-check {name}: {err / scale:.3e}")
        g, w = runs[0][4], runs[1][4]
        rel = float((g - w).norm() / w.norm())
        cos = float(g @ w / (g.norm() * w.norm()))
        print(f"  BPTT grad ({w.numel()} parameters) card f32 mega vs cpu "
              f"f64 lanes: |grad| {float(w.norm()):.4e}, rel err {rel:.3e} "
              f"(tol {CROSS_GRAD_TOL['rel']:g}), cos {cos:.9f} (tol "
              f"{CROSS_GRAD_TOL['cos']})")
        if not (rel <= CROSS_GRAD_TOL["rel"]
                and cos >= CROSS_GRAD_TOL["cos"]):
            raise AssertionError("cross-check: BPTT gradient")

    # 7 -------------------------------------------------------------------
    @staticmethod
    def pressed_ball(q_init, seed=0):
        """RollingBall q, qdot (float64 numpy) with the pad's underside
        0.3 mm into the ball's top, the ball slightly off centre and
        moving."""
        rng = np.random.RandomState(seed)
        q = np.array(q_init, dtype=np.float64)
        q[2] = -0.0153
        q[3:5] = 2e-3 * rng.randn(2)
        return q, 0.005 * rng.randn(q.shape[0])

    def rolling(self, dev):
        """Slice 3: the RollingBall sim-speed path, the facade, and the
        card against the CPU."""
        from tactilesimulation_tpu_torch.examples import rolling_ball_speed
        from tactilesimulation_tpu_torch.model import task_scenes
        from tactilesimulation_tpu_torch.ops import dense_contact, tactile_query
        from tactilesimulation_tpu_torch.sim import integrators, simulation
        struct, model64 = task_scenes.rolling_ball(resolution=ROLL_RES)
        model = model64.to(dev, torch.float32)
        sim = simulation.Simulator(struct, model)
        if not (sim.points_major and model.h.is_cuda
                and tactile_query.may_read(struct, model)):
            raise AssertionError("the RollingBall path did not pick the "
                                 "points-major step and the K4 query")
        rollout = sim.make_rollout_strided(ROLL_STRIDE, remat=False,
                                           fast_tactile=True)
        print(f"  scene '{struct.name}': ndof_r={struct.ndof_q} ndof_u="
              f"{struct.ndof_u} markers={struct.ndof_tactile // 3}, "
              f"{len(struct.cp_joint) + len(struct.tac_joint)} points, "
              f"{struct.integrator}, h={float(model64.h)}, solver_max_iter "
              f"{struct.solver_max_iter}")

        def chunks(steps):
            return torch.as_tensor(rolling_ball_speed.control_chunks(
                steps, struct.ndof_u), dtype=torch.float32, device=dev)

        step = sim.step

        def timed(fn, n=3):
            fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(n):
                out = fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t1) / n * 1e3, out

        def split(state, u, where):
            """Where a step's time goes at ``state``."""
            step_ms, _ = timed(lambda: step(model, state, u))
            in_ms, inputs = timed(lambda: integrators.step_inputs(
                struct, model, state, u))
            tol = integrators.solver_tol(struct, torch.float32)
            fac_ms, factor = timed(lambda: integrators.chord_factor(
                step.residual_fn, inputs, state.qdot))
            sw_ms, _ = timed(lambda: integrators.chord_sweeps(
                step.residual_fn, struct.solver_max_iter, tol, inputs,
                state.qdot, factor))
            res_ms, _ = timed(lambda: step.residual_fn(state.qdot, inputs))
            q_ms, _ = timed(lambda: tactile_query.tactile_field(
                struct, model, state.q, state.qdot), 10)
            k_ms = self.kernel_rows.get("K4R", {}).get("ms", float("nan"))
            print(f"  {where}: per step {step_ms:.1f} ms: BDF2 bases "
                  f"(momenta) {in_ms:.1f} ms, J (one residual graph, "
                  f"{struct.ndof_q} batched pullbacks) + LU {fac_ms:.1f} ms, "
                  f"{struct.solver_max_iter} sweeps {sw_ms:.1f} ms (one "
                  f"residual {res_ms:.2f} ms); per tactile read {q_ms:.2f} "
                  f"ms (the read kernel {k_ms:.4f} ms of it), "
                  f"{q_ms / ROLL_STRIDE:.2f} ms "
                  f"per step [{self.card}]")
            return step_ms + q_ms / ROLL_STRIDE

        # warm-up chunk (tables, allocator), then where a step's time goes
        # at the start, which predicts the full run's time
        state0 = sim.init_state()
        rollout(model, state0, chunks(ROLL_STRIDE))
        torch.cuda.synchronize()
        per_step = split(state0, chunks(ROLL_STRIDE)[0], "at the start") / 1e3
        steps = ROLL_STEPS
        if per_step * ROLL_STEPS > ROLL_BUDGET_S:
            steps = ROLL_CUT
            print(f"  CUT: {per_step * 1e3:.1f} ms per step predicts "
                  f"{per_step * ROLL_STEPS:.0f} s for {ROLL_STEPS} steps > "
                  f"{ROLL_BUDGET_S:.0f} s: running the first {ROLL_CUT} "
                  "steps of the protocol")
        us = chunks(steps)
        K = us.shape[0]

        # (a) the main path
        dense_contact.reset_counts()
        t0 = time.perf_counter()
        state, qs, vars_, tacs = rollout(model, state0, us)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dense_contact.read_launches
        points = dense_contact.launches
        nsteps = K * ROLL_STRIDE
        tac = tacs.reshape(K, -1, 3).double().cpu().numpy()
        normal = np.abs(tac[:, :, 2])
        touched = np.nonzero(normal.max(axis=1) > 0)[0]
        last = tac[touched[-1]] if len(touched) else tac[-1]
        print(f"  read kernel launches {launches} (want {K}: one per "
              f"tactile read); points entry launches {points} (want 0)")
        print(f"  RollingBall {ROLL_RES}x{ROLL_RES} f32, {nsteps} steps, "
              f"{K} tactile reads in {wall:.2f} s: {nsteps / wall:.3f} sim "
              f"steps/s (FPS as the JAX CLI reckons it), "
              f"{wall / nsteps * 1e3:.1f} ms per step [{self.card}]")
        print(f"  reads in contact: {len(touched)} of {K}, steps "
              f"{[int(k + 1) * ROLL_STRIDE for k in touched]}; largest "
              f"normal over the run {normal.max():.4g}; last read in "
              f"contact: max |normal| = {np.abs(last[:, 2]).max():.4g}, max "
              f"|shear| = {np.linalg.norm(last[:, :2], axis=1).max():.4g}, "
              f"active markers = {int((np.abs(last[:, 2]) > 1e-9).sum())}; "
              f"final q {np.round(state.q.double().cpu().numpy(), 6).tolist()}")
        if (launches, points) != (K, 0):
            raise AssertionError(f"the read kernel launched {launches} "
                                 f"times, the points entry {points}; want "
                                 f"{K} and 0")
        if not bool(torch.isfinite(qs).all()):
            raise AssertionError("q not finite")
        if not len(touched):
            raise AssertionError("the tactile field stayed zero")
        self.kernel_rows.setdefault("K4R", {})["launches"] = launches
        # K4's points entry is off the main path since the read kernel
        # took the query (k4_kernels holds it to its plain version)
        self.kernel_rows.setdefault("K4", {})["launches"] = points

        # every op of a step is dense (no branch on the data), so the
        # split at the start holds in contact too
        self.device_share(lambda: step(model, state, us[-1]),
                          "one RollingBall step")

        # (b) the facade on the same scene
        fac = simulation.Simulation((struct, model64), device=dev,
                                    dtype=torch.float32)
        qp, vp = self.pressed_ball(model64.q_init.numpy())
        fac.set_state_init(qp, vp)
        fac.reset()
        fac.set_u([0.0, 0.0, 0.2])
        fac.forward(5)
        dense_contact.reset_counts()
        got = fac.get_tactile_force_vector()
        n_fac = dense_contact.read_launches
        want = fac.sim.tactile(fac.model, fac._state).cpu().numpy()
        print(f"  facade: forward(5) from the pressed state, "
              f"get_tactile_force_vector {got.shape}, max |f| "
              f"{np.abs(got).max():.4g}, read kernel launches {n_fac}; "
              "trajectory "
              f"{fac.export_trajectory().shape}")
        if n_fac != 1 or not np.array_equal(got, want):
            raise AssertionError("the facade's tactile vector is not the "
                                 "Simulator's query")
        if not np.abs(got).max() > 0:
            raise AssertionError("the facade's tactile vector is zero")

        # (c) card against CPU: 10 steps, 2 tactile reads
        cpu = torch.device("cpu")
        runs = {}
        for where, dtype in ((dev, torch.float64), (dev, torch.float32),
                             (cpu, torch.float64), (cpu, torch.float32)):
            m = model64.to(where, dtype)
            s = simulation.Simulator(struct, m)
            ro = s.make_rollout_strided(ROLL_STRIDE, fast_tactile=True)
            st0 = s.init_state(q=qp, qdot=vp)
            uu = torch.tensor([[0.1, 0.0, 0.2]] * 2, dtype=dtype,
                              device=where)
            dense_contact.reset_counts()
            t0 = time.perf_counter()
            st, _, _, tc = ro(m, st0, uu)
            if where.type == "cuda":
                torch.cuda.synchronize()
            print(f"  {where.type} {str(dtype)[6:]}: 10 steps, 2 reads in "
                  f"{time.perf_counter() - t0:.2f} s, read kernel launches "
                  f"{dense_contact.read_launches}")
            if dense_contact.read_launches != (2 if where.type == "cuda"
                                               else 0):
                raise AssertionError("the card's reads did not run the read "
                                     "kernel")
            runs[(where.type, dtype)] = {
                k: x.detach().double().cpu() for k, x in
                (("q", st.q), ("qdot", st.qdot), ("tactile", tc))}
        ref = runs[("cpu", torch.float64)]
        if not float(ref["tactile"].abs().max()) > 0:
            raise AssertionError("no contact in the card-vs-CPU window")
        rel = lambda g, w: float((g - w).abs().max()) / float(w.abs().max())
        for name, tol in ROLL_F64_TOL.items():
            err = rel(runs[("cuda", torch.float64)][name], ref[name])
            print(f"  card float64 vs cpu float64 {name:8s} rel {err:.3e} "
                  f"(tol {tol:g})")
            if not err <= tol:
                raise AssertionError(f"card float64 vs CPU: {name}")
        # float32 parts from float64 in this window as a property of f32
        # (ROLL_F32_VS_F64): the card's float32 run is held to the CPU's
        # float32 run's distance from float64
        mult, floor = ROLL_F32_VS_F64
        for name in ROLL_F64_TOL:
            e_card = rel(runs[("cuda", torch.float32)][name], ref[name])
            e_cpu = rel(runs[("cpu", torch.float32)][name], ref[name])
            direct = rel(runs[("cuda", torch.float32)][name],
                         runs[("cpu", torch.float32)][name])
            print(f"  float32 vs cpu float64 {name:8s} rel: card {e_card:.3e}"
                  f", cpu {e_cpu:.3e} (tol {mult:g} x cpu + {floor:g}); "
                  f"card vs cpu float32 {direct:.3e}")
            if not e_card <= mult * e_cpu + floor:
                raise AssertionError(f"card float32 vs CPU: {name}")

    # 8 -------------------------------------------------------------------
    def adjoint(self, dev):
        """Slice 7: the single-instance implicit-function adjoint. (a) BPTT
        on RollingBall 200 x 200, float32, by the CLI's --grad protocol;
        (b) the dense rollout's VJP and (c) the facade's backward, card
        against CPU on RollingBall 8 x 8 pressed."""
        from tactilesimulation_tpu_torch.examples import rolling_ball_speed
        from tactilesimulation_tpu_torch.model import task_scenes
        from tactilesimulation_tpu_torch.ops import dense_contact
        from tactilesimulation_tpu_torch.sim import simulation
        struct, model64 = task_scenes.rolling_ball(resolution=ROLL_RES)
        model = model64.to(dev, torch.float32)
        sim = simulation.Simulator(struct, model)
        # the CLI's loss and stride; from the pressed state, since from the
        # initial state the pad reaches the ball only at step 75 and the
        # gradient of the first steps is zero
        qp, vp = self.pressed_ball(model64.q_init.numpy())
        state0 = sim.init_state(q=qp, qdot=vp)

        def bptt(steps, remat=True):
            loss = rolling_ball_speed.bptt_loss(sim, model, state0,
                                                remat=remat)
            us = torch.as_tensor(rolling_ball_speed.control_chunks(
                steps, struct.ndof_u), dtype=torch.float32,
                device=dev).requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = loss(us)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (g,) = torch.autograd.grad(value, us)
            torch.cuda.synchronize()
            return g, (t1 - t0) / steps, (time.perf_counter() - t1) / steps

        # probe: one chunk, which predicts the phase's BPTT runs (the main
        # run twice, remat on and off, and three one-step runs)
        _, f_ms, b_ms = bptt(ROLL_STRIDE)
        steps = ADJ_STEPS
        predicted = (f_ms + b_ms) * (2 * ADJ_STEPS + 3)
        print(f"  probe: {ROLL_STRIDE} steps, forward {f_ms * 1e3:.1f} + "
              f"backward {b_ms * 1e3:.1f} ms per step; predicts "
              f"{predicted:.0f} s of BPTT runs [{self.card}]")
        if predicted > ADJ_BUDGET_S:
            steps = ADJ_CUT
            print(f"  CUT: {ADJ_STEPS} -> {ADJ_CUT} BPTT steps (the "
                  f"prediction is past {ADJ_BUDGET_S:.0f} s)")

        # (a) the main path, remat on (the CLI's), then off
        peak, runs = {}, {}
        for remat in (True, False):
            torch.cuda.reset_peak_memory_stats(dev)
            dense_contact.reset_counts()
            runs[remat] = bptt(steps, remat)
            peak[remat] = torch.cuda.max_memory_allocated(dev)
            if dense_contact.read_launches or dense_contact.launches:
                raise AssertionError("a BPTT run launched the read kernel "
                                     f"({dense_contact.read_launches}) or "
                                     f"the points entry "
                                     f"({dense_contact.launches})")
        g, f_ms, b_ms = runs[True]
        gn = float(torch.linalg.norm(g))
        finite = bool(torch.isfinite(g).all())
        diff = float((runs[False][0] - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        print(f"  RollingBall {ROLL_RES}x{ROLL_RES} f32 BPTT, {steps} steps "
              f"(stride {ROLL_STRIDE}) from the pressed state: forward "
              f"{f_ms * 1e3:.1f} ms + backward {b_ms * 1e3:.1f} ms per step, "
              f"{1.0 / (f_ms + b_ms):.3f} steps/s; remat off: forward "
              f"{runs[False][1] * 1e3:.1f} + backward "
              f"{runs[False][2] * 1e3:.1f} ms per step [{self.card}]")
        print(f"  peak memory allocated: remat {peak[True] / 2**20:.1f} MiB, "
              f"no remat {peak[False] / 2**20:.1f} MiB; |g| = {gn:.6g}, "
              f"finite = {finite}, remat on vs off {diff:.3e} of scale; "
              "read kernel launches under grad 0")
        if not finite or gn == 0.0:
            raise AssertionError(f"BPTT gradient |g| = {gn}, finite = "
                                 f"{finite}")
        # one BPTT step for the host's op count and the profiler (a
        # 5-step chunk's trace takes minutes to read back): a one-step dense
        # rollout with its field, the loss's terms, forward and backward
        dense = sim.make_rollout_dense()
        u1 = torch.as_tensor(rolling_ball_speed.control_chunks(
            ROLL_STRIDE, struct.ndof_u)[:1], dtype=torch.float32, device=dev)

        def bptt_step():
            us = u1.clone().requires_grad_()
            _, qs, _, tacs = dense(model, state0, us)
            value = torch.sum(tacs ** 2) * 1e3 + torch.sum(qs[-1, 3:6] ** 2)
            torch.autograd.grad(value, us)
            torch.cuda.synchronize()

        bptt_step()
        with AtenCount() as count:
            bptt_step()
        print(f"  eager aten ops per BPTT step: {count.n} (one dense step "
              "with its field, forward and backward)")
        self.device_share(bptt_step, "one BPTT step", grad=True)

        # (b) the dense rollout's VJP, card against CPU, RollingBall 8x8
        # pressed, 3 steps (BDF2's first-step fallback, then BDF2)
        cpu = torch.device("cpu")
        s8, m8 = task_scenes.rolling_ball(resolution=8)
        q8, v8 = self.pressed_ball(m8.q_init.numpy())
        us = [[0.1, 0.0, 0.2], [0.1, -0.05, 0.2], [0.0, 0.1, 0.25]]
        t0 = time.perf_counter()
        grads = {(w.type, dt): dense_vjp(s8, m8, w, dt, q8, v8, us)
                 for w in (dev, cpu) for dt in (torch.float64,
                                                torch.float32)}
        print(f"  (4 dense rollout VJPs in {time.perf_counter() - t0:.1f} s)")
        self._card_vs_cpu(grads, "dense rollout VJP")
        t0 = time.perf_counter()

        # (c) the facade's backward engine, card against CPU, float64
        facs = {(w.type, torch.float64): facade_backward(
            s8, m8, w, torch.float64, q8, v8) for w in (dev, cpu)}
        print(f"  (2 facades in {time.perf_counter() - t0:.1f} s)")
        self._card_vs_cpu(facs, "facade")

    # 9 -------------------------------------------------------------------
    def ppo(self, dev):
        """Slice 8: PPO on TactilePush through the env registry, the vector
        env of single-instance envs and the trainer, every observation
        read by the read kernel; then the single-instance env, card
        against CPU."""
        import copy
        import yaml
        from tactilesimulation_tpu_torch import envs
        from tactilesimulation_tpu_torch.algorithms.ppo import PPO
        from tactilesimulation_tpu_torch.ops import (dense_contact,
                                                    tactile_query)
        from tactilesimulation_tpu_torch.utils.tree import tree_index
        with open(PPO_CFG) as fp:
            cfg = yaml.safe_load(fp)["params"]
        conf = cfg["config"]
        N = conf["num_processes"]
        env = envs.make(cfg["env"]["name"],
                        observation_type=cfg["env"]["observation_type"],
                        device=dev, dtype=torch.float32, seed=0)

        def trainer(T):
            c = copy.deepcopy(cfg)
            nmb = max(d for d in range(1, conf["num_mini_batch"] + 1)
                      if (N * T) % d == 0)
            c["config"].update(num_steps=T, num_env_steps=N * T,
                               num_mini_batch=nmb)
            return PPO(env, c, seed=0)

        # probe: one env step (with the first use of the read plan and the
        # allocator in it); a vector step is N of them one after another
        # (the policy and the normalisation take about 1 ms of it)
        with torch.no_grad():
            state, _ = env.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            env.step(state, torch.zeros(env.ndof_u, device=dev))
            torch.cuda.synchronize()
        step_s = N * (time.perf_counter() - t0)
        T = min(conf["num_steps"],
                max(PPO_T_MIN, int(PPO_BUDGET_S / step_s)))
        print(f"  probe: one env step {step_s / N:.3f} s, so a vector step "
              f"(N = {N}) about {step_s:.3f} s; {PPO_BUDGET_S:.0f} s of "
              f"rollout fit T = {T} [{self.card}]")

        # (a) the main path: one update of ppo_tactile.yaml at its widths
        algo = trainer(T)
        print(f"  CUT: num_steps {conf['num_steps']} -> {T}, num_env_steps "
              f"{conf['num_env_steps']} -> {N * T} (one update), "
              f"num_mini_batch {conf['num_mini_batch']} -> "
              f"{algo.num_mini_batch} (a divisor of N x T = {N * T}); "
              f"kept: N = {N}, ppo_epoch {algo.ppo_epoch}, the nets "
              f"{cfg['network']['actor_mlp']['layer_sizes']} "
              f"{cfg['network']['actor_mlp']['activation']}, obs "
              f"{env.obs_size()}")
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        dense_contact.reset_counts()
        t0 = time.perf_counter()
        algo.train(stop_update=1)
        wall = time.perf_counter() - t0
        env.max_episode_steps, full = PPO_PLAY, env.max_episode_steps
        try:
            ret, played, _ = algo.play_once()
        finally:
            env.max_episode_steps = full
        torch.cuda.synchronize()
        reads, points = dense_contact.read_launches, dense_contact.launches
        peak = torch.cuda.max_memory_allocated(dev)
        want = N * (1 + T + T // full) + 1 + played
        last = algo.last_update
        rollout_s, update_s = last["rollout_s"], last["update_s"]
        metrics, raw_r = last["metrics"], last["raw_rewards"]
        print(f"  read kernel launches {reads} (want {want}: N x (1 + T) "
              f"reads in training, 1 + {played} in play_once); points "
              f"entry launches {points} (want 0)")
        print(f"  PPO TactilePush f32, N = {N}, T = {T}: train(stop_update"
              f"=1) {wall:.2f} s; rollout {rollout_s:.3f} s, "
              f"{rollout_s / T * 1e3:.1f} ms per vector step, "
              f"{N * T / rollout_s:.4f} env steps/s; update "
              f"{update_s * 1e3:.1f} ms ({algo.ppo_epoch} x "
              f"{algo.num_mini_batch} minibatches of "
              f"{N * T // algo.num_mini_batch}); peak memory "
              f"{peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} MiB above "
              f"what was allocated before the run [{self.card}]")
        print(f"  loss {float(metrics[0]):.5f}, action loss "
              f"{float(metrics[1]):.5f}, value loss {float(metrics[2]):.5f},"
              f" entropy {float(metrics[3]):.4f}; mean reward "
              f"{float(raw_r.mean()):.4f}; play_once: {played} steps, "
              f"return {ret:.4f}")
        if (reads, points) != (want, 0):
            raise AssertionError(f"the read kernel launched {reads} times, "
                                 f"the points entry {points}; want {want} "
                                 "and 0")
        params = list(algo.ac.parameters())
        if not (bool(torch.isfinite(metrics).all())
                and all(bool(torch.isfinite(p).all()) for p in params)
                and bool(torch.isfinite(raw_r).all())
                and math.isfinite(ret)):
            raise AssertionError("non-finite loss, parameters or rewards")
        self.kernel_rows.setdefault("K4R", {})["launches"] = \
            self.kernel_rows.get("K4R", {}).get("launches", 0) + reads

        # the main run's last vector state: one env step's eager ops, and
        # (below) the profiler and its reads held to the plain version
        vec = last["vec"]
        with torch.no_grad():
            nobs = algo._norm_obs(algo.norm.obs_rms, vec.obs)
            action = algo.ac.act(nobs, deterministic=True)[1]
            state0 = tree_index(vec.env_states, 0)
            with AtenCount() as count:
                env.step(state0, action[0])
        print(f"  a vector step's host seconds (the rollout's split, per "
              f"step): {N} env steps {last['env_s'] / T * 1e3:.1f} ms, the "
              f"policy's act {last['act_s'] / T * 1e3:.3f} ms, the obs "
              f"normalisation {last['norm_s'] / T * 1e3:.3f} ms; eager aten "
              f"ops per env step {count.n} [{self.card}]")
        # the profiler over one substep: a vector step is 8 env steps of 5
        # substeps each, about 1.9 million kernels, and a trace's read-back
        # grows with its events (the adjoint phase's 5-step chunk, 427,516
        # kernels, took minutes); every substep runs the same ops, and the
        # rest of an env step and the policy's ops are under 1 % of them
        u6 = torch.cat([torch.tanh(action[0]), action.new_zeros(3)])
        self.device_share(lambda: env._step_sim(env.model, state0.sim, u6),
                          "one substep of the vector step")
        # the vector step's reads against the plain version. In float64
        # the read kernel's double instance at the same states, to READ_TOL
        # on every row, on the float64 scene's model. (The float32 model
        # widened will not do: its unit quaternions are off the unit
        # sphere by up to 2^-24, and the kernel's twist, 2 q' q*, and the
        # plain version's analytic twists part there by about 1e-8 of
        # scale; the phase prints that distance too.) In float32 each
        # observation is held to the float64 plain version on the same
        # model, widened (PPO_READ_F32_VS_F64)
        struct = env.struct
        m64 = envs.make(cfg["env"]["name"],
                        observation_type=cfg["env"]["observation_type"],
                        device=dev, dtype=torch.float64).model
        widened = env.model.to(dev, torch.float64)
        off_unit = float((widened.joint_quat.norm(dim=-1) - 1).abs().max())
        mult, floor = PPO_READ_F32_VS_F64
        plain = tactile_query.tactile_field_ref
        row = lambda a, b: (a.double() - b.double()).abs().amax(dim=1)
        active, parted, worst_w = 0, 0, 0.0
        worst64, worst = (0.0, -1, -1), (0.0, 0.0)
        for i in range(N):
            q = vec.env_states.sim.q[i].double()
            v = vec.env_states.sim.qdot[i].double()
            ref64 = plain(struct, m64, q, v)
            scale = float(ref64.abs().max())
            e64 = row(tactile_query.tactile_field(struct, m64, q, v), ref64)
            r = int(e64.argmax())
            if not float(e64[r]) <= READ_TOL[torch.float64] * scale:
                raise AssertionError(
                    f"ppo env {i}: the f64 read is {float(e64[r]):.3e} off "
                    f"the plain version on row {r} (scale {scale:.3e})")
            active += int((ref64.abs().sum(dim=1) > 0).sum())
            if scale > 0:
                worst64 = max(worst64, (float(e64[r]) / scale, i, r))
            refw = plain(struct, widened, q, v)
            scale = max(float(refw.abs().max()), 1e-30)
            worst_w = max(worst_w, float(row(tactile_query.tactile_field(
                struct, widened, q, v), refw).max()) / scale)
            got = vec.obs[i, 3:].reshape(-1, 3)
            ref32 = plain(struct, env.model, q.float(), v.float())
            e_k = float(row(got, refw).max()) / scale
            e_p = row(ref32, refw) / scale
            parted += int((e_p > READ_TOL[torch.float32]).sum())
            worst = max(worst, (e_k, float(e_p.max())))
            if not e_k <= mult * float(e_p.max()) + floor:
                raise AssertionError(
                    f"ppo env {i}: the read is {e_k:.3e} of scale off the "
                    f"float64 plain version, the float32 one "
                    f"{float(e_p.max()):.3e}")
        if active == 0:
            raise AssertionError("ppo: no marker touches the box in the "
                                 "vector step's states")
        print(f"  the vector step's {N} reads against the plain version: "
              f"{active} rows in contact; the f64 read on the f64 scene "
              f"{worst64[0]:.3e} of scale (env {worst64[1]}, row "
              f"{worst64[2]}; tol {READ_TOL[torch.float64]:g}); on the f32 "
              f"model widened (|joint_quat| - 1 up to {off_unit:.2e}) "
              f"{worst_w:.3e}; the observations (f32) {worst[0]:.3e} of "
              f"scale from float64, the f32 plain version {worst[1]:.3e} "
              f"(tol {mult:g} x it + {floor:g}), which parts from float64 "
              f"by more than {READ_TOL[torch.float32]:g} on {parted} of "
              f"{N * struct.ndof_tactile // 3} rows")

        # (b) the single-instance env, card against CPU
        self.ppo_cross(dev)

    def ppo_cross(self, dev):
        """The single-instance TactilePush env (tactile_flatten) from a
        seeded reset with injected draws, PPO_CROSS_US: the card (the read
        kernel) against the CPU (its plain version), float64 within
        PPO_F64_TOL of scale; float32 held to the CPU float32 run's distance
        from float64."""
        from tactilesimulation_tpu_torch.envs import tactile_push
        from tactilesimulation_tpu_torch.ops import dense_contact
        H = len(PPO_CROSS_US)
        rng = np.random.RandomState(9)
        gy = rng.uniform(-0.2, 0.2)
        reset = (np.array([rng.uniform(-0.02, 0.02)]),
                 np.array([[rng.uniform(0.15, 0.25)], [gy],
                           [gy * np.pi + rng.uniform(-np.pi / 16,
                                                     np.pi / 16)]]))
        # a resampled disturbance at t = 0, kept after
        dist = [(np.array([False]), rng.uniform(-1, 1, (2, 1)))
                for _ in range(H)]
        runs = {}
        cpu = torch.device("cpu")
        for where, dtype in ((dev, torch.float64), (cpu, torch.float64),
                             (dev, torch.float32), (cpu, torch.float32)):
            env = tactile_push.make("tactile_flatten", device=where,
                                    dtype=dtype)
            draws = iter(dist)

            def injected(what, B, where=where, dtype=dtype, draws=draws):
                a, b = reset if what == "reset" else next(draws)
                return (torch.as_tensor(a, device=where),
                        torch.as_tensor(b, device=where, dtype=dtype))

            env._draw = injected
            dense_contact.reset_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                state, obs = env.reset()
                rewards = []
                for u in PPO_CROSS_US:
                    state, obs, r, _, _ = env.step(
                        state, torch.tensor(u, dtype=dtype, device=where))
                    rewards.append(r)
            q = state.sim.q
            out = {"q": q, "qdot": state.sim.qdot, "tactile_flatten": obs,
                   "privilege": tactile_push.observation(
                       "privilege", q, state.extras.tactile,
                       state.extras.goal),
                   "reward": torch.stack(rewards)}
            label = "card" if where is dev else "cpu"
            runs[(label, dtype)] = {k: v.double().cpu()
                                    for k, v in out.items()}
            reads = dense_contact.read_launches
            print(f"  {label} {dtype}: reset + {H} env steps in "
                  f"{time.perf_counter() - t0:.2f} s, read kernel launches "
                  f"{reads}")
            if reads != (1 + H if where.type == "cuda" else 0):
                raise AssertionError(f"{label}: {reads} read launches "
                                     f"for {1 + H} reads")
        if not float(runs[("cpu", torch.float64)]["tactile_flatten"][3:]
                     .abs().max()) > 0:
            raise AssertionError("the pad never touched the box")
        self.compare_runs(runs, "TactilePush env", PPO_F64_TOL)

    def insertion(self, dev):
        """Slice 9: recurrent PPO on TactileInsertion through the lane-major
        vec env (K1 with per-lane contact parameters, K1T in every chord
        factor): (a) the main path, its update here and its play_once at
        the end; (b) at the main run's own states: K1 and K1T against their
        plain versions; the first vector step's first substep (chord
        factor, chord, a capture) card against CPU; the vector step around
        its script card against CPU; (c) the cut settle, card against
        CPU."""
        run = self.insertion_train(dev)
        self.insertion_k1(dev, run)
        self.insertion_substep_check(dev, run)
        self.insertion_bookkeeping(dev, run)
        e = max_rel({"q": insertion_settle(dev)},
                    {"q": insertion_settle(torch.device("cpu"))})["q"]
        print(f"  (c) settle {INS_SETTLE_CUT} f64, card vs cpu {e:.3e} (tol "
              f"{INS_F64_TOL:g})")
        if not e <= INS_F64_TOL:
            raise AssertionError("insertion, the cut settle: card vs CPU")
        print(f"  a read plan for a new episode's model (domain "
              f"randomisation) {self.insertion_read_plan(dev):.3f} ms "
              f"[{self.card}]")
        self.insertion_play(dev, run)

    @staticmethod
    def insertion_read_plan(dev):
        """ms to build the read kernel's plan for a model with new contact
        parameters (the single-instance route rebuilds it every episode)."""
        from tactilesimulation_tpu_torch.ops import dense_contact
        env, _ = insertion_env(dev, torch.float32)
        s = env._sample_reset(1)
        models = [env._model_for({k: v[0].clone() for k, v in s.items()})
                  for _ in range(5)]
        dense_contact.ReadPlan(env.struct, models[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in models[1:]:
            dense_contact.ReadPlan(env.struct, m)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 4 * 1e3

    def insertion_k1(self, dev, run):
        """(b) K1 and K1T at this path's shapes and state: the main run's
        first capture of its first vector step (2N lanes, per-lane
        parameters (K + S, 4, 2N)). K1 and K1T (float32) and the float32
        plain version and its VJP are each held to the float64 plain
        version and its VJP on the same inputs, per output and per
        cotangent: the kernel's max abs error over the output's scale
        within INS_K1_F32_VS_F64 x the float32 plain version's + K1_TOL
        (K1T_TOL["rel"] for K1T); two launches bit-equal; their device
        times."""
        from tactilesimulation_tpu_torch.ops import lane_contact
        from tactilesimulation_tpu_torch.sim import contact, lanes
        pw, struct = run["pw"], run["lenv"].struct
        model, q, v = (x.to("cpu", torch.float64) for x in run["capture"])
        with torch.no_grad():
            jp, jq, bp, bquat, _, _, _, Om, be = lanes._fused_small_stage(
                struct, model, q, v)
            a64 = [jp, jq, Om, be, bp, bquat, model.body_size,
                   contact.combined_params(model), model.ground_pos,
                   model.ground_normal,
                   lane_contact.pack_points(struct, model,
                                            lanes._tables(struct, q).src_idx)]
        a64 = [x.contiguous() for x in a64]
        B = q.shape[-1]
        cots64 = [torch.as_tensor(np.random.RandomState(2).randn(3, n, B))
                  for n in (pw.J, pw.J, pw.ntac)]

        def plain(args, cots):
            ins = [x.detach().requires_grad_() for x in args]
            outs = pw.reference(*ins)
            live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
            return [o.detach() for o in outs] + list(torch.autograd.grad(
                [o for o, _ in live], ins, [c for _, c in live],
                allow_unused=True))

        f32 = lambda xs: [x.to(dev, torch.float32).contiguous() for x in xs]
        a, cots = f32(a64), f32(cots64)
        if a[7].dim() != 3 or a[7].shape[-1] != B:
            raise AssertionError(f"parameters {tuple(a[7].shape)}: not per "
                                 "lane")
        with torch.no_grad():
            runs = [list(pw.run_kernel(*a))
                    + list(pw.run_adjoint(a, cots, (True,) * 11))
                    for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(*runs)):
            raise AssertionError("K1/K1T at the path's state: two launches "
                                 "differ")
        names = ["F", "Tau", "tac"] + list(lane_contact._ARG_NAMES)
        mult, bad, rows = INS_K1_F32_VS_F64, [], []
        for i, (name, k, p, w) in enumerate(zip(names, runs[0],
                                                plain(a, cots),
                                                plain(a64, cots64))):
            what = ("K1 " if i < 3 else "K1T ") + name
            if w is None:
                if float(k.abs().max()) != 0.0:
                    bad.append(f"{what} not 0")
                continue
            scale = max(float(w.abs().max()), 1e-300)
            ek = float((k.double().cpu() - w).abs().max()) / scale
            ep = float((p.double().cpu() - w).abs().max()) / scale
            allowed = mult * ep + (K1_TOL if i < 3 else K1T_TOL["rel"])
            rows.append(f"{what} {ek:.2e}/{ep:.2e}")
            if not ek <= allowed:
                bad.append(f"{what}: {ek:.3e} > {mult:g} x {ep:.3e} + floor")
        print(f"  (b) K1/K1T at the path's state ({B} lanes, per-lane "
              f"parameters {tuple(a[7].shape)}), kernel/plain f32 error "
              f"over scale from f64 (tol {mult:g} x plain + {K1_TOL:g} / "
              f"{K1T_TOL['rel']:g}): " + ", ".join(rows))
        if float(runs[0][0].abs().max()) <= 1e-3:
            bad.append("no active contact")
        if bad:
            raise AssertionError(f"K1/K1T at the insertion path's state: "
                                 f"{bad}")
        need = (True,) * 6 + (False,) * 5      # what a chord factor asks
        with torch.no_grad():
            k_ms = device_ms(lambda: pw.run_kernel(*a), 50)
            kt_ms = device_ms(lambda: pw.run_adjoint(a, cots, need), 50)
        k1_script, k1t_script = run["lenv"].launches_per_script()
        print(f"  (b) K1 at this path's shapes {k_ms:.4f} ms on the device, "
              f"K1T (a factor's cotangents) {kt_ms:.4f} ms: "
              f"{k1_script * k_ms + k1t_script * kt_ms:.1f} ms of a "
              f"{run['script_s'] * 1e3:.0f} ms script [{self.card}]")

    def insertion_substep_check(self, dev, run):
        """(b) The first vector step's first substep, from the inputs the
        main run recorded: its chord factor and chord, and its first
        capture. The card's float32 values are the main run's own (K1,
        K1T); the card's float64 run and the CPU's float32 and float64 runs
        recompute them (the plain lane contact); ``_card_vs_cpu``'s rule:
        float64 within ADJ_F64_TOL (INS_F64_TOL), float32 within
        ROLL_F32_VS_F64 of the CPU float32 run's distance from float64."""
        inputs, v0, lu, v = run["chord"]
        model, q, qd, field = run["capture"] + (run["field"],)
        runs = {("cuda", torch.float32): {
            k: x.detach().double().cpu()
            for k, x in (("factor", lu), ("v", v), ("capture", field))}}
        for where, d, dtype in (("cuda", dev, torch.float64),
                                ("cpu", "cpu", torch.float64),
                                ("cpu", "cpu", torch.float32)):
            lenv = insertion_lanes(torch.device(d), dtype)
            runs[(where, dtype)] = insertion_substep(lenv, inputs, v0,
                                                     (model, q, qd))
        self._card_vs_cpu(runs, "(b) the first substep")

    def insertion_bookkeeping(self, dev, run):
        """(b) The first vector step around its script (the action's
        commanded pose, the reset side's draws, the outcome, the flags and
        the merge), card against CPU in float64 within INS_F64_TOL of each
        output's scale (the flags equal): the main run's state, draws and
        action, its script's outputs in place of the script, and the last
        lane at max_episode_steps - 1, so that it ends by the time
        limit."""
        st, obs0, t, action = run["step_in"]
        final_q, obs_all = run["step_script"]
        draws = run["step_draws"]
        outs = {}
        for where, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            lenv = insertion_lanes(d, torch.float64)
            to = lambda x: x.to(d, torch.float64)
            it = iter(draws)

            def injected(what, B, it=it, to=to):
                want, value = next(it)
                if want != what:
                    raise AssertionError(f"draw {what}, expected {want}")
                if isinstance(value, dict):
                    return {k: None if x is None else to(x)
                            for k, x in value.items()}
                return to(value)

            lenv.env._draw = injected
            lenv._lane_execute = lambda *_, to=to: (to(final_q), to(obs_all))
            t_end = t.clone()
            t_end[-1] = lenv.max_episode_steps - 1
            st_d = dataclasses.replace(st, **{
                f.name: to(getattr(st, f.name))
                for f in dataclasses.fields(st)})
            outs[where] = insertion_outputs(lenv.vec_step_autoreset(
                st_d, to(obs0), t_end.to(d), to(action)), final_q)
        e = max_rel(outs["cuda"], outs["cpu"])
        flags = ("t", "done", "bad", "success")
        bad = [k for k, x in e.items()
               if not (x == 0 if k in flags else x <= INS_F64_TOL)]
        worst = max(x for k, x in e.items() if k not in flags)
        print(f"  (b) the first vector step around its script, card vs cpu "
              f"f64: worst {worst:.3e} (tol {INS_F64_TOL:g}), flags equal: "
              f"{all(e[k] == 0 for k in flags)}; done "
              f"{outs['cpu']['done'].int().tolist()} (the last lane at the "
              f"time limit)")
        if not bool(outs["cpu"]["done"][-1]):
            bad.append("the last lane did not end at the time limit")
        if bad:
            raise AssertionError(f"insertion bookkeeping, card vs CPU: {bad}")

    def insertion_train(self, dev):
        """(a) PPO-RNN by INS_CFG at its widths through the lane env on the
        card, up to its first update: a probe picks T; launches, times,
        ops, busy share. Returns the run's record for (b) and play_once:
        the trainer, the lane env, the first vector step's input state,
        draws and script outputs, its first chord's inputs and outputs and
        its first capture's."""
        import copy
        from tactilesimulation_tpu_torch.algorithms.ppo_rnn import PPORNN
        from tactilesimulation_tpu_torch.envs import tactile_insertion as ti
        from tactilesimulation_tpu_torch.envs.tactile_insertion_lanes import (
            TactileInsertionLanes, chord_tol)
        from tactilesimulation_tpu_torch.ops import dense_contact
        from tactilesimulation_tpu_torch.sim import lanes
        env, cfg = insertion_env(dev, torch.float32)
        conf = cfg["config"]
        N = conf["num_processes"]
        lenv = TactileInsertionLanes(env)
        pw = lenv.pair_wrenches
        if pw is None:
            raise AssertionError("the card's lane env did not take K1")
        k1_script, k1t_script = lenv.launches_per_script()
        struct, S1 = env.struct, len(env.capture_frames)

        # probe at a vector step's 2N lanes: a substep's momentum and
        # chord (r0 + max_iter residuals), a chord factor and a capture;
        # a script is 45 substeps, 1 + ceil(45 / refresh) factors and S + 1
        # captures. Its draws go before PPORNN reseeds the generator
        with torch.no_grad():
            s = env._sample_reset(2 * N)
            model = lenv._batched_model({k: s[k].T for k in ti.DR_NAMES})
            q = s["q_cmd"].T.contiguous()
            v = torch.zeros_like(q)
            inputs = lanes.StepInputs(
                model=model, u=q[:6].contiguous(), q_base=q,
                p_base=lanes.momentum(struct, model, q, v),
                gamma=model.h.reshape(1, 1))
            tol = chord_tol(struct, torch.float32)
            lu = lanes.make_chord_lu(lenv._residual, inputs, v)
            parts = {
                "momentum": lambda: lanes.momentum(struct, model, q, v),
                "chord": lambda: lanes._chord(lenv._residual, lenv.max_iter,
                                              tol, inputs, v, lu),
                "factor": lambda: lanes.make_chord_lu(lenv._residual,
                                                      inputs, v),
                "capture": lambda: lenv._tactile(model, q, v)}
            ms, ops = {}, {}
            for k, fn in parts.items():
                ms[k] = cuda_ms(fn, 2, warmup=1)
                with AtenCount() as count:
                    fn()
                ops[k] = count.n
        factors = k1t_script // struct.ndof_q
        per_script = lambda d: (45 * (d["momentum"] + d["chord"])
                                + factors * d["factor"]
                                + S1 * d["capture"])
        script_s = per_script(ms) / 1e3
        T = min(conf["num_steps"],
                max(INS_T_MIN, int(INS_BUDGET_S / script_s)))
        print(f"  probe at {2 * N} lanes: momentum {ms['momentum']:.1f} ms, "
              f"chord (r0 + {lenv.max_iter} sweeps) {ms['chord']:.1f} ms, "
              f"factor ({struct.ndof_q} pullbacks) {ms['factor']:.1f} ms, "
              f"capture {ms['capture']:.2f} ms: a script about "
              f"{script_s:.1f} s; {INS_BUDGET_S:.0f} s of rollout fit T = "
              f"{T} [{self.card}]")
        print(f"  eager aten ops: momentum {ops['momentum']}, chord "
              f"{ops['chord']}, factor {ops['factor']}, capture "
              f"{ops['capture']}: {per_script(ops)} per script (a vector "
              f"step, 45 x (momentum + chord) + {factors} factors + {S1} "
              f"captures)")
        with torch.no_grad():
            self.device_share(parts["chord"], "one substep's chord "
                              f"({2 * N} lanes)")

        c = copy.deepcopy(cfg)
        c["config"].update(num_steps=T, num_env_steps=N * T)
        algo = PPORNN(lenv, c, seed=0)
        net = cfg["network"]
        print(f"  CUT: num_steps {conf['num_steps']} -> {T}, num_env_steps "
              f"{conf['num_env_steps']} -> {N * T} (one update), play_once "
              f"for up to {INS_PLAY} steps; kept: N = {N}, ppo_epoch "
              f"{algo.ppo_epoch}, num_mini_batch {algo.num_mini_batch}, obs "
              f"{env.obs_size()}, CNN {net['feature_cnn']['kernel_sizes']} "
              f"x {net['feature_cnn']['layer_sizes']} -> "
              f"{net['feature_cnn']['hidden_size']}, GRU "
              f"{net['rnn_hidden_layers']} x {net['rnn_hidden_size']}, "
              f"actor and critic {net['actor_mlp']['layer_sizes']} "
              f"{net['actor_mlp']['activation']}, domain randomisation "
              f"{env.domain_randomization}, rotation {env.allow_rotation}")
        # kept from the run without an op added: the captures (whether
        # some row is in contact), and of the first vector step its input
        # state, draws, script outputs, first chord and first capture
        run = {"algo": algo, "lenv": lenv, "pw": pw, "T": T,
               "script_s": script_s, "fields": [], "draws": []}
        tactile, execute, draw = lenv._tactile, lenv._lane_execute, env._draw
        step, chord = lenv.vec_step_autoreset, lanes._chord
        in_step = lambda: "step_in" in run and "step_script" not in run

        def keep_tactile(*args):
            field = tactile(*args)
            run["fields"].append(field)
            if in_step() and "capture" not in run:
                run["capture"], run["field"] = args, field
            return field

        def keep_chord(residual, max_iter, tol, inputs, v0, lu):
            v = chord(residual, max_iter, tol, inputs, v0, lu)
            if in_step() and "chord" not in run:
                run["chord"] = (inputs, v0, lu, v)
            return v

        def keep_draw(what, B):
            value = draw(what, B)
            if "step_script" not in run:
                run["draws"].append((what, value))
            return value

        def keep_execute(*args):
            out = execute(*args)
            if in_step():
                run["step_script"] = out
            return out

        def keep_step(st, obs, t, action):
            if "step_in" not in run:
                run["step_in"] = (st, obs, t, action)
            return step(st, obs, t, action)

        lenv._tactile, lenv._lane_execute = keep_tactile, keep_execute
        env._draw, lenv.vec_step_autoreset = keep_draw, keep_step
        lanes._chord = keep_chord
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        pw.reset_counts()
        dense_contact.reset_counts()
        t0 = time.perf_counter()
        try:
            algo.train(stop_update=1)
            torch.cuda.synchronize()
        finally:
            lanes._chord = chord
            env._draw, lenv.vec_step_autoreset = draw, step
            lenv._tactile, lenv._lane_execute = tactile, execute
        wall = time.perf_counter() - t0
        k1, k1t = pw.launches, pw.bwd_launches
        twin = pw.twin_vjps + pw.twin_recomputes
        reads, points = dense_contact.read_launches, dense_contact.launches
        peak = torch.cuda.max_memory_allocated(dev)
        run["step_draws"] = run["draws"][2:]   # vec_reset took the first 2
        scripts = 1 + T
        want = (scripts * k1_script, scripts * k1t_script)
        print(f"  launches: K1 {k1}, K1T {k1t} (want {scripts} scripts x "
              f"({k1_script}, {k1t_script}) = {want}: per script "
              f"{factors} factors + 45 x (1 + {lenv.max_iter}) residuals + "
              f"{S1} captures, and {struct.ndof_q} pullbacks a factor); "
              f"twin {twin} (want 0)")
        if (k1, k1t) != want or twin:
            raise AssertionError("the insertion update did not run through "
                                 "K1/K1T as counted")
        for key, n in (("K1", k1), ("K1T", k1t)):
            row = self.kernel_rows.setdefault(key, {})
            row["launches"] = row.get("launches", 0) + n

        last_u = algo.last_update
        rollout_s, update_s = last_u["rollout_s"], last_u["update_s"]
        metrics, raw_r = last_u["metrics"], last_u["raw_rewards"]
        vec = last_u["vec"]
        print(f"  PPO-RNN TactileInsertion f32, N = {N}, T = {T}: "
              f"train(stop_update=1) {wall:.2f} s (the vec_reset's script "
              f"{wall - rollout_s - update_s:.2f} s); rollout "
              f"{rollout_s:.3f} s, {rollout_s / T * 1e3:.1f} ms per vector "
              f"step: the script {last_u['env_s'] / T * 1e3:.1f} ms, the "
              f"policy {last_u['act_s'] / T * 1e3:.2f} ms, the "
              f"normalisation {last_u['norm_s'] / T * 1e3:.3f} ms; "
              f"{N * T / rollout_s:.4f} env steps/s; update "
              f"{update_s * 1e3:.1f} ms ({algo.ppo_epoch} x "
              f"{algo.num_mini_batch} minibatches of "
              f"{N // algo.num_mini_batch} env x {T} steps); peak memory "
              f"{peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} MiB "
              f"above what was allocated before [{self.card}]")
        print(f"  loss {float(metrics[0]):.5f}, action loss "
              f"{float(metrics[1]):.5f}, value loss {float(metrics[2]):.5f}, "
              f"entropy {float(metrics[3]):.4f}; mean reward "
              f"{float(raw_r.mean()):.4f}")
        params = list(algo.ac.parameters())
        if not (bool(torch.isfinite(metrics).all())
                and all(bool(torch.isfinite(p).all()) for p in params)
                and bool(torch.isfinite(raw_r).all())
                and bool(torch.isfinite(vec.obs).all())):
            raise AssertionError("non-finite loss, parameters, rewards or "
                                 "observations")
        normal = torch.cat([f[:, 2].abs().amax(dim=0)
                            for f in run["fields"]])   # per capture, lane
        final_q = run["step_script"][0]
        flown = int((final_q.abs().amax(dim=0) > 1.0).sum())
        print(f"  captures of the run: {int((normal > 0).sum())} of "
              f"{normal.numel()} (capture, lane) pairs with a marker in "
              f"contact, |normal| up to {float(normal.max()):.3e} N; in the "
              f"first vector step {flown} of {final_q.shape[1]} lanes end "
              f"with some |q| > 1 (the box thrown off the pads)")
        if not bool((normal > 0).any()):
            raise AssertionError("no capture row in contact")
        if reads or points:
            raise AssertionError(f"the lane path launched the read kernel "
                                 f"({reads}, points entry {points})")
        del run["fields"]
        return run

    def insertion_play(self, dev, run):
        """(a) play_once for INS_PLAY steps, the single-instance env (K4R
        reads its captures); the read kernel's launches, counted from 0
        around it."""
        from tactilesimulation_tpu_torch.ops import dense_contact
        algo, env = run["algo"], run["lenv"].env
        S1 = len(env.capture_frames)
        env.max_episode_steps, full = INS_PLAY, env.max_episode_steps
        dense_contact.reset_counts()
        run["pw"].reset_counts()
        t1 = time.perf_counter()
        try:
            ret, success, _, played, extra = algo.play_once()
        finally:
            env.max_episode_steps = full
        torch.cuda.synchronize()
        play_s = time.perf_counter() - t1
        reads, points = dense_contact.read_launches, dense_contact.launches
        lane = run["pw"].launches + run["pw"].bwd_launches
        want = (1 + played) * S1
        print(f"  play_once {played} steps {play_s:.1f} s: return "
              f"{ret:.4f}, success {success}, class counts "
              f"{extra['class_cnt'].tolist()}; read kernel {reads} (want "
              f"{want}: {1 + played} single-instance scripts x {S1} "
              f"captures); points entry {points}, K1/K1T {lane} (want 0) "
              f"[{self.card}]")
        if reads != want or points or lane or not math.isfinite(ret):
            raise AssertionError("play_once did not read through K4R as "
                                 "counted, or its return is not finite")
        row = self.kernel_rows.setdefault("K4R", {})
        row["launches"] = row.get("launches", 0) + reads

    # 11 ------------------------------------------------------------------
    def env_read_check(self, what, struct, model, m64, q, v, got):
        """A single-instance env's float32 read ``got`` at its recorded
        state (q, v) on ``model``, held to the plain version: the read
        kernel's float64 instance at the same state on the float64 Model
        ``m64`` on every row to READ_TOL of scale plus the plain version's
        own jump at round-off (READ_F64_JITTER), and ``got`` within
        PPO_READ_F32_VS_F64 of the float32 plain version's distance from
        the float64 one on ``model`` widened. Returns the rows in
        contact."""
        from tactilesimulation_tpu_torch.ops import tactile_query
        plain = tactile_query.tactile_field_ref
        row = lambda a, b: (a.double() - b.double()).abs().amax(dim=1)
        q64, v64 = q.double(), v.double()
        ref64 = plain(struct, m64, q64, v64)
        scale = float(ref64.abs().max())
        active = int((ref64.abs().sum(dim=1) > 0).sum())
        if active == 0:
            raise AssertionError(f"{what}: no row in contact")
        e64 = float(row(tactile_query.tactile_field(struct, m64, q64, v64),
                        ref64).max())
        tol64, jump = read_f64_tol(struct, m64, q64, v64, ref64)
        widened = model.to(q.device, torch.float64)
        refw = plain(struct, widened, q64, v64)
        sw = float(refw.abs().max())
        e_k = float(row(got, refw).max()) / sw
        e_p = float(row(plain(struct, model, q64.float(), v64.float()),
                        refw).max()) / sw
        mult, floor = PPO_READ_F32_VS_F64
        print(f"  {what}: {active} of {ref64.shape[0]} rows in contact; "
              f"the f64 read {e64 / scale:.3e} of scale {scale:.3e} from the "
              f"plain version (tol {READ_TOL[torch.float64]:g} + "
              f"{K1_F32_VS_F64:g} x the plain version's own jump "
              f"{jump / scale:.3e} under moves of q, v by "
              f"{READ_F64_JITTER:.1e} of themselves); the f32 "
              f"read {e_k:.3e} of scale from float64, the f32 plain version "
              f"{e_p:.3e} (tol {mult:g} x it + {floor:g})")
        if not e64 <= tol64:
            raise AssertionError(f"{what}: the f64 read is {e64:.3e} off "
                                 f"the plain version (tol {tol64:.3e})")
        if not e_k <= mult * e_p + floor:
            raise AssertionError(f"{what}: the f32 read is {e_k:.3e} of "
                                 f"scale off float64, the f32 plain version "
                                 f"{e_p:.3e}")
        return active

    @staticmethod
    def lane_kernels_loaded():
        """K1/K1T's and K2/K3's libraries loaded in this process (the
        child process that runs CHILD_PHASES loads neither unless one of
        their kernels was launched)."""
        from tactilesimulation_tpu_torch.ops import _build
        return sorted(set(_build._loaded) & {"lane_contact", "megastep"})

    def grasp(self, dev):
        """Slice 10: StableGrasp through the registry and the gym wrapper
        (the reset's 180-substep script from the shipped start pose, K4R
        once at its capture); then card against CPU on GRASP_SHORT."""
        from tactilesimulation_tpu_torch import envs
        from tactilesimulation_tpu_torch.envs import stable_grasp
        from tactilesimulation_tpu_torch.envs.gym_wrapper import GymEnv
        from tactilesimulation_tpu_torch.model import task_scenes
        from tactilesimulation_tpu_torch.ops import dense_contact
        from tactilesimulation_tpu_torch.sim import integrators
        env = envs.make("StableGrasp-v1", observation_type="tactile_map",
                        device=dev, dtype=torch.float32, seed=0)
        gym = GymEnv(env, seed=0)
        T = sum(stable_grasp.STAGE_STEPS)
        # probe: the script's first substep from the start pose
        q0 = env.q_init_ref
        u0 = env.script(q0, q0.new_zeros(()))[0]
        sim0 = integrators.initial_state(env.struct, env.model).replace(
            q=q0, q_prev=q0)
        substep = lambda: env._step_sim(env.model, sim0, u0)
        with torch.no_grad():
            substep()                  # the allocator's first use
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            substep()
            torch.cuda.synchronize()
        sub_s = time.perf_counter() - t0
        run_step = T * sub_s <= GRASP_BUDGET_S
        print(f"  probe: a substep {sub_s:.3f} s, so a {T}-substep script "
              f"about {T * sub_s:.1f} s: "
              + ("the reset's and one step's scripts run" if run_step else
                 f"past {GRASP_BUDGET_S:.0f} s, the reset's script runs and "
                 "the step's runs in (b) on GRASP_SHORT")
              + f" [{self.card}]")

        # (a) the main path
        dense_contact.reset_counts()
        t0 = time.perf_counter()
        obs = gym.reset()
        torch.cuda.synchronize()
        times = [time.perf_counter() - t0]
        if run_step:
            t0 = time.perf_counter()
            obs, reward, _, info = gym.step(np.array([GRASP_ACTION]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            print(f"  the step (action {GRASP_ACTION}): reward {reward:.4f}, "
                  f"success {bool(info['success'])}")
        reads, points = dense_contact.read_launches, dense_contact.launches
        lanes = self.lane_kernels_loaded()
        ex = gym._state.extras
        in_contact = int((ex.cap_field.abs().sum(dim=1) > 0).sum())
        print(f"  StableGrasp f32 through GymEnv: "
              + ", ".join(f"{name} script {t:.2f} s ({t / T * 1e3:.1f} ms a "
                          "substep)" for name, t in
                          zip(("the reset's", "the step's"), times))
              + f"; read kernel launches {reads} (want {len(times)}: one "
              f"per script), points entry {points}, K1-K3 libraries loaded "
              f"{lanes} (want none); {in_contact} rows in contact at the "
              f"capture [{self.card}]")
        if (reads, points) != (len(times), 0) or lanes:
            raise AssertionError("the scripts did not read through K4R as "
                                 "counted")
        if obs.shape != (4, 13, 10) or not np.isfinite(obs).all():
            raise AssertionError(f"obs {obs.shape}, finite "
                                 f"{np.isfinite(obs).all()}")
        if in_contact == 0:
            raise AssertionError("no marker row in contact at the capture")
        row = self.kernel_rows.setdefault("K4R", {})
        row["launches"] = row.get("launches", 0) + reads
        with torch.no_grad(), AtenCount() as count:
            substep()
        print(f"  eager aten ops per substep {count.n} [{self.card}]")
        self.device_share(substep, "one StableGrasp substep")
        _, m64 = task_scenes.stable_grasp()
        self.env_read_check("the capture's read", env.struct,
                            env._model_for(ex), m64.to(dev, torch.float64),
                            ex.cap_q, ex.cap_qdot, ex.cap_field)

        # (b) card against CPU
        self.grasp_cross(dev)

    def grasp_cross(self, dev):
        """Reset and one step on GRASP_SHORT from GRASP_DRAWS: the card
        (K4R) against the CPU (its plain version), float64 within
        ADJ_F64_TOL of scale, float32 held to the CPU float32 run's
        distance from float64."""
        from tactilesimulation_tpu_torch.envs import stable_grasp
        from tactilesimulation_tpu_torch.ops import dense_contact
        saved = stable_grasp.STAGE_STEPS, stable_grasp.CAPTURE_FRAME
        stable_grasp.STAGE_STEPS = list(GRASP_SHORT[0])
        stable_grasp.CAPTURE_FRAME = GRASP_SHORT[1]
        cpu = torch.device("cpu")
        runs, flags = {}, {}
        try:
            for where, dtype in ((dev, torch.float64), (cpu, torch.float64),
                                 (dev, torch.float32), (cpu, torch.float32)):
                env = stable_grasp.make(device=where, dtype=dtype)
                d = self.grasp_draws(where, dtype)
                env._draw = lambda what, B, d=d: d
                dense_contact.reset_counts()
                t0 = time.perf_counter()
                with torch.no_grad():
                    state, obs0 = env.reset()
                    state1, obs1, reward, done, _ = env.step(
                        state, torch.tensor([GRASP_ACTION], dtype=dtype,
                                            device=where))
                ex0, ex1 = state.extras, state1.extras
                out = {"densities": stable_grasp.densities(d)[0],
                       "reset q": ex0.current_q, "final q": ex1.current_q,
                       "reset capture": ex0.cap_field,
                       "step capture": ex1.cap_field, "reset obs": obs0,
                       "step obs": obs1, "reward": reward}
                label = "card" if where is dev else "cpu"
                runs[(label, dtype)] = {k: v.double().cpu()
                                        for k, v in out.items()}
                flags[(label, dtype)] = bool(done)
                reads = dense_contact.read_launches
                print(f"  {label} {dtype}: reset and one step on "
                      f"{GRASP_SHORT[0]} in {time.perf_counter() - t0:.2f} "
                      f"s, read kernel launches {reads}, success "
                      f"{bool(done)}")
                if reads != (2 if where.type == "cuda" else 0):
                    raise AssertionError(f"{label}: {reads} read launches "
                                         "for 2 captures")
        finally:
            stable_grasp.STAGE_STEPS, stable_grasp.CAPTURE_FRAME = saved
        self.compare_runs(runs, "StableGrasp", ADJ_F64_TOL)
        ref = runs[("cpu", torch.float64)]
        for k in ("reset capture", "step capture"):
            if not int((ref[k].abs().sum(dim=1) > 0).sum()) > 0:
                raise AssertionError(f"StableGrasp: no row in contact at the "
                                     f"{k}")
        if len(set(flags.values())) != 1:
            raise AssertionError(f"StableGrasp: success differs {flags}")

    @staticmethod
    def grasp_draws(where, dtype):
        """StableGrasp's "reset" draws (B = 1) from GRASP_DRAWS: a bar whose
        capture on GRASP_SHORT is in contact (on that schedule the pads
        hold some bars only before or after substep GRASP_SHORT[1])."""
        from tactilesimulation_tpu_torch.envs import stable_grasp
        rng = np.random.RandomState(GRASP_DRAWS)
        nb = stable_grasp.NUM_BLOCKS
        com_y = rng.uniform(1.0, nb - 1.0)
        left, right = np.floor(com_y), nb - 1 - np.floor(com_y)
        draws = {"com_y": [com_y], "mid": [rng.uniform(600.0, 700.0)],
                 "right": [rng.uniform(600.0 * right, 700.0 * right)],
                 "left": [rng.uniform(600.0 * left, 700.0 * left)],
                 "ratios": [rng.uniform(0.0, 1.0, nb)]}
        return {k: torch.tensor(np.asarray(v), dtype=dtype, device=where)
                for k, v in draws.items()}

    def compare_runs(self, runs, what, tol64):
        """{(card|cpu, dtype): {name: float64 CPU tensor}}: card float64
        within ``tol64`` of the CPU's scale, card float32 within
        ROLL_F32_VS_F64 of the CPU float32 run's distance from float64."""
        ref = runs[("cpu", torch.float64)]
        mult, floor = ROLL_F32_VS_F64
        bad = []
        for k, w in ref.items():
            e64 = max_rel({k: runs[("card", torch.float64)][k]}, {k: w})[k]
            e_card = max_rel({k: runs[("card", torch.float32)][k]},
                             {k: w})[k]
            e_cpu = max_rel({k: runs[("cpu", torch.float32)][k]}, {k: w})[k]
            print(f"  {k:15s} card f64 vs cpu f64 {e64:.3e} (tol "
                  f"{tol64:g}); f32 vs cpu f64: card {e_card:.3e}, cpu "
                  f"{e_cpu:.3e} (tol {mult:g} x cpu + {floor:g})")
            if not e64 <= tol64:
                bad.append(f"{k} f64")
            if not e_card <= mult * e_cpu + floor:
                bad.append(f"{k} f32")
        if bad:
            raise AssertionError(f"{what}, card vs CPU: {bad}")

    @staticmethod
    def dclaw_draws(spec, where, dtype):
        """A DClaw "reset" draw (B = 1) from ``spec``."""
        return {k: torch.tensor([spec[k]], dtype=dtype, device=where)
                for k in ("noise", "damping", "radius", "dxy")}

    def dclaw(self, dev):
        """Slice 10: DClaw through the registry and the gym wrapper, every
        observation read by K4R; then card against CPU."""
        from tactilesimulation_tpu_torch import envs
        from tactilesimulation_tpu_torch.envs import dclaw_rotate
        from tactilesimulation_tpu_torch.envs.gym_wrapper import GymEnv
        from tactilesimulation_tpu_torch.ops import (dense_contact,
                                                    tactile_query)
        env = envs.make("TactileRotation-v1", observation_type="tactile",
                        device=dev, dtype=torch.float32, seed=0)
        gym = GymEnv(env, seed=0)
        rng = np.random.RandomState(0)
        contact = self.dclaw_draws(DCLAW_CONTACT, dev, torch.float32)

        # (a) the main path
        dense_contact.reset_counts()
        t0 = time.perf_counter()
        obs = [gym.reset()]
        torch.cuda.synchronize()
        reset_s, step_s, dones = [time.perf_counter() - t0], [], 0
        for _ in range(DCLAW_STEPS):
            t0 = time.perf_counter()
            o, _, done, _ = gym.step(rng.uniform(-1.0, 1.0, env.ndof_u))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            obs.append(o)
            if done:
                dones += 1
                t0 = time.perf_counter()
                obs.append(gym.reset())
                torch.cuda.synchronize()
                reset_s.append(time.perf_counter() - t0)
        # the recorded contact state: the cap's rim under every fingertip
        env._draw = lambda what, B: contact
        try:
            obs.append(gym.reset())
        finally:
            del env._draw
        torch.cuda.synchronize()
        reads, points = dense_contact.read_launches, dense_contact.launches
        lanes = self.lane_kernels_loaded()
        size = 18 + 3 * dclaw_rotate.ROWS * dclaw_rotate.COLS * 3
        print(f"  TactileRotation f32 through GymEnv: {DCLAW_STEPS} steps "
              f"in {sum(step_s):.2f} s ({DCLAW_STEPS / sum(step_s):.4f} env "
              f"steps/s, {sum(step_s) / DCLAW_STEPS * 1e3:.1f} ms a step of "
              f"{env.frame_skip} substeps), {len(reset_s)} resets "
              f"({dones} on done) {np.mean(reset_s) * 1e3:.1f} ms each; read "
              f"kernel launches {reads} (want {len(obs)}: one per "
              f"observation), points entry {points}, K1-K3 libraries "
              f"loaded {lanes} (want none) [{self.card}]")
        if (reads, points) != (len(obs), 0) or lanes:
            raise AssertionError("the observations did not read through "
                                 "K4R as counted")
        if not all(o.shape == (size,) and np.isfinite(o).all()
                   for o in obs):
            raise AssertionError("an observation is not finite or not of "
                                 f"shape ({size},)")
        if not np.abs(obs[-1][18:]).max() > 0:
            raise AssertionError("no fingertip touches the cap at the "
                                 "recorded contact state")
        row = self.kernel_rows.setdefault("K4R", {})
        row["launches"] = row.get("launches", 0) + reads
        state = gym._state
        model = env._model_for(state.extras)
        q = state.sim.q
        target = env.target(q, torch.zeros(9, dtype=q.dtype, device=dev))
        substep = lambda: env._step_sim(model, state.sim, target)
        with torch.no_grad():
            substep()
            with AtenCount() as count:
                substep()
        print(f"  eager aten ops per substep {count.n} [{self.card}]")
        self.device_share(substep, "one DClaw substep")
        e64 = dclaw_rotate.make(device=dev, dtype=torch.float64)
        e64._draw = lambda what, B: self.dclaw_draws(DCLAW_CONTACT, dev,
                                                     torch.float64)
        with torch.no_grad():
            s64, _ = e64.reset()
            got = tactile_query.tactile_field(env.struct, model, q,
                                              torch.zeros_like(q))
        again = env._get_obs(model, q, env._images(got)).cpu().numpy()
        if not np.abs(again - obs[-1]).max() <= 1e-6 * np.abs(again).max():
            raise AssertionError("the contact observation is not its read")
        self.env_read_check("the contact state's read", env.struct, model,
                            e64._model_for(s64.extras), q,
                            torch.zeros_like(q), got)

        # (b) card against CPU
        self.dclaw_cross(dev)

    def dclaw_cross(self, dev):
        """From DCLAW_CONTACT, a reset and the steps DCLAW_CROSS_US: the
        card against the CPU (float64 within ADJ_F64_TOL of scale, float32
        held to the CPU float32 run's distance from float64); then resets
        with the radii DCLAW_RADII on the card, float64: each read equal
        to the plain version on its own Model, through a plan of its
        own."""
        from tactilesimulation_tpu_torch.envs import dclaw_rotate
        from tactilesimulation_tpu_torch.ops import (dense_contact,
                                                    tactile_query)
        cpu = torch.device("cpu")
        runs, flags = {}, {}
        for where, dtype in ((dev, torch.float64), (cpu, torch.float64),
                             (dev, torch.float32), (cpu, torch.float32)):
            env = dclaw_rotate.make("tactile", device=where, dtype=dtype)
            d = self.dclaw_draws(DCLAW_CONTACT, where, dtype)
            env._draw = lambda what, B, d=d: d
            dense_contact.reset_counts()
            t0 = time.perf_counter()
            out, rewards, fl = {}, [], []
            with torch.no_grad():
                state, out["obs 0"] = env.reset()
                for i, u in enumerate(DCLAW_CROSS_US):
                    state, out[f"obs {i + 1}"], r, done, info = env.step(
                        state, torch.tensor(u, dtype=dtype, device=where))
                    rewards.append(r)
                    fl.append((bool(done), bool(info["success"])))
            out.update(q=state.sim.q, qdot=state.sim.qdot,
                       reward=torch.stack(rewards))
            label = "card" if where is dev else "cpu"
            runs[(label, dtype)] = {k: v.double().cpu()
                                    for k, v in out.items()}
            flags[(label, dtype)] = tuple(fl)
            reads = dense_contact.read_launches
            n = 1 + len(DCLAW_CROSS_US)
            print(f"  {label} {dtype}: reset + {n - 1} steps in "
                  f"{time.perf_counter() - t0:.2f} s, read kernel launches "
                  f"{reads}, (done, success) {fl}")
            if reads != (n if where.type == "cuda" else 0):
                raise AssertionError(f"{label}: {reads} read launches for "
                                     f"{n} reads")
        self.compare_runs(runs, "DClaw", ADJ_F64_TOL)
        if not float(runs[("cpu", torch.float64)]["obs 0"][18:].abs()
                     .max()) > 0:
            raise AssertionError("DClaw: the fingertips miss the cap")
        if len(set(flags.values())) != 1:
            raise AssertionError(f"DClaw: flags differ {flags}")

        env = dclaw_rotate.make("tactile", device=dev, dtype=torch.float64)
        plans = []
        for radius in DCLAW_RADII:
            env._draw = lambda what, B, r=radius: self.dclaw_draws(
                dict(DCLAW_CONTACT, radius=r), dev, torch.float64)
            dense_contact.reset_counts()
            with torch.no_grad():
                state, _ = env.reset()
            reads = dense_contact.read_launches
            model = env._model_for(state.extras)
            q = state.sim.q
            want = tactile_query.tactile_field_ref(env.struct, model, q,
                                                   torch.zeros_like(q))
            err = float((state.extras.tactile_imgs
                         - env._images(want)).abs().max())
            scale = float(want.abs().max())
            plans.append(tactile_query.read_plan(env.struct, model))
            print(f"  reset with the cap's radius {radius}: "
                  f"{int((want.abs().sum(dim=1) > 0).sum())} rows in "
                  f"contact, the images {err:.3e} from the plain version's "
                  f"(scale {scale:.3e}), read launches {reads}")
            if reads != 1 or not err <= READ_TOL[torch.float64] * scale:
                raise AssertionError(f"radius {radius}: the read is {err:.3e}"
                                     f" off the plain version, {reads} "
                                     "launches")
        if plans[0] is plans[1]:
            raise AssertionError("two caps read through one plan")

    def _card_vs_cpu(self, runs, what):
        """Card float64 within ADJ_F64_TOL of the CPU's; card float32 within
        ROLL_F32_VS_F64 of the CPU float32 run's distance from float64."""
        ref = runs[("cpu", torch.float64)]
        if not all(float(w.abs().max()) > 0 for w in ref.values()):
            raise AssertionError(f"{what}: a zero gradient on the CPU")
        e64 = max_rel(runs[("cuda", torch.float64)], ref)
        for k, err in e64.items():
            print(f"  {what} card float64 vs cpu float64 {k:28s} rel "
                  f"{err:.3e} (tol {ADJ_F64_TOL:g})")
        bad = [k for k, err in e64.items() if not err <= ADJ_F64_TOL]
        if ("cuda", torch.float32) in runs:
            mult, floor = ROLL_F32_VS_F64
            e_card = max_rel(runs[("cuda", torch.float32)], ref)
            e_cpu = max_rel(runs[("cpu", torch.float32)], ref)
            for k in ref:
                print(f"  {what} float32 vs cpu float64 {k:28s} rel: card "
                      f"{e_card[k]:.3e}, cpu {e_cpu[k]:.3e} (tol {mult:g} x "
                      f"cpu + {floor:g})")
                if not e_card[k] <= mult * e_cpu[k] + floor:
                    bad.append(f"{k} (float32)")
        if bad:
            raise AssertionError(f"{what}, card vs CPU: {bad}")


class Child:
    """CHILD_PHASES in a second process (``chip_smoke.py --child OUT
    PHASE...``), its output kept in a temporary file until ``join``."""

    def __init__(self, phases):
        fd, self.out = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self.log = tempfile.TemporaryFile(mode="w+")
        here = os.path.abspath(__file__)
        self.proc = subprocess.Popen(
            [sys.executable, "-u", here, "--child", self.out, *phases],
            stdout=self.log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(here))

    def join(self, smoke, timeout):
        """Wait for the child, print its output, take its failed phases
        and its launch counts into ``smoke``."""
        try:
            rc = self.proc.wait(timeout=timeout)
            with open(self.out) as fp:
                res = json.load(fp)
        finally:
            self.stop()
            self.log.seek(0)
            print(self.log.read(), end="", flush=True)
            self.log.close()
            os.remove(self.out)
        smoke.failed.extend(res["failed"])
        for key, n in res["launches"].items():
            row = smoke.kernel_rows.setdefault(key, {})
            row["launches"] = row.get("launches", 0) + n
        if rc != 0 and not res["failed"]:
            raise RuntimeError(f"the child process exited with {rc}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def child_main(dev, out, phases) -> int:
    """Run ``phases`` and write {"failed": [...], "launches": {key: n}} to
    ``out``."""
    s = Smoke()
    s.phase("device", s.device)
    if not s.failed:
        for name in phases:
            s.phase(name, getattr(s, name), dev)
    launches = {k: r["launches"] for k, r in s.kernel_rows.items()
                if "launches" in r}
    with open(out, "w") as fp:
        json.dump({"failed": s.failed, "launches": launches}, fp)
    return 1 if s.failed else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import tactilesimulation_tpu_torch  # noqa: F401  (fails outside the repo)
    dev = torch.device("cuda", 0)
    if argv[:1] == ["--child"]:
        return child_main(dev, argv[1], argv[2:])
    t0 = time.perf_counter()
    s = Smoke()
    s.phase("device", s.device)
    if s.failed:
        return 1
    s.phase("build", s.build)
    if not s.failed:
        s.phase("kernels", s.kernels, dev)
        # the env phases beside the rest (after the kernels' timings)
        child = Child(CHILD_PHASES)
        try:
            s.phase("slice", s.slice, dev)
            s.phase("train", s.train, dev)
            s.phase("cross", s.cross, dev)
            s.phase("rolling", s.rolling, dev)
            s.phase("adjoint", s.adjoint, dev)
            s.phase("ppo", s.ppo, dev)
            s.phase("insertion", s.insertion, dev)
            print(f"== waiting for {', '.join(CHILD_PHASES)} (started after "
                  "kernels, in a second process)", flush=True)
            s.phase("child", child.join, s,
                    max(30.0, CHILD_DEADLINE_S - (time.perf_counter() - t0)))
        finally:
            child.stop()
    print(f"total {time.perf_counter() - t0:.1f} s")
    if s.failed:
        print(f"FAILED phases: {s.failed}")
        return 1
    rows = []
    for k in KERNELS:
        r = s.kernel_rows[k["key"]]
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
