"""Scenes from redmax XML files through the port's entry points, float64 on
the CPU.

- ``make(scene_path=)`` of TactilePush, TactileInsertion, StableGrasp and
  DClaw against the JAX env made from the same file (written by
  ``chip_smoke.write_scene_xml``): ``Structure`` and ``Model`` equal, bit
  for bit, without stepping JAX (its constructors' settles are stubbed).
  The first three files transcribe the bundled scenes; DClaw's cannot (its
  fingertips' explicit points and body-frame markers,
  ``test_torch_xml_parser.py``), so its file gives the fingertips the
  cylinder's face points and abstract sensors.
- A file that transcribes its bundled scene gives the bundled scene's
  ``Structure`` and ``Model``; one TactilePush env step from the file is
  bit-equal to the bundled scene's; the lane twins take the files
  (``lane_env()``, ``TactileInsertionLanes``) and ``ops.megastep.supported``
  takes the TactilePush file as it takes the bundled scene.
- ``Simulation(path)`` at RollingBall 8 x 8: 3 steps bit-equal to
  ``Simulation((struct, model))``.
- The RollingBall CLI's ``--scene`` at 8 x 8, 10 steps: bit-equal to the
  bundled scene's run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import tree_diff, write_scene_xml
from tactilesimulation_tpu.envs import dclaw_rotate as jdc
from tactilesimulation_tpu.envs import stable_grasp as jsg
from tactilesimulation_tpu.envs import tactile_insertion as jti
from tactilesimulation_tpu.envs import tactile_push as jtp
from tactilesimulation_tpu_torch.envs import (dclaw_rotate, stable_grasp,
                                              tactile_insertion,
                                              tactile_insertion_lanes,
                                              tactile_push)
from tactilesimulation_tpu_torch.examples import rolling_ball_speed
from tactilesimulation_tpu_torch.model import task_scenes
from tactilesimulation_tpu_torch.ops import megastep
from tactilesimulation_tpu_torch.sim.simulation import Simulation

torch.set_num_threads(1)

F64 = torch.float64


def dclaw_spec():
    """The bundled DClaw with what the schema holds: each fingertip's
    points from the cylinder's faces (8 x 2), its markers as an abstract
    sensor."""
    spec = task_scenes.dclaw(spec_only=True)
    for t in spec.tactiles:
        body = spec.bodies[t.body]
        body.contact_points = None
        body.contact_angle_resolution, body.contact_radius_resolution = 8, 2
    return spec


ENVS = {
    "tactile_push": (task_scenes.tactile_push, tactile_push.make,
                     jtp.make),
    "tactile_insertion": (task_scenes.tactile_insertion,
                          tactile_insertion.make, jti.make),
    "stable_grasp": (task_scenes.stable_grasp, stable_grasp.make,
                     jsg.make),
    "dclaw": (None, dclaw_rotate.make, jdc.make),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    where = tmp_path_factory.mktemp("scenes")
    out = {}
    for name, (bundled, _, _) in ENVS.items():
        path = str(where / f"{name}.xml")
        if bundled is None:
            assert write_scene_xml(dclaw_spec(), path, exact=False)
        else:
            assert write_scene_xml(bundled(spec_only=True), path) == []
        out[name] = path
    path = str(where / "rolling_ball_8.xml")
    write_scene_xml(task_scenes.rolling_ball(8, spec_only=True), path)
    out["rolling_ball_8"] = path
    return out


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_from_file_matches_jax(name, files, monkeypatch):
    bundled, make_t, make_j = ENVS[name]
    monkeypatch.setattr(jsg.StableGraspEnv, "_generate_initial_state",
                        lambda self: (jnp.zeros(self.struct.ndof_q),) * 2)
    monkeypatch.setattr(jti.TactileInsertionEnv, "_generate_initial_pose",
                        lambda self: jnp.zeros(self.struct.ndof_q))
    env_t = make_t(device="cpu", dtype=F64, scene_path=files[name])
    env_j = make_j(scene_path=files[name])
    assert tree_diff(env_t.struct, env_j.struct, "Structure") == []
    assert tree_diff(env_t.model, env_j.model, "Model") == []
    if bundled is not None:
        ref = make_t(device="cpu", dtype=F64)
        assert tree_diff(env_t.struct, ref.struct, "Structure") == []
        assert tree_diff(env_t.model, ref.model, "Model") == []


def test_lane_twins_take_the_files(files):
    push = tactile_push.make(device="cpu", dtype=F64,
                             scene_path=files["tactile_push"])
    ref = tactile_push.make(device="cpu", dtype=F64)
    assert megastep.supported(push.struct, push.model)
    assert megastep.supported(ref.struct, ref.model)
    lane = push.lane_env()
    assert lane.struct is push.struct and lane.ndof_u == ref.ndof_u
    ins = tactile_insertion_lanes.make(
        device="cpu", dtype=F64, scene_path=files["tactile_insertion"])
    assert tree_diff(ins.model, tactile_insertion.make(
        device="cpu", dtype=F64).model) == []


def test_push_step_from_file_equals_bundled(files):
    runs = []
    for path in (files["tactile_push"], None):
        env = tactile_push.make(device="cpu", dtype=F64, seed=3,
                                scene_path=path)
        with torch.no_grad():
            state, obs0 = env.reset()
            state, obs, reward, _, _ = env.step(
                state, torch.tensor([0.4, -0.2, 0.1], dtype=F64))
        runs.append((obs0, obs, reward, state.sim.q, state.sim.qdot))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_simulation_from_file_equals_bundled(files):
    runs = []
    for src in (files["rolling_ball_8"], task_scenes.rolling_ball(8)):
        sim = Simulation(src, device="cpu")
        sim.reset()
        sim.set_u([0.0, 0.0, 0.2])
        out = []
        for _ in range(3):
            sim.forward(1)
            out += [sim.get_q(), sim.get_qdot(),
                    sim.get_tactile_force_vector()]
        runs.append(out)
    assert all(np.array_equal(a, b) for a, b in zip(*runs))
    assert sim.model.dtype == F64


def test_cli_scene_equals_bundled(files):
    args = ["--cpu", "--steps", "10"]
    got, _ = rolling_ball_speed.main(args + ["--scene",
                                             files["rolling_ball_8"]])
    want, _ = rolling_ball_speed.main(args + ["--resolution", "8"])
    assert torch.equal(got[0].q, want[0].q)
    assert torch.equal(got[0].qdot, want[0].qdot)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
