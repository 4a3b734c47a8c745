"""The port's shipped StableGrasp start pose against the JAX package's
settle, float64 on the CPU.

- the shipped start poses (``envs/data/stable_grasp_q_init.json``, written
  by ``python -m tactilesimulation_tpu_torch.envs.stable_grasp``): the
  float64 model's against the JAX env's own ``q_init_ref`` (its 500-substep
  settle, one jitted scan in its constructor) within 1e-8 of scale; the
  float32 model's within 1e-4 of scale of it (over 500 substeps float32
  lets the bar drift 5 micrometres along x on its tables: 2.6e-5 of
  scale from float64 when the file was made);
- the whole settle of the port against the shipped file (marked ``slow``:
  about 8 minutes on one CPU core).
"""

import json

import numpy as np
import pytest
import torch

from tactilesimulation_tpu.envs import stable_grasp as jsg
from tactilesimulation_tpu_torch.envs import stable_grasp as tsg
from tactilesimulation_tpu_torch.envs import start_pose
from tactilesimulation_tpu_torch.model import task_scenes

torch.set_num_threads(1)

F64 = torch.float64


def scale_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


def shipped():
    """{dtype name: q_init} of the bundled scene's models."""
    _, model = task_scenes.stable_grasp()
    with open(tsg.Q_INIT_FILE) as fp:
        entries = json.load(fp)
    out = {}
    for dtype in (torch.float64, torch.float32):
        entry = entries[start_pose.model_key(model.to("cpu", dtype))]
        out[entry["dtype"]] = np.array(entry["q_init"])
    return out


def test_shipped_q_init_matches_jax():
    want = np.asarray(jsg.make("tactile_map").q_init_ref)
    q = shipped()
    assert scale_err(q["float64"], want) <= 1e-8
    assert scale_err(q["float32"], want) <= 1e-4
    # the bar rests level on its tables, the fingers open
    assert np.linalg.norm(q["float64"][9:12]) < 1e-6
    np.testing.assert_allclose(q["float64"][4:6], -0.03, atol=1e-6)


@pytest.mark.slow
def test_full_settle_matches_shipped():
    struct, model = task_scenes.stable_grasp()
    got = tsg.settle(struct, model.to("cpu", F64))
    assert scale_err(got, shipped()["float64"]) <= 1e-10
