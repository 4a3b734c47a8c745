"""The dense tactile field query: the tactile read kernel on the card.

Port of ``tactilesimulation_tpu/ops/tactile_query.py``. The query needs the
marker forces only, not the generalized contact force, so it skips the
wrench and J^T f machinery of the step. It gives what
``dynamics.tactile_field`` gives: each marker row's forces summed over the
tactile pairs that hold it, in pair order, projected onto the row's
sensor axes. (The JAX query writes each pair's forces into its rows, so
there the last pair wins where two pairs share rows, as on StableGrasp's
pads; the port sums, as the step does.)

Routes, for one state (n,) or a batch (B, n):
- CUDA tensors: ``dense_contact.tactile_read``, the whole read in one
  launch (a batch too), from a ``ReadPlan`` made once per (struct, model)
  and made again when a model leaf it packed changes; the plan takes
  shared scene leaves only;
- CPU tensors: the plain PyTorch version ``tactile_field_ref``: FK and the
  joints' world twists (``dynamics.twists``, the JVP of FK written as plain
  ops) give the markers' world positions and velocities and the bodies'
  poses and velocities; each tactile pair is one
  ``dense_contact.dense_point_contact_ref``; the forces are summed per row
  and projected onto the sensor axes, each instance of a batch on its own.
  It is also the card's comparison.

Used by ``Simulator.tactile`` (the facade's ``get_tactile_force_vector``),
the strided rollout's ``fast_tactile`` query and the TactilePush env's
observation, each where ``may_read`` allows it. Forward only.
"""

from __future__ import annotations

import torch

from ..model.schema import GEOM_CUBOID, GEOM_CYLINDER, GEOM_SPHERE
from ..sim import dynamics, kinematics, spatial
from ..sim.contact import GROUND
from . import dense_contact

_PLANS = {}
_MAX_PLANS = 16


def supported(struct) -> bool:
    """True if every tactile pair is point-vs-{ground, primitive}."""
    ok = (GEOM_CUBOID, GEOM_CYLINDER, GEOM_SPHERE)
    for pair in struct.tactile_pairs:
        if pair.general_is_sphere:
            return False
        if pair.primitive_body >= 0 and \
                struct.body_gtype[pair.primitive_body] not in ok:
            return False
    return len(struct.tactile_pairs) > 0


def may_read(struct, model, *xs) -> bool:
    """True if the read may serve the field: every tactile pair is
    point-vs-primitive (``supported``) and no gradient could flow into the
    state ``xs`` or a model leaf, since the read has no backward. It then
    launches the read kernel on CUDA tensors and runs its plain version on
    the CPU."""
    return supported(struct) and not dynamics.outer_graph(model, *xs)


def read_plan(struct, model):
    """The read kernel's ``ReadPlan`` of (struct, model), made again when
    one of the model leaves it packed was replaced or edited in place.
    Models that share those leaves share the plan (an episode's Model that
    edits only masses reads with the plan of the one it was made from)."""
    key = (id(struct),) + tuple(id(getattr(model, k))
                                for k in dense_contact.READ_LEAVES)
    plan = _PLANS.get(key)
    if plan is None or plan.struct is not struct or not plan.fresh(model):
        plan = dense_contact.ReadPlan(struct, model)
        _PLANS.pop(key, None)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = plan
    return plan


def tactile_field(struct, model, q, v):
    """(..., Mtot, 3) sensor-frame [shear0, shear1, normal] marker forces at
    q, v (..., n); the query's counterpart of ``dynamics.tactile_field``."""
    if len(struct.tac_joint) == 0:
        return q.new_zeros(q.shape[:-1] + (0, 3))
    if q.is_cuda:
        return dense_contact.tactile_read(read_plan(struct, model), q, v)
    if q.device.type != "cpu":
        raise ValueError(f"tactile_field: no route for {q.device}")
    return tactile_field_ref(struct, model, q, v)


def tactile_field_ref(struct, model, q, v):
    """The plain PyTorch version of the read, on any device, at q, v
    (..., n): each instance on its own, with shared or per-instance Model
    leaves."""
    ntac = len(struct.tac_joint)
    if ntac == 0:
        return q.new_zeros(q.shape[:-1] + (0, 3))
    tb = kinematics._tables(struct, q)
    with torch.no_grad():
        jp, jq, Om, be = dynamics.twists(struct, model, q, v)
        tj, bj = tb.tac_joint, tb.body_joint
        tq = jq[..., tj, :]
        x = spatial.transform_apply(jp[..., tj, :], tq, model.tac_pos)
        xd = spatial.cross(Om[..., tj, :], x) + be[..., tj, :]
        bp, bquat = spatial.transform_compose(jp[..., bj, :], jq[..., bj, :],
                                              model.body_pos, model.body_quat)
        bw = Om[..., bj, :]
        bv = spatial.cross(bw, bp) + be[..., bj, :]
        bR = spatial.quat_to_mat(bquat)
        ground = (model.ground_pos, model.ground_normal)
        tac_force = q.new_zeros(x.shape)
        for pair in struct.tactile_pairs:
            sl = slice(pair.point_start, pair.point_start + pair.point_count)
            k = pair.param_index
            params = torch.stack([model.tac_kn[..., k], model.tac_kt[..., k],
                                  model.tac_mu[..., k],
                                  model.tac_damping[..., k]], dim=-1)
            if pair.primitive_body < 0:
                zero3 = q.new_zeros(3)
                gtype, pose, vel = GROUND, (zero3, tb.eye3), (zero3, zero3)
                size = q.new_ones(3)
            else:
                b = pair.primitive_body
                gtype = struct.body_gtype[b]
                pose, vel = (bp[..., b, :], bR[..., b, :, :]), \
                    (bv[..., b, :], bw[..., b, :])
                size = model.body_size[..., b, :]
            # the pairs that share a row add, in pair order (the step's
            # index_add in dynamics.contact_terms)
            tac_force[..., sl, :] += dense_contact.dense_point_contact_ref(
                gtype, x[..., sl, :], xd[..., sl, :], pose, vel, size,
                params, ground)

        # project onto the per-marker sensor axes (owner joint frame axes)
        n_w = spatial.quat_rotate(tq, model.tac_normal)
        a0_w = spatial.quat_rotate(tq, model.tac_axis0)
        a1_w = spatial.quat_rotate(tq, model.tac_axis1)
        return torch.stack([torch.sum(tac_force * a0_w, dim=-1),
                            torch.sum(tac_force * a1_w, dim=-1),
                            torch.sum(tac_force * n_w, dim=-1)], dim=-1)
