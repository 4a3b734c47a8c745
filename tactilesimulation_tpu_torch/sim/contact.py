"""Contact instance groups and the combined contact-parameter table.

Mirrors the host-side part of ``tactilesimulation_tpu/sim/contact.py``: all
declared contact pairs and tactile sensors are flattened at build time into
instance groups bucketed by primitive geometry (ground / cuboid / cylinder /
sphere). The force law itself lives in ``sim/lanes.py`` (``_penalty_force``)
and in the pair-wrench kernel (``ops/lane_contact.py``):

    p      = max(0, -phi)                      penetration depth
    pdot   = max(0, -d(phi)/dt)                penetration rate
    f_n    = (kn * p + damping * p * pdot) n   nonlinear Kelvin-Voigt normal
    f_t    = -kt * v_t * mu|f_n| / max(mu|f_n|, kt|v_t| + eps)
"""

from __future__ import annotations

import dataclasses
import types
from typing import Tuple

import numpy as np
import torch

from . import spatial
from ..model.schema import GEOM_CUBOID, GEOM_CYLINDER, GEOM_SPHERE

# contact-law epsilon; distinct from ``lanes._EPS`` (1e-12), and both are used
_EPS = 1e-9
GROUND = -1


@dataclasses.dataclass(frozen=True, eq=False)
class ContactGroup:
    """A batch of contact instances sharing one primitive geometry type.

    ``point_idx`` indexes the combined world-point array [contact points;
    tactile markers]; ``sphere_general`` marks groups whose "points" are
    sphere body centers (analytic sphere contact)."""
    gtype: int                       # GROUND or GEOM_* of the primitive side
    point_idx: np.ndarray            # (Ni,) into combined points, or body idx
    general_body: np.ndarray         # (Ni,)
    prim_body: np.ndarray            # (Ni,) (ignored for GROUND)
    param_idx: np.ndarray            # (Ni,) into combined [pair; tactile] params
    tac_row: np.ndarray              # (Ni,) marker row or -1
    sphere_general: bool = False


def combined_params(model) -> torch.Tensor:
    """(K+S, 4) rows of [kn, kt, mu, damping]: declared pairs then sensors.

    Leaves may carry a trailing per-lane batch axis ((K, B) / (S, B)); the
    result is then (K+S, 4, B)."""
    ax = 1 if model.pair_kn.ndim == 2 else -1
    pair = torch.stack(
        [model.pair_kn, model.pair_kt, model.pair_mu, model.pair_damping],
        dim=ax)
    tac = torch.stack(
        [model.tac_kn, model.tac_kt, model.tac_mu, model.tac_damping], dim=ax)
    return torch.cat([pair, tac], dim=0)


def param_rows(model) -> torch.Tensor:
    """(..., K+S, 4) rows of [kn, kt, mu, damping], declared pairs then
    sensors, for the row-major core: leaves shared or with the same leading
    batch axes (``combined_params`` takes the lanes' trailing lane axis)."""
    pair = torch.stack(torch.broadcast_tensors(
        model.pair_kn, model.pair_kt, model.pair_mu, model.pair_damping),
        dim=-1)
    tac = torch.stack(torch.broadcast_tensors(
        model.tac_kn, model.tac_kt, model.tac_mu, model.tac_damping), dim=-1)
    batch = torch.broadcast_shapes(pair.shape[:-2], tac.shape[:-2])
    return torch.cat([pair.expand(batch + pair.shape[-2:]),
                      tac.expand(batch + tac.shape[-2:])], dim=-2)


def build_groups(struct) -> Tuple[ContactGroup, ...]:
    """Flatten struct.pairs + struct.tactile_pairs into instance groups,
    bucketed by primitive geometry. Called by ``model/builder.py``."""
    ncp = len(struct.cp_joint)
    nparams = len(struct.pairs)
    buckets = {}

    def add(gtype, sphere_general, point_idx, general_body, prim_body,
            param_idx, tac_row):
        b = buckets.setdefault((gtype, sphere_general), [[], [], [], [], []])
        n = len(point_idx)
        b[0].append(np.asarray(point_idx))
        b[1].append(np.full(n, general_body))
        b[2].append(np.full(n, prim_body))
        b[3].append(np.full(n, param_idx))
        b[4].append(np.asarray(tac_row))

    def pair_gtype(pair):
        return (GROUND if pair.primitive_body < 0
                else struct.body_gtype[pair.primitive_body])

    for pair in struct.pairs:
        g = pair_gtype(pair)
        if pair.general_is_sphere:
            add(g, True, [pair.general_body], pair.general_body,
                max(pair.primitive_body, 0), pair.param_index, [-1])
        else:
            idx = np.arange(pair.point_start,
                            pair.point_start + pair.point_count)
            add(g, False, idx, pair.general_body,
                max(pair.primitive_body, 0), pair.param_index,
                np.full(pair.point_count, -1))
    for pair in struct.tactile_pairs:
        g = pair_gtype(pair)
        # tactile markers live after contact points in the combined array
        rows = np.arange(pair.point_start, pair.point_start + pair.point_count)
        add(g, False, ncp + rows, pair.general_body,
            max(pair.primitive_body, 0), nparams + pair.param_index, rows)

    groups = []
    for (gtype, sphere_general), b in sorted(buckets.items(),
                                             key=lambda kv: kv[0]):
        groups.append(ContactGroup(
            gtype=gtype,
            point_idx=np.concatenate(b[0]).astype(np.int32),
            general_body=np.concatenate(b[1]).astype(np.int32),
            prim_body=np.concatenate(b[2]).astype(np.int32),
            param_idx=np.concatenate(b[3]).astype(np.int32),
            tac_row=np.concatenate(b[4]).astype(np.int32),
            sphere_general=sphere_general,
        ))
    return tuple(groups)


# ---------------------------------------------------------------------------
# row-major force law of one instance or a batch (points (..., Ni, 3)), as
# the JAX package's sim/contact.py; the lane-major twins live in
# sim/lanes.py
# ---------------------------------------------------------------------------

def _relu(x):
    """max(x, 0) that splits the gradient at a tie, as ``jnp.maximum``."""
    return torch.maximum(x, x.new_zeros(()))


def _sdf_box(xl, half):
    d = torch.abs(xl) - half
    dmax = torch.amax(d, dim=-1, keepdim=True)
    outside = _relu(d)
    out_norm = torch.sqrt(torch.sum(outside ** 2, dim=-1, keepdim=True)
                          + _EPS ** 2)
    phi = torch.where(dmax[..., 0] > 0, out_norm[..., 0], dmax[..., 0])
    g_out = outside / out_norm * torch.sign(xl)
    inside_axis = (d == dmax).to(xl.dtype)
    inside_axis = inside_axis / torch.sum(inside_axis, dim=-1, keepdim=True)
    g_in = inside_axis * torch.sign(xl)
    return phi, torch.where(dmax > 0, g_out, g_in)


def _sdf_cylinder(xl, radius, half_len):
    r2 = torch.sqrt(xl[..., 0] ** 2 + xl[..., 1] ** 2 + _EPS ** 2)
    dr = r2 - radius
    dz = torch.abs(xl[..., 2]) - half_len
    d = torch.stack([dr, dz], dim=-1)
    dmax = torch.amax(d, dim=-1)
    outside = _relu(d)
    out_norm = torch.sqrt(torch.sum(outside ** 2, dim=-1) + _EPS ** 2)
    phi = torch.where(dmax > 0, out_norm, dmax)
    g2_out = outside / out_norm[..., None]
    pick_r = (dr >= dz).to(xl.dtype)
    g2_in = torch.stack([pick_r, 1.0 - pick_r], dim=-1)
    g2 = torch.where(dmax[..., None] > 0, g2_out, g2_in)
    radial = torch.stack([xl[..., 0] / r2, xl[..., 1] / r2], dim=-1)
    return phi, torch.cat([g2[..., 0:1] * radial,
                           (g2[..., 1] * torch.sign(xl[..., 2]))[..., None]],
                          dim=-1)


def _sdf_sphere(xl, radius):
    r = torch.sqrt(torch.sum(xl ** 2, dim=-1) + _EPS ** 2)
    return r - radius, xl / r[..., None]


def group_sdf(group: ContactGroup, model, x, body_p, body_R, prim_body=None):
    """SDF value and world outward normal of the group's primitives at x
    (..., Ni, 3). ``prim_body`` is the group's primitive index on x's
    device (default: made from the host table)."""
    if group.gtype == GROUND:
        n = model.ground_normal.to(x.dtype)[..., None, :]
        phi = torch.sum((x - model.ground_pos[..., None, :]) * n, dim=-1)
        return phi, n.expand(x.shape)
    if prim_body is None:
        prim_body = torch.as_tensor(group.prim_body, dtype=torch.int64,
                                    device=x.device)
    p_b = body_p[..., prim_body, :]
    R_b = body_R[..., prim_body, :, :]
    size = model.body_size[..., prim_body, :]
    xl = spatial.mat_tvec(R_b, x - p_b)                       # world -> local
    if group.gtype == GEOM_CUBOID:
        phi, gl = _sdf_box(xl, size / 2.0)
    elif group.gtype == GEOM_CYLINDER:
        phi, gl = _sdf_cylinder(xl, size[..., 0], size[..., 1])
    elif group.gtype == GEOM_SPHERE:
        phi, gl = _sdf_sphere(xl, size[..., 0])
    else:
        raise ValueError(group.gtype)
    return phi, spatial.mat_vec(R_b, gl)


def penalty_force(phi, n, v_rel, kn, kt, mu, damping):
    """Per-point contact force on the penetrating point (world frame)."""
    p = _relu(-phi)
    pdot = _relu(-torch.sum(n * v_rel, dim=-1))
    fn_mag = kn * p + damping * p * pdot
    fn = fn_mag[..., None] * n
    vt = v_rel - torch.sum(v_rel * n, dim=-1, keepdim=True) * n
    vt_norm = torch.sqrt(torch.sum(vt ** 2, dim=-1) + _EPS ** 2)
    cap = mu * fn_mag
    scale = cap / torch.maximum(cap, kt * vt_norm + _EPS)
    return fn - (kt * scale)[..., None] * vt


def group_forces(group: ContactGroup, model, pts, pts_dot, body_p, body_R,
                 body_v, body_w, params, idx=None):
    """Evaluate one instance group: (f (..., Ni, 3) world force on the
    general side, x_eff (..., Ni, 3) application points, xi_p (..., Ni, 3)
    primitive-side local coordinates). ``params`` are ``param_rows``.
    ``idx`` holds the group's index tables on the device (``point_idx``,
    ``general_body``, ``prim_body``, ``param_idx``); default: made from the
    host tables."""
    if idx is None:
        idx = group_index(group, pts.device)
    gi = idx.general_body
    if group.sphere_general:
        x = body_p[..., idx.point_idx, :]
    else:
        x = pts[..., idx.point_idx, :]
    phi, n = group_sdf(group, model, x, body_p, body_R, idx.prim_body)

    if group.sphere_general:
        r = model.body_size[..., gi, 0]
        phi = phi - r
        x_eff = x - r[..., None] * n
        v_pt = body_v[..., gi, :] + spatial.cross(body_w[..., gi, :],
                                                  x_eff - x)
    else:
        x_eff = x
        v_pt = pts_dot[..., idx.point_idx, :]

    if group.gtype == GROUND:
        v_prim = torch.zeros_like(x_eff)
        xi_p = torch.zeros_like(x_eff)
    else:
        pidx = idx.prim_body
        p_b, R_b = body_p[..., pidx, :], body_R[..., pidx, :, :]
        v_prim = body_v[..., pidx, :] + spatial.cross(body_w[..., pidx, :],
                                                      x_eff - p_b)
        xi_p = spatial.mat_tvec(R_b, x_eff - p_b)

    prm = params[..., idx.param_idx, :]
    f = penalty_force(phi, n, v_pt - v_prim, prm[..., 0], prm[..., 1],
                      prm[..., 2], prm[..., 3])
    return f, x_eff, xi_p


def group_index(group: ContactGroup, device):
    """The group's host index tables as int64 tensors on ``device``."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return types.SimpleNamespace(
        point_idx=t(group.point_idx), general_body=t(group.general_body),
        prim_body=t(group.prim_body), param_idx=t(group.param_idx),
        tac_row=t(group.tac_row))
