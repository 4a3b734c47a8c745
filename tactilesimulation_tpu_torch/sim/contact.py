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
from typing import Tuple

import numpy as np
import torch

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
