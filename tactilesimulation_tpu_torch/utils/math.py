"""Math utilities on tensors.

Port of ``tactilesimulation_tpu/utils/math.py``: range scaling, uniform
random unit quaternions from an explicit ``torch.Generator`` (in place of
a PRNG key), and a module's gradient norm and flat parameter vector (in
``parameters()`` order, in place of a pytree's). The quaternion and
rotation algebra lives in ``sim/spatial.py`` and is re-exported here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..sim.spatial import (  # noqa: F401  (re-exports)
    euler_xyz_to_quat,
    quat_conj,
    quat_mul,
    quat_rotate,
    quat_to_mat,
    quat_to_rotvec,
    rotvec_mul,
    rotvec_to_quat,
)


def scale(x, lower, upper):
    """[-1, 1] -> [lower, upper]."""
    return 0.5 * (x + 1.0) * (upper - lower) + lower


def unscale(x, lower, upper):
    """[lower, upper] -> [-1, 1]."""
    return (2.0 * x - upper - lower) / (upper - lower)


def remap(x, old_lower, old_upper, new_lower, new_upper):
    return scale(unscale(x, old_lower, old_upper), new_lower, new_upper)


def random_quaternions(n: int, generator: Optional[torch.Generator] = None,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, 4) unit quaternions (w, x, y, z), uniform over the rotations,
    from three uniform draws per quaternion."""
    u = torch.rand((n, 3), generator=generator, dtype=dtype, device=device)
    a, b, c = u[:, 0], u[:, 1], u[:, 2]
    return torch.stack([
        torch.sqrt(1 - a) * torch.sin(2 * math.pi * b),
        torch.sqrt(1 - a) * torch.cos(2 * math.pi * b),
        torch.sqrt(a) * torch.sin(2 * math.pi * c),
        torch.sqrt(a) * torch.cos(2 * math.pi * c),
    ], dim=-1)


def grad_norm(module: torch.nn.Module) -> torch.Tensor:
    """Global L2 norm of the module's parameter gradients (parameters
    without one count as zero)."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(g ** 2) for g in grads))


def flatten_params(module: torch.nn.Module) -> torch.Tensor:
    """Every parameter of the module, flattened and concatenated in
    ``parameters()`` order (a detached copy)."""
    return torch.nn.utils.parameters_to_vector(
        list(module.parameters())).detach().clone()


def fill_params(module: torch.nn.Module, flat: torch.Tensor):
    """Write ``flat`` (``flatten_params``'s layout) into the module's
    parameters in place; returns the module."""
    with torch.no_grad():
        torch.nn.utils.vector_to_parameters(
            torch.as_tensor(flat), list(module.parameters()))
    return module
