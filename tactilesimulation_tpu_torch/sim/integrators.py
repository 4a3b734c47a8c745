"""Solver constants shared with the lane-major stepper (``sim/lanes.py``)."""

from __future__ import annotations

import torch


def ridge_eps(dtype) -> float:
    """Tikhonov ridge scale for the chord dense solves.

    The ridge added to the iteration matrix is ``ridge_eps * (mean|diag| + 1)``
    -- scale-aware so near-massless dofs stay solvable in f32. Same formula
    as the JAX package's ``integrators.ridge_eps``."""
    return 1e-7 if dtype == torch.float32 else 1e-12
