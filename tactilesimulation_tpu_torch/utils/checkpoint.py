"""Full training-state checkpoints: one ``torch.save`` of a dict.

Port of ``tactilesimulation_tpu/utils/checkpoint.py``. The state holds
tensors, nested dicts and lists of them, and plain numbers; restoring it
resumes training exactly.
"""

from __future__ import annotations

import os

import torch


def save_state(path: str, state) -> None:
    """Write ``state`` to ``path`` (through a temporary file, so a cut write
    leaves the previous checkpoint in place)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_state(path: str, map_location=None):
    return torch.load(path, map_location=map_location, weights_only=True)
