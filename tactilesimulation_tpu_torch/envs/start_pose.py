"""Settled start poses shipped as data, with a disk cache for other models.

TactileInsertion and StableGrasp begin every episode from a pose that a
long scripted settle reaches (1,000 and 500 substeps). The JAX package runs
that settle in the env's constructor; on the port's eager stepper it takes
minutes, so the bundled scene's result ships in ``data/<name>_q_init.json``
for its float64 and float32 models, keyed on ``model_key``. Any other model
settles once and is cached under ``~/.cache/tactilesimulation_tpu_torch/``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable

import numpy as np
import torch

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CACHE_DIR = os.path.join("~", ".cache", "tactilesimulation_tpu_torch")


def model_key(model) -> str:
    """The JAX package's cache key of a Model: sha256 over the leaves in
    field order, each as float64 bytes and its shape, first 16 hex digits."""
    hsh = hashlib.sha256()
    for f in dataclasses.fields(model):
        arr = np.asarray(getattr(model, f.name).detach().cpu().numpy(),
                         np.float64)
        hsh.update(arr.tobytes() + str(arr.shape).encode())
    return hsh.hexdigest()[:16]


def shipped(path: str):
    """{model key: (dtype name, q list)} of a shipped start-pose file."""
    if not os.path.exists(path):
        return {}
    with open(path) as fp:
        return {k: (v["dtype"], v["q_init"]) for k, v in json.load(fp).items()}


def load_or_settle(path: str, cache_name: str, model,
                   settle: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The start pose of ``model``: from the shipped file at ``path``, else
    from the disk cache ``<cache_name>_<key>.npy``, else ``settle()`` now
    (and cached)."""
    key = model_key(model)
    hit = shipped(path).get(key)
    if hit is not None:
        return torch.tensor(hit[1], dtype=model.dtype, device=model.device)
    cache = os.path.join(os.path.expanduser(CACHE_DIR),
                         f"{cache_name}_{key}.npy")
    if os.path.exists(cache):
        return torch.as_tensor(np.load(cache), dtype=model.dtype,
                               device=model.device)
    q = settle()
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    np.save(cache, q.cpu().numpy())
    return q


def write_file(path: str, model, settle: Callable) -> dict:
    """Settle ``model`` in float64 and float32 on the CPU (``settle(m)`` ->
    q) and write both start poses to ``path``."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        m = model.to("cpu", dtype)
        q = settle(m)
        out[model_key(m)] = {"dtype": str(dtype).split(".")[-1],
                             "q_init": [float(x) for x in q.tolist()]}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fp:
        json.dump(out, fp, indent=1)
        fp.write("\n")
    return out
