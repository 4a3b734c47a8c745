"""Env registry: the JAX package's ids and episode lengths (reference gym
registration: StableGrasp-v1, TactilePush-v1, TactileRotation-v1,
Insertion-v3, with max_episode_steps 10/100/200/15).

``make(name, **kwargs)`` passes ``kwargs`` (``observation_type``,
``device``, ``dtype``, ``seed`` and the env's options) to the env's
``make``.
"""

from __future__ import annotations

_REGISTRY = {}


def register(name, factory, max_episode_steps):
    _REGISTRY[name] = (factory, max_episode_steps)


def make(name, **kwargs):
    """Create a functional env by registry id."""
    factory, max_steps = _REGISTRY[name]
    env = factory(**kwargs)
    env.max_episode_steps = max_steps
    return env


def _push(**kw):
    from . import tactile_push
    return tactile_push.make(**kw)


def _insertion(**kw):
    from . import tactile_insertion
    return tactile_insertion.make(**kw)


def _grasp(**kw):
    from . import stable_grasp
    return stable_grasp.make(**kw)


def _dclaw(**kw):
    from . import dclaw_rotate
    return dclaw_rotate.make(**kw)


register("StableGrasp-v1", _grasp, 10)
register("TactilePush-v1", _push, 100)
register("TactileRotation-v1", _dclaw, 200)
register("Insertion-v3", _insertion, 15)
