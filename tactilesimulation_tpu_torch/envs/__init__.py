"""Env registry: the JAX package's ids and episode lengths (reference gym
registration: StableGrasp-v1, TactilePush-v1, TactileRotation-v1,
Insertion-v3, with max_episode_steps 10/100/200/15).

``make(name, **kwargs)`` passes ``kwargs`` (``observation_type``,
``device``, ``dtype``, ``seed``) to the env's ``make``. Only TactilePush is
ported; the other ids raise.
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


def _not_ported(module):
    def factory(**_):
        raise NotImplementedError(
            f"envs/{module}.py is not ported yet (ROADMAP.md queue 1, "
            "item 7: the other envs)")
    return factory


register("StableGrasp-v1", _not_ported("stable_grasp"), 10)
register("TactilePush-v1", _push, 100)
register("TactileRotation-v1", _not_ported("dclaw_rotate"), 200)
register("Insertion-v3", _not_ported("tactile_insertion"), 15)
