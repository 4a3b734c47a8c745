"""The port's DiagGaussianActor with flax parameters carried over by
``convert.actor_params_from_numpy`` matches the flax module, float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tactilesimulation_tpu.models import nets as jax_nets
from tactilesimulation_tpu_torch import convert
from tactilesimulation_tpu_torch.models import nets as torch_nets

torch.set_num_threads(1)


@pytest.mark.parametrize("layernorm", [False, True], ids=["plain", "ln"])
def test_actor_matches_flax(layernorm):
    cfg = {"actor_mlp": {"layer_sizes": [64, 64], "activation": "elu",
                         "layernorm": layernorm},
           "actor_logstd_init": -1.0}
    obs_dim, act_dim = 393, 3
    actor_j = jax_nets.DiagGaussianActor(act_dim, cfg)
    params = actor_j.init(jax.random.PRNGKey(0), jnp.zeros(obs_dim))
    # random logstd and LayerNorm scales, so every leaf is exercised
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.1 * rng.randn(*np.shape(a))), params)
    obs = rng.randn(5, obs_dim)

    dist_j = actor_j.apply(params, jnp.asarray(obs))
    act_j = actor_j.apply(params, jnp.asarray(obs), deterministic=True,
                          method=actor_j.act)

    actor_t = torch_nets.DiagGaussianActor(obs_dim, act_dim, cfg).double()
    actor_t.load_state_dict(convert.actor_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    acts = rng.randn(5, act_dim)
    with torch.no_grad():
        dist_t = actor_t(torch.as_tensor(obs))
        pairs = ((dist_t.mean, dist_j.mean), (dist_t.logstd, dist_j.logstd),
                 (actor_t.act(torch.as_tensor(obs)), act_j),
                 (dist_t.log_prob(torch.as_tensor(acts)),
                  dist_j.log_prob(jnp.asarray(acts))),
                 (dist_t.entropy(), dist_j.entropy()))
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
