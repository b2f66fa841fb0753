"""The port's ``models/ar_transformer.py`` against the JAX package's
``vit4hep_tpu/models/ar_transformer.py`` on the CPU, JAX's parameters
carried across (``utils/jax_params.convert_ar_transformer_params``):

- JAX's ``tests/test_models.py`` model (shape 4, 32 dims, 2 heads, one
  encoder and one decoder layer) and a ``layer_cond`` one with learned x
  and c embeddings: ``batch_loss`` on explicit time and noise within 1e-5,
  ``sample_batch`` on explicit noise (JAX's per-dimension draws) within
  1e-4 (four dimensions of 1-D RK4 solves, each on the embedding of the
  last);
- the shipped defaults (45 dims, 64 wide) have JAX's parameter count;
- both remap names instantiate the port's model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit4hep_tpu.models.ar_transformer import ARtransformer as JaxARtransformer
from vit4hep_tpu_torch.models.ar_transformer import ARtransformer, ARtransformerModel
from vit4hep_tpu_torch.utils.config import instantiate
from vit4hep_tpu_torch.utils.jax_params import convert_ar_transformer_params

SMALL = {"shape": [4], "n_con": 1, "dim_embedding": 32, "n_head": 2, "n_encoder_layers": 1,
         "n_decoder_layers": 1, "dim_feedforward": 64, "intermediate_dim": 64,
         "layers_per_block": 3, "solver_kwargs": {"method": "rk4", "options": {"step_size": 0.25}}}
EMBEDS = dict(SMALL, shape=[3], layer_cond=True, x_embed=True, c_embed=True, activation="GELU",
              solver_kwargs={"method": "euler", "options": {"step_size": 0.5}})


def _pair(param, seed=0):
    jmodel = JaxARtransformer(param)
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # non-zero everywhere (biases start at 0)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32)
                          + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    model = ARtransformer(param)
    model.net.load_state_dict(convert_ar_transformer_params(params))
    return jmodel, params, model


@pytest.mark.parametrize("param", [SMALL, EMBEDS], ids=["small", "layer_cond-embeds"])
def test_loss_and_sampling_match_jax(param):
    jmodel, params, model = _pair(param)
    d = int(param["shape"][0])
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, d)).astype(np.float32)
    c = rng.normal(size=(6, 1)).astype(np.float32)

    # batch_loss on JAX's own draws of t and x_0 (ar_transformer.py batch_loss)
    key = jax.random.PRNGKey(3)
    k_t, k_x0 = jax.random.split(key)
    t = np.array(jax.random.uniform(k_t, (6, d, 1)))
    x_0 = np.array(jax.random.normal(k_x0, (6, d, 1)))
    want = float(jmodel.batch_loss(params, jnp.asarray(x), jnp.asarray(c), key))
    got = float(model.batch_loss(torch.from_numpy(x), torch.from_numpy(c),
                                 t=torch.from_numpy(t), x_0=torch.from_numpy(x_0)).detach())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    # sample_batch on JAX's per-dimension x_0 draws (keys = split(rng, d))
    key = jax.random.PRNGKey(4)
    noise = np.concatenate([np.asarray(jax.random.normal(k, (6, 1)))
                            for k in jax.random.split(key, d)], axis=1)
    want = np.asarray(jmodel.sample_batch(params, jnp.asarray(c), key))
    got = model.sample_batch(torch.from_numpy(c), noise=torch.from_numpy(noise)).numpy()
    assert got.shape == (6, d)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_generator_draws_and_gradients():
    model = ARtransformer(SMALL)
    c = torch.randn(5, 1)
    a = model.sample_batch(c, torch.Generator().manual_seed(7))
    b = model.sample_batch(c, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    loss = model.batch_loss(torch.randn(5, 4), c, torch.Generator().manual_seed(1))
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    assert model.net_evals_per_sample() == 4 * 4 * 4


def test_defaults_have_the_jax_parameter_count():
    jmodel = JaxARtransformer({})
    count = sum(np.size(a) for a in jax.tree.leaves(jmodel.init_params(jax.random.PRNGKey(0))))
    model = ARtransformer({})
    assert model.param_count() == count
    assert model.cfg.dims_in == 45 and model.cfg.dim_embedding == 64


@pytest.mark.parametrize("target", ["nn.cfm.transformer.ARtransformer",
                                    "vit4hep_tpu.models.ar_transformer.ARtransformer"])
def test_remap_names_instantiate(target):
    model = instantiate({"_target_": target, "param": dict(SMALL)})
    assert isinstance(model, ARtransformerModel) and model.condition_dim == 1
