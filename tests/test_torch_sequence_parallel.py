"""Ring attention of the port (``parallel/sequence_parallel.py``) against
JAX's ``ring_attention`` (``tests/test_sequence_parallel.py``), on the CPU.

Four gloo ranks spawned once for the module
(``tests/torch_parallel.ring_worker``) run the ring over ranks (0, 1) and
over all four: the forward at (2, 2, 64, 8) against JAX's on its model = 2
and 4 meshes (rtol 2e-5, atol 2e-6, JAX's own bounds), the gradients of
sum(out^2) at (1, 2, 32, 4) against JAX's (rtol 5e-4, atol 5e-5), and
the ring fed from the packed qkv layout (2, 128, 3 x 2 x 16) against the
port's ``qkv_attention`` (the fused layout's plain version here; f32 on
both sides, atol 1e-5). An N the ring does not divide raises, and one
rank is the plain attention.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parallel import ring_worker, run_ranks
from vit4hep_tpu.ops.attention import xla_attention as jxla_attention
from vit4hep_tpu.parallel import mesh as jmesh
from vit4hep_tpu.parallel.sequence_parallel import ring_attention as jring
from vit4hep_tpu_torch.ops.attention import qkv_attention, xla_attention
from vit4hep_tpu_torch.parallel.sequence_parallel import ring_attention


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(0)
    case = {"exact": [rng.normal(size=(2, 2, 64, 8)).astype(np.float32) for _ in range(3)],
            "grad": [rng.normal(size=(1, 2, 32, 4)).astype(np.float32) for _ in range(3)],
            "qkv": rng.normal(size=(2, 128, 96)).astype(np.float32)}
    ranks = run_ranks(ring_worker, 4, tmp_path_factory.mktemp("ring"), case)
    return {"case": case, "ranks": ranks}


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_jax(run, n):
    q, k, v = map(jnp.asarray, run["case"]["exact"])
    mesh = jmesh.create_mesh(model_parallel=n)
    ref = np.asarray(jax.jit(lambda q, k, v: jring(q, k, v, mesh))(q, k, v))
    np.testing.assert_allclose(ref, np.asarray(jxla_attention(q, k, v)), rtol=2e-5, atol=2e-6)
    for out in run["ranks"][:n]:
        np.testing.assert_allclose(out[("exact", n)].numpy(), ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_grads_match_jax(run, n):
    q, k, v = map(jnp.asarray, run["case"]["grad"])
    mesh = jmesh.create_mesh(model_parallel=n)
    loss = jax.jit(lambda q, k, v: jnp.sum(jring(q, k, v, mesh) ** 2))
    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for out in run["ranks"][:n]:
        for got, want in zip(out[("grad", n)], ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_from_the_packed_qkv_layout(run, n):
    qkv = torch.from_numpy(run["case"]["qkv"])
    ref = qkv_attention(qkv, 2, impl="fused")
    for out in run["ranks"][:n]:
        np.testing.assert_allclose(out[("packed", n)].numpy(), ref.numpy(), atol=1e-5)
        assert "not divisible" in out[("indivisible", n)]


def test_one_rank_is_the_plain_attention():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 10, 4)).astype(np.float32))
               for _ in range(3))
    assert torch.equal(ring_attention(q, k, v), xla_attention(q, k, v))
