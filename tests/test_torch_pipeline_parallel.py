"""The GPipe pipeline of the port (``parallel/pipeline.py``) against JAX's
``pipelined_stack`` (``tests/test_pipeline_parallel.py``), on the CPU.

Four gloo ranks spawned once for the module
(``tests/torch_parallel.pipe_worker``): JAX's residual MLP blocks (depth 8,
width 16) over 2 and 4 stages with 4 and 8 microbatches against JAX's
pipeline and the blocks applied in sequence (atol 1e-5); the gradients of
sum(out^2) over 4 stages (depth 4), each stage's summed over the group,
against JAX's (atol 1e-4 as JAX's own test, and rtol 1e-5: entries reach
~100 in f32, and the two packages sum in another order); and the ViT's
DiT block (width 16, 2 heads, plain attention) streamed over 4 stages,
each rank holding only its stage's blocks, against JAX's ``DiTBlock``
pipeline on converted weights (atol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tests.torch_parallel import mlp_block, pipe_worker, run_ranks
from vit4hep_tpu.models.vit import DiTBlock as JaxDiTBlock
from vit4hep_tpu.parallel.pipeline import pipelined_stack as jpipelined_stack
from vit4hep_tpu.parallel.pipeline import stack_stage_params as jstack_stage_params
from vit4hep_tpu_torch.parallel.pipeline import stack_stage_params

DEPTH, HID = 8, 16
SCHEDULES = [(2, 4), (4, 4), (4, 8)]


def _pipe_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("pipe",))


def _mlp_params(key, depth=DEPTH, hid=HID):
    keys = jax.random.split(key, depth)
    return [{"w1": np.array(jax.random.normal(k, (hid, 2 * hid)) * 0.3),
             "w2": np.array(jax.random.normal(jax.random.fold_in(k, 1), (2 * hid, hid)) * 0.3)}
            for k in keys]


def _jax_mlp_block(p, x, c):
    return x + jnp.tanh((x + c[:, None, :]) @ p["w1"]) @ p["w2"]


def _dit_port_sd(p):
    """A JAX DiTBlock's params as the port DiTBlock's state dict."""
    dense = lambda n: {"weight": np.asarray(n["kernel"]).T, "bias": np.asarray(n["bias"])}  # noqa
    names = {"adaLN_modulation.1": p["adaLN_modulation"],
             "attn.qkv": p["Attention_0"]["Dense_0"], "attn.proj": p["Attention_0"]["Dense_1"],
             "mlp.fc1": p["MlpBlock_0"]["Dense_0"], "mlp.fc2": p["MlpBlock_0"]["Dense_1"]}
    return {f"{k}.{leaf}": np.ascontiguousarray(v, np.float32)
            for k, n in names.items() for leaf, v in dense(n).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    key = jax.random.PRNGKey(0)
    params = _mlp_params(key)
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (8, 6, HID)))
    c = np.asarray(jax.random.normal(jax.random.fold_in(key, 2), (8, HID)))
    gkey = jax.random.PRNGKey(3)
    grad_params = _mlp_params(gkey, depth=4)
    gx = np.asarray(jax.random.normal(jax.random.fold_in(gkey, 1), (4, 3, HID)))
    gc = np.asarray(jax.random.normal(jax.random.fold_in(gkey, 2), (4, HID)))

    block = JaxDiTBlock(hidden=HID, num_heads=2, mlp_ratio=2.0, attn_impl="xla")
    dkey = jax.random.PRNGKey(7)
    dx = jax.random.normal(jax.random.fold_in(dkey, 1), (8, 5, HID))
    dc = jax.random.normal(jax.random.fold_in(dkey, 2), (8, HID))
    init = block.init(dkey, dx, dc)["params"]

    def rand_like(k, tree):
        leaves, treedef = jax.tree.flatten(tree)
        keys = jax.random.split(k, len(leaves))
        return jax.tree.unflatten(
            treedef, [0.2 * jax.random.normal(kk, l.shape) for kk, l in zip(keys, leaves)])

    dit = [rand_like(jax.random.fold_in(dkey, i), init) for i in range(4)]
    case = {"params": params, "x": x, "c": c, "schedules": SCHEDULES,
            "grad_params": grad_params, "gx": gx, "gc": gc, "hid": HID,
            "dit": [_dit_port_sd(p) for p in dit], "dx": np.asarray(dx), "dc": np.asarray(dc)}
    ranks = run_ranks(pipe_worker, 4, tmp_path_factory.mktemp("pipe"), case)

    def block_fn(p, xx, cc):
        return block.apply({"params": p}, xx, cc)

    dit_ref = np.asarray(jpipelined_stack(block_fn, dit, _pipe_mesh(4), dx, dc, n_micro=4))
    return {"case": case, "ranks": ranks, "dit_ref": dit_ref}


def test_stack_stage_params_shapes_match_jax():
    params = _mlp_params(jax.random.PRNGKey(0))
    got = stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()} for p in params], 4)
    want = jstack_stage_params(params, 4)
    assert tuple(got["w1"].shape) == want["w1"].shape == (4, 2, HID, 2 * HID)
    for k in ("w1", "w2"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["w1"][1, 0].numpy(), params[2]["w1"])
    with pytest.raises(ValueError, match="not divisible"):
        stack_stage_params(params[:6], 4)


@pytest.mark.parametrize("n_stages,n_micro", SCHEDULES)
def test_pipeline_matches_jax_and_sequential(run, n_stages, n_micro):
    case = run["case"]
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in case["params"]]
    ref = np.asarray(jax.jit(lambda xx, cc: jpipelined_stack(
        _jax_mlp_block, params, _pipe_mesh(n_stages), xx, cc, n_micro=n_micro))(
            case["x"], case["c"]))
    seq = torch.from_numpy(case["x"])
    for p in case["params"]:
        seq = mlp_block({k: torch.from_numpy(v) for k, v in p.items()}, seq,
                        torch.from_numpy(case["c"]))
    for out in run["ranks"][:n_stages]:
        got = out[(n_stages, n_micro)].numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(got, seq.numpy(), atol=1e-5)


def test_pipeline_grads_match_jax(run):
    case = run["case"]
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in case["grad_params"]]
    mesh = _pipe_mesh(4)
    want = jax.grad(lambda ps: jnp.sum(jpipelined_stack(
        _jax_mlp_block, ps, mesh, case["gx"], case["gc"]) ** 2))(params)
    for out in run["ranks"]:
        for g, w in zip(out["grads"], want):
            for k in ("w1", "w2"):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=1e-5, atol=1e-4)


def test_pipeline_dit_blocks_match_jax(run):
    for out in run["ranks"]:
        np.testing.assert_allclose(out["dit"].numpy(), run["dit_ref"], atol=1e-5)
