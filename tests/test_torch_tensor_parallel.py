"""Tensor parallelism of the port (``vit4hep_tpu_torch/parallel/sharding_rules.py``)
against the JAX package's (``tests/test_tensor_parallel.py``), on the CPU.

Four gloo ranks on a (2, 2) grid, spawned once for the module
(``tests/torch_parallel.tp_worker``): the 144-token ViT (``attn_impl:
auto``, so K1's plain version runs on each rank's 1 of 2 heads) against
JAX's ``shard_tree`` forward on its (4, 2) mesh, atol 1e-5 as JAX's own
test; a 3-head ViT, whose attention the model axis does not divide, left
replicated while its MLP splits; a train step on the global batch against
the port's one-rank step (loss and norms rtol 1e-5: the model group sums
the parts' squares in another order; parameters, moments and EMA atol
1e-6); its checkpoint, whole on disk, into a one-rank state and a whole
checkpoint into the split state; and a sample through the K2v twin, whose
weights are gathered whole, against the one-rank sample on the same noise.
"""

import numpy as np
import pytest
import torch

import jax

from tests.conftest import make_binning_xml, make_shower_hdf5
from tests.torch_parallel import (A, L, R, explicit_step, run_ranks, state_of, tiny_cfm,
                                  tiny_ds2, tp_worker, training_cfg, whole_state)
from vit4hep_tpu.parallel import mesh as jmesh
from vit4hep_tpu.parallel.sharding_rules import _path_names
from vit4hep_tpu.parallel.sharding_rules import shard_tree as jshard_tree
from vit4hep_tpu.parallel.sharding_rules import spec_for_path as jspec
from vit4hep_tpu.utils.config import instantiate as jinstantiate
from vit4hep_tpu_torch.parallel.sharding_rules import spec_for_path
from vit4hep_tpu_torch.experiments.main import main
from vit4hep_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from vit4hep_tpu_torch.utils.jax_params import convert_vit_params

SHAPE, PATCH = [9, 8, 2], [1, 1, 1]
ODE = {"method": "rk4", "options": {"step_size": 0.5}}


def _param(**kw):
    return {"dim": 3, "condition_dim": 3, "hidden_dim": 48, "depth": 2, "num_heads": 2,
            "mlp_ratio": 2.0, "num_patches": [[9, 8, 2]], "patch_dim": 1, **kw}


def _jax_model(param):
    return jinstantiate({
        "_target_": "experiments.calochallenge.calochallenge_cfm.model.CaloChallengeCFM",
        "in_channels": 1, "shape": SHAPE, "patch_shape": PATCH, "odeint_kwargs": ODE,
        "net": {"_target_": "nn.vit.ViT", "param": param}})


def _perturbed(params, seed):
    """JAX params with every leaf moved off its init (adaLN and the final
    layer start at zero)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                        params)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    jm, jm3 = _jax_model(_param()), _jax_model(_param(num_heads=3))
    jp = _perturbed(jm.init_params(jax.random.PRNGKey(0)), 1)
    jp3 = _perturbed(jm3.init_params(jax.random.PRNGKey(1)), 2)
    x = rng.normal(size=(8, 1, *SHAPE)).astype(np.float32)
    t = np.full((8, 1), 0.4, np.float32)
    c = rng.normal(size=(8, 3)).astype(np.float32)
    case = {"param": _param(), "param3": _param(num_heads=3),
            "param_sample": _param(fused_block="sample"), "odeint": ODE,
            "shape": SHAPE, "patch_shape": PATCH, "x": x, "t": t, "c": c,
            "sd": convert_vit_params(jp), "sd3": convert_vit_params(jp3),
            "xb": rng.normal(size=(8, 1, *SHAPE)).astype(np.float32),
            "cb": rng.normal(size=(8, 3)).astype(np.float32),
            "tb": rng.uniform(size=(8, 1, 1, 1, 1)).astype(np.float32),
            "x0b": rng.normal(size=(8, 1, *SHAPE)).astype(np.float32),
            "x_T": rng.normal(size=(8, 144, 1)).astype(np.float32)}

    # JAX: the replicated forward and shard_tree's on the (4, 2) mesh
    fwd = jax.jit(lambda p, x, t, c: jm.forward(p, x, t, c))
    mesh_tp = jmesh.create_mesh(model_parallel=2)
    jp_tp = jshard_tree(jp, mesh_tp)
    assert not jp_tp["params"]["block_0"]["Attention_0"]["Dense_0"]["kernel"] \
        .sharding.is_fully_replicated
    jax_tp = np.asarray(fwd(jp_tp, jmesh.shard_batch(x, mesh_tp), t, c))
    mesh_dp = jmesh.create_mesh(model_parallel=1)
    jax_rep3 = np.asarray(jax.jit(lambda p, x, t, c: jm3.forward(p, x, t, c))(
        jmesh.replicate(jp3, mesh_dp), jmesh.shard_batch(x, mesh_dp), t, c))

    # the port on one rank: a train step, its checkpoint, a sample
    model = tiny_cfm(case["param"], SHAPE, PATCH)
    state = state_of(model, case["sd"], training_cfg())
    batch = tuple(torch.from_numpy(case[k]) for k in ("xb", "cb", "tb", "x0b"))
    metrics = {k: float(v) for k, v in explicit_step(model)(state, batch).items()}
    case["full"] = str(work / "full.pt")
    save_checkpoint(case["full"], state)
    sampler = tiny_cfm(case["param_sample"], SHAPE, PATCH, ODE)
    sampler.net.load_state_dict(case["sd"])
    sample = sampler.sample_batch(torch.from_numpy(c), x_T=torch.from_numpy(case["x_T"]))

    make_binning_xml(work / "binning_dataset_2.xml", n_layers=L, n_r=R, n_alpha=A)
    make_shower_hdf5(work / "dataset_2_1.hdf5", n_events=160, n_voxels=L * A * R)
    case["experiment"] = tiny_ds2(work, work / "tp", 16, "model_parallel=2")
    ranks = run_ranks(tp_worker, 4, work / "ranks", case)
    exp = main(["-cn", "calochallenge/cfm/calochallenge_ds2", *tiny_ds2(work, work / "one", 16)],
               device="cpu")
    return {"work": work, "ranks": ranks, "jax_tp": jax_tp, "jax_rep3": jax_rep3,
            "metrics": metrics, "state": whole_state(state), "sample": sample, "case": case,
            "exp": exp}


def _port_name(path):
    """The port's parameter name of a JAX ViT leaf path (as
    ``utils/jax_params.convert_vit_params`` maps them)."""
    names = list(path)
    leaf = {"kernel": "weight"}.get(names[-1], names[-1])
    mod = names[:-1]
    table = {("t_embedder", "Dense_0"): "t_embedder.mlp.0",
             ("t_embedder", "Dense_1"): "t_embedder.mlp.2",
             ("c_embedder", "Dense_0"): "c_embedder.0", ("c_embedder", "Dense_1"): "c_embedder.2",
             ("final_layer", "adaLN_modulation"): "final_layer.adaLN_modulation.1",
             ("final_layer", "Dense_0"): "final_layer.linear",
             ("Attention_0", "Dense_0"): "attn.qkv", ("Attention_0", "Dense_1"): "attn.proj",
             ("MlpBlock_0", "Dense_0"): "mlp.fc1", ("MlpBlock_0", "Dense_1"): "mlp.fc2"}
    if not mod:
        return leaf
    if mod[0].startswith("block_"):
        sub = tuple(mod[1:])
        prefix = f"blocks.{mod[0][6:]}." + ("adaLN_modulation.1" if sub == ("adaLN_modulation",)
                                            else table[sub])
    else:
        prefix = table.get(tuple(mod), ".".join(mod))
    return f"{prefix}.{leaf}"


def test_spec_rules_match_jax_for_every_parameter():
    jm = _jax_model(_param())
    flat = jax.tree_util.tree_flatten_with_path(jm.init_params(jax.random.PRNGKey(0)))[0]
    port = dict(tiny_cfm(_param(), SHAPE, PATCH).net.named_parameters())
    seen, split = set(), 0
    for path, leaf in flat:
        names = _path_names(path)[1:]  # drop "params"
        name = _port_name(names)
        assert name in port, name
        want = tuple(jspec(names))
        if names[-1] == "kernel":  # a port weight is the kernel transposed
            want = tuple(reversed(want))
        assert spec_for_path(name) == want, name
        assert spec_for_path(("net", *name.split("."))) == want
        seen.add(name)
        split += bool(want)
    assert seen == set(port) and split == 2 * 6  # 2 blocks x (qkv w/b, proj w, fc1 w/b, fc2 w)


def test_tp_forward_matches_jax_shard_tree(run):
    for r, out in enumerate(run["ranks"]):
        assert out["grid"] == {"data": 2, "model": 2}
        assert out["qkv_local"] == (72, 48), r  # q, k, v rows of 1 of 2 heads of 24
        np.testing.assert_allclose(out["fwd"].numpy(), run["jax_tp"], atol=1e-5)


def test_head_count_tp_does_not_divide_stays_replicated(run):
    for out in run["ranks"]:
        assert not out["heads3_attn_group"]
        assert out["heads3_split"] == [f"blocks.{i}.mlp.{n}" for i in range(2)
                                       for n in ("fc1.bias", "fc1.weight", "fc2.weight")]
        np.testing.assert_allclose(out["fwd3"].numpy(), run["jax_rep3"], atol=1e-5)


def test_tp_train_step_matches_replicated(run):
    ref, want = run["metrics"], run["state"]
    for out in run["ranks"]:
        assert out["still_split"] == (72, 48)
        for k in ("loss", "grad_norm", "grad_norm_net"):
            np.testing.assert_allclose(out["metrics"][k], ref[k], rtol=1e-5)
        assert out["metrics"]["skipped"] == 0
        got = out["after"]
        for k, v in want["model"].items():
            np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
        for a, b in zip(got["ema"], want["ema"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_tp_checkpoint_round_trip(run):
    """The split state's checkpoint loads into a one-rank state, and a
    one-rank checkpoint into the split one (JAX
    ``tests/test_tensor_parallel.py:102-139``)."""
    case, want = run["case"], run["state"]
    state = state_of(tiny_cfm(case["param"], SHAPE, PATCH), case["sd"], training_cfg())
    load_checkpoint(run["work"] / "ranks" / "tp.pt", state)
    got = state.state_dict()
    assert got["step"] == 1 and got["ema_updates"] == 1
    for k, v in want["model"].items():
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    for i, st in want["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got["optimizer"]["state"][i][key].numpy(),
                                       st[key].numpy(), atol=1e-6)
    for out in run["ranks"]:
        assert out["loaded_parts_exact"] and out["loaded_step"] == 1


def test_tp_sample_through_the_gathered_k2v_twin(run):
    for out in run["ranks"]:
        np.testing.assert_allclose(out["sample"].numpy(), run["sample"].numpy(), atol=1e-5)


def test_tp_experiment_matches_one_rank(run):
    """The tiny ds2 experiment with ``model_parallel=2`` on the (2, 2) grid:
    the state split after its init, validated with TP, saved whole, and
    whole again after training."""
    one = run["exp"]
    for out in run["ranks"]:
        e = out["exp"]
        assert e["grid"] == {"data": 2, "model": 2} and e["qkv_after"] == (144, 48)
        np.testing.assert_allclose(e["train_loss"], one.train_loss, rtol=1e-5)
        np.testing.assert_allclose(e["val_loss"], one.val_loss, rtol=1e-5)
        assert e["val_loss"] == run["ranks"][0]["exp"]["val_loss"]
    assert [out["exp"]["save"] for out in run["ranks"]] == [True, False, False, False]
    saved = torch.load(run["work"] / "tp" / "runs" / "Tiny" / "run" / "models" / "model_run0.pt",
                       weights_only=True)
    assert saved["step"] == 4
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(saved["model"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
