"""Port parity of cross-dataset fine-tuning against the JAX package, on the CPU.

At tiny widths (hidden 48, depth 2, 4 heads, 12-15 tokens), with inputs and
weights from numpy seeds:

- the ViT's mapper layers (``in_patch_dim``, ``in_condition_dim``,
  ``out_patch_dim``; also tokens of 90 mapped to 48 and out 90) against
  JAX's ``ViTNet``, composed and on the kernel path (the port's plain
  version with f32 products, JAX's Pallas kernel in interpret mode):
  atol 2e-5, rtol 1e-5, f32 on both sides, summation order only;
- ``build_ft_vit_params`` and ``transfer_backbone_params`` for the flag sets
  of the five shipped ``finetuning:`` blocks: copied tensors bit for bit;
  interpolated ones within 1e-6 of ``jax.image.resize(..., antialias=False)``
  and of ``F.interpolate``. JAX's own call antialiases when it shrinks an
  axis (fault 5 of the JAX package, ROADMAP.md queue 3): a test shows the
  difference without making it the port's answer;
- the three-group optimizer (``ft_param_groups`` + ``create_train_state``
  against ``make_ft_optimizer``: three lrs, a cosine schedule) and plain
  Lion and Ranger, 12 steps against optax on the same gradients (a loss
  sum(p * g), whose gradient is g exactly, so a sign or a Lookahead sync
  cannot flip on rounding noise of the backward): params atol 1e-5;
- the slice through the experiment: a tiny backbone run saved by the port
  (and the same weights in the reference's layout, ``module.net.`` prefixes
  and buffers), ``calochallenge_ds2tods3_ft`` composed at a tiny geometry,
  ``init_model`` against JAX's transfer of the same backbone weights (bit
  for bit), three steps through the launcher against JAX's train step under
  ``make_ft_optimizer`` on the same batches and draws (loss rtol 1e-5,
  params atol 1e-5; ``training.eps=1e-6`` as in tests/test_torch_train.py,
  whose docstring gives the reason), and a warm start that resumes all
  three groups without reading the backbone;
- ``CaloChallengeFT_fromLEM.sample_n``'s conditions against JAX's, bit for
  bit, with both packages' nets stubbed and numpy seeded;
- a sampling twin held across a transfer and an optimizer step samples with
  the new weights;
- the reference checkpoints: an energy net's (``time_embed.0.W``, the
  ``layer.*`` alias) against JAX's converter, a buffer that disagrees;
- the five shipped configs compose, and their fine-tune nets at full width
  have JAX's parameter counts.
"""

import dataclasses
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from tests.conftest import make_binning_xml, make_shower_hdf5
from vit4hep_tpu.data.calochallenge import transforms as jtf
from vit4hep_tpu.experiments import calochallenge_finetuning as jftexp
from vit4hep_tpu.experiments import train_state as jts
from vit4hep_tpu.models import finetuning as jft
from vit4hep_tpu.models.vit import ViT as JaxViT
from vit4hep_tpu.models.vit import ViTNet as JaxViTNet
from vit4hep_tpu.models.vit import sampling_variant as jax_sampling_variant
from vit4hep_tpu.utils import config as jcfg
from vit4hep_tpu.utils import torch_migration as jmig
from vit4hep_tpu_torch.experiments import calochallenge_finetuning as texp
from vit4hep_tpu_torch.experiments import train_state as ts
from vit4hep_tpu_torch.experiments.calohadronic_finetuning import CaloHadronicFT
from vit4hep_tpu_torch.experiments.main import main
from vit4hep_tpu_torch.models import finetuning as tft
from vit4hep_tpu_torch.models.vit import ViT, ViTNet, sampling_variant
from vit4hep_tpu_torch.ops import pos_embed as pe_ops
from vit4hep_tpu_torch.utils import torch_migration as tmig
from vit4hep_tpu_torch.utils.checkpoint import save_checkpoint
from vit4hep_tpu_torch.utils.config import Config, compose, instantiate
from vit4hep_tpu_torch.utils.jax_params import convert_energy_params, convert_vit_params

ROOT = Path(__file__).resolve().parent.parent
ATOL, RTOL = 2e-5, 1e-5
SHIPPED = {
    "ds2tods1ph": "calochallenge/finetuning/calochallenge_ds2tods1ph_ft",
    "ds2tods3": "calochallenge/finetuning/calochallenge_ds2tods3_ft",
    "lemurstods2": "calochallenge/finetuning/calochallenge_lemurstods2_ft",
    "calogan": "calogan/calogan_ft",
    "calohadronic": "calohadronic/calohadronic_ft",
}
BACKBONE = dict(dim=3, condition_dim=6, hidden_dim=48, out_channels=1, depth=2, num_heads=4,
                mlp_ratio=2, pos_embedding_coords="cylindrical", learn_pos_embed=True,
                causal_attn=False, num_patches=[[5, 1, 3]], patch_dim=8, attn_impl="auto",
                fused_block="sample", compute_dtype="float32")
# a target that shrinks both embedders' inputs (8 -> 5, 6 -> 4), as ds2tods1ph
# (48 -> 5, 46 -> 6) and calogan_ft (48 -> 6, 46 -> 4) do
TARGET = {"num_patches": [[3, 2, 2]], "patch_dim": 5, "condition_dim": 4}
FT_LRS = {"backbone_lr": 1e-4, "head_lr": 5e-4, "embedder_lr": 1e-3}


def _flags(config) -> dict:
    """The ``finetuning:`` block of a shipped config."""
    return yaml.safe_load((ROOT / "configs" / f"{SHIPPED[config]}.yaml").read_text())[
        "finetuning"]


def _target(config):
    # lemurstods2 copies every embedder: its target keeps the backbone's widths
    return dict(TARGET, patch_dim=8, condition_dim=6) if config == "lemurstods2" else TARGET


def _perturbed(variables, rng, std=0.1):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        variables)


def _init(jnet, rng, n, pdim, cdim, key=0):
    x = np.zeros((2, n, pdim), np.float32)
    return _perturbed(jnet.init(jax.random.PRNGKey(key), x, np.zeros((2, 1), np.float32),
                                np.zeros((2, cdim), np.float32)), rng)


def to_jax(sd) -> dict:
    """The port's ViTNet state dict -> JAX ViTNet variables
    (``convert_vit_params`` run backwards)."""
    sd = {k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in sd.items()}
    params: dict = {}

    def dense(key, *path):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = {"kernel": sd[f"{key}.weight"].T.copy(), "bias": sd[f"{key}.bias"]}

    for mapper in ("x_mapper", "c_mapper"):
        if f"{mapper}.weight" in sd:
            dense(mapper, mapper)
    dense("x_embedder", "x_embedder")
    dense("t_embedder.mlp.0", "t_embedder", "Dense_0")
    dense("t_embedder.mlp.2", "t_embedder", "Dense_1")
    dense("c_embedder.0", "c_embedder", "Dense_0")
    dense("c_embedder.2", "c_embedder", "Dense_1")
    if "pos_embed_freqs" in sd:
        params["pos_embed_freqs"] = sd["pos_embed_freqs"]
    i = 0
    while f"blocks.{i}.attn.qkv.weight" in sd:
        b, k = f"block_{i}", f"blocks.{i}"
        dense(f"{k}.adaLN_modulation.1", b, "adaLN_modulation")
        dense(f"{k}.attn.qkv", b, "Attention_0", "Dense_0")
        dense(f"{k}.attn.proj", b, "Attention_0", "Dense_1")
        dense(f"{k}.mlp.fc1", b, "MlpBlock_0", "Dense_0")
        dense(f"{k}.mlp.fc2", b, "MlpBlock_0", "Dense_1")
        i += 1
    dense("final_layer.adaLN_modulation.1", "final_layer", "adaLN_modulation")
    dense("final_layer.linear", "final_layer", "Dense_0")
    return {"params": params}


def _resized(weight, new_in, antialias):
    """jax.image.resize of a port Linear weight's kernel (in, out) to new_in rows."""
    kernel = weight.detach().numpy().T
    out = jax.image.resize(kernel, (new_in, kernel.shape[1]), method="linear",
                           antialias=antialias)
    return np.asarray(out).T


# ---------------------------------------------------------------------------
# the mapper layers
# ---------------------------------------------------------------------------
MAPPERS = {
    "both-mappers": dict(in_patch_dim=12, in_condition_dim=9, out_patch_dim=12),
    # ds2 -> ds3: tokens of 90 mapped to 48, the FinalLayer back to 90
    "x90-to-48": dict(patch_dim=48, in_patch_dim=90, out_patch_dim=90),
}


@pytest.mark.parametrize("case", MAPPERS)
@pytest.mark.parametrize("fused", [False, "sample"], ids=["composed", "kernel"])
def test_mapper_forward_matches_jax(fused, case):
    """The fine-tuned ViT's forward with its mappers in front of the trunk,
    composed and through the kernel path (the ``fused_block: sample`` twin)."""
    param = {**BACKBONE, **MAPPERS[case], "fused_block": fused}
    pin, cin = param["in_patch_dim"], param.get("in_condition_dim") or param["condition_dim"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 15, pin)).astype(np.float32)
    t = rng.uniform(size=(3, 1)).astype(np.float32)
    c = rng.normal(size=(3, cin)).astype(np.float32)
    jnet = JaxViT(param)
    params = _init(jnet, rng, 15, pin, cin)
    ref = np.asarray(jax_sampling_variant(jnet).apply(params, x, t, c))
    net = ViT(param)
    net.load_state_dict(convert_vit_params(params))
    assert ("c_mapper" in dict(net.named_children())) == ("in_condition_dim" in MAPPERS[case])
    twin = sampling_variant(net)
    with torch.no_grad():
        port = twin(*map(torch.from_numpy, (x, t, c)))
    assert port.shape == (3, 15, param["out_patch_dim"])
    np.testing.assert_allclose(port.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_vit1d_takes_no_mappers():
    from vit4hep_tpu_torch.models.vit import ViT1D

    with pytest.raises(ValueError, match="ViT1D takes none"):
        ViT1D(dict(BACKBONE, dim=1, in_patch_dim=4))


# ---------------------------------------------------------------------------
# the transfer
# ---------------------------------------------------------------------------
def _interpolated(flags):
    """The port keys an embedder's interpolation writes under ``flags``."""
    keys = []
    if flags["interpolate"] and not flags["map_x_embedding"] \
            and not flags["reinitialize_x_embedding"]:
        keys.append("x_embedder.weight")
    if flags["interpolate"] and not flags["map_c_embedding"] \
            and not flags["reinitialize_c_embedding"]:
        keys.append("c_embedder.0.weight")
    return keys


@pytest.mark.parametrize("config", SHIPPED)
def test_transfer_matches_jax(config):
    flags, target = _flags(config), _target(config)
    rng = np.random.default_rng(7)
    bb_params = _init(JaxViT(BACKBONE), rng, 15, 8, 6)
    jcfg_ft = jft.build_ft_vit_params(BACKBONE, target, flags)
    pcfg_ft = tft.build_ft_vit_params(BACKBONE, target, flags)
    for f in dataclasses.fields(pcfg_ft):
        if hasattr(jcfg_ft, f.name):
            assert getattr(pcfg_ft, f.name) == getattr(jcfg_ft, f.name), f.name
    pin = pcfg_ft.in_patch_dim or pcfg_ft.patch_dim
    cin = pcfg_ft.in_condition_dim or pcfg_ft.condition_dim
    ft_params = _init(JaxViTNet(cfg=jcfg_ft), rng, 12, pin, cin, key=1)
    want = convert_vit_params(jft.transfer_backbone_params(ft_params, bb_params, flags))

    net = ViTNet(pcfg_ft)
    net.load_state_dict(convert_vit_params(ft_params))  # the same fresh weights
    bb_sd = convert_vit_params(bb_params)
    got = tft.transfer_backbone_params(net.state_dict(), bb_sd, flags)
    assert set(got) == set(want)
    interpolated = _interpolated(flags)
    for key in got:
        if key in interpolated:
            new_in = got[key].shape[1]
            np.testing.assert_allclose(got[key].numpy(), _resized(bb_sd[key], new_in, False),
                                       atol=1e-6, rtol=0, err_msg=key)
            np.testing.assert_allclose(got[key].numpy(), F.interpolate(
                bb_sd[key][None], size=new_in, mode="linear", align_corners=False)[0].numpy(),
                atol=1e-6, rtol=0, err_msg=key)
        else:
            assert torch.equal(got[key], want[key]), key
    net.load_state_dict(got)  # strict: every entry fits
    groups = tft.param_group_labels(net)
    assert {k for k, g in groups.items() if g == "head"} == {
        k for k in got if k.startswith("final_layer.")}
    assert groups["x_embedder.weight"] == groups["pos_embed_freqs"] == "embedder"
    assert groups["t_embedder.mlp.0.weight"] == groups["blocks.0.attn.qkv.weight"] == "backbone"


def test_jax_default_resize_antialiases_when_it_shrinks():
    """Fault 5 of the JAX package (ROADMAP.md queue 3): ``jax.image.resize``
    antialiases by default when it shrinks the kernel's input axis, which the
    reference's ``F.interpolate`` does not; the port follows the reference."""
    rng = np.random.default_rng(0)
    weight = torch.from_numpy(rng.normal(size=(8, 48)).astype(np.float32))  # kernel (48, 8)
    ours = tft.interpolate_in(weight, 5).numpy()
    assert np.abs(ours - _resized(weight, 5, False)).max() < 1e-6
    assert np.abs(ours - _resized(weight, 5, True)).max() > 0.5  # 2.6 here
    grown = torch.from_numpy(rng.normal(size=(8, 46)).astype(np.float32))
    np.testing.assert_allclose(tft.interpolate_in(grown, 53).numpy(),
                               _resized(grown, 53, True), atol=1e-5, rtol=0)


def test_transfer_refuses_a_backbone_that_does_not_fit():
    flags = dict(_flags("lemurstods2"))
    net = ViTNet(tft.build_ft_vit_params(BACKBONE, TARGET, flags))  # final layer 48 -> 5
    bb_sd = ViT(BACKBONE).state_dict()
    with pytest.raises(ValueError, match="does not fit"):
        tft.transfer_backbone_params(net.state_dict(), bb_sd, flags)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def _training(optimizer, **kw):
    return {**dict(lr=3e-4, iterations=12, optimizer=optimizer, betas=[0.9, 0.999], eps=1e-6,
                   weight_decay=0.05, scheduler="CosineAnnealingLR", scheduler_scale=1,
                   cosanneal_eta_min=0), **kw}


def _grads(rng, params):
    """Per-step gradients: N(0, 1), a tenth of each tensor exactly zero."""
    def g(a):
        out = rng.normal(size=a.shape).astype(np.float32)
        out[rng.random(a.shape) < 0.1] = 0.0
        return out

    return jax.tree.map(g, params)


def _run_both(net, params, tx, state, n_steps=12):
    """n_steps of the JAX and the port train step on the loss sum(p * g);
    the port's parameters are compared after every step."""
    jstep = jax.jit(jts.make_train_step(
        lambda p, g, rng: sum(jnp.sum(a * b) for a, b in zip(jax.tree.leaves(p),
                                                               jax.tree.leaves(g))), tx))
    named = dict(net.named_parameters())
    step = ts.make_train_step(lambda g: sum(torch.sum(named[k] * v) for k, v in g.items()))
    jstate = jts.create_train_state(params, tx, use_ema=False)
    rng = np.random.default_rng(11)
    for _ in range(n_steps):
        g = _grads(rng, params)
        jstate, _ = jstep(jstate, (g,), jax.random.PRNGKey(0))
        step(state, ({k: v for k, v in convert_vit_params(g).items()},))
        want = convert_vit_params(jstate.params)
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    return jstate


@pytest.mark.parametrize("optimizer", ["AdamW", "Lion", "Ranger"])
def test_ft_optimizer_matches_optax(optimizer):
    """Three groups at three lrs, each with its own cosine schedule, as
    ``make_ft_optimizer``'s ``optax.multi_transform``; the checkpoint's
    optimizer and schedule round-trip the three groups."""
    flags = dict(_flags("ds2tods3"), **FT_LRS)
    rng = np.random.default_rng(5)
    cfg_ft = tft.build_ft_vit_params(BACKBONE, TARGET, flags)
    params = _init(JaxViTNet(cfg=jft.build_ft_vit_params(BACKBONE, TARGET, flags)), rng, 12,
                   cfg_ft.in_patch_dim, cfg_ft.condition_dim)
    tcfg = _training(optimizer)
    tx = jft.make_ft_optimizer(jcfg.Config(tcfg), jcfg.Config(flags), params)
    net = ViTNet(cfg_ft)
    net.load_state_dict(convert_vit_params(params))
    groups = tft.ft_param_groups(net, Config(tcfg), Config(flags))
    assert [lr for _, lr in groups] == [1e-4, 5e-4, 1e-3]
    state = ts.create_train_state(net, Config(tcfg), False, groups)
    _run_both(net, params, tx, state)
    sched = jts.make_schedule(jcfg.Config(tcfg), lr=1.0)
    assert state.lrs() == pytest.approx([lr * float(sched(12)) for lr in (1e-4, 5e-4, 1e-3)],
                                        rel=1e-5, abs=1e-15)
    saved = state.state_dict()
    again = ts.create_train_state(net, Config(tcfg), False,
                                  tft.ft_param_groups(net, Config(tcfg), Config(flags)))
    again.load_state_dict(saved)
    assert again.schedule.base_lrs == [1e-4, 5e-4, 1e-3] and again.schedule.last_epoch == 12
    assert again.lrs() == state.lrs()
    for p in net.parameters():
        for k, v in state.optimizer.state[p].items():
            assert torch.equal(again.optimizer.state[p][k], v), k


@pytest.mark.parametrize("optimizer", ["Lion", "Ranger"])
def test_lion_and_ranger_match_optax(optimizer):
    rng = np.random.default_rng(9)
    params = _init(JaxViT(BACKBONE), rng, 15, 8, 6)
    tcfg = _training(optimizer, scheduler="OneCycleLR", onecycle_max_lr=10,
                     onecycle_pct_start=0.2)
    tx = jts.make_optimizer(jcfg.Config(tcfg), jts.make_schedule(jcfg.Config(tcfg)))
    net = ViT(BACKBONE)
    net.load_state_dict(convert_vit_params(params))
    state = ts.create_train_state(net, Config(tcfg), False)
    assert type(state.optimizer).__name__ == optimizer
    jstate = _run_both(net, params, tx, state)
    if optimizer == "Ranger":  # synced at steps 6 and 12: the slow weights are the params
        slow = jstate.opt_state["slow"]
        for k, p in net.named_parameters():
            np.testing.assert_allclose(state.optimizer.state[p]["slow"].numpy(),
                                       convert_vit_params(slow)[k].numpy(), atol=1e-5, rtol=0)
        with pytest.raises(ValueError, match="Lookahead"):
            ts.make_schedule(Config(_training("Ranger", scheduler="ReduceLROnPlateau")))


# ---------------------------------------------------------------------------
# the sampling twin
# ---------------------------------------------------------------------------
def test_a_twin_held_across_weight_updates_samples_with_the_new_weights():
    flags = _flags("ds2tods3")
    rng = np.random.default_rng(2)
    net = ViTNet(tft.build_ft_vit_params(BACKBONE, TARGET, flags))
    with torch.no_grad():  # no zero-initialised final layer
        for p in net.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    twin = sampling_variant(net)  # made before the transfer
    args = (torch.randn(2, 12, 5), torch.rand(2, 1), torch.randn(2, 4))
    bb_sd = convert_vit_params(_init(JaxViT(BACKBONE), rng, 15, 8, 6))

    def held():
        with torch.no_grad():
            return twin(*args), net(*args)

    net.load_state_dict(tft.transfer_backbone_params(net.state_dict(), bb_sd, flags))
    sampled, composed = held()
    torch.testing.assert_close(sampled, composed, atol=ATOL, rtol=RTOL)
    state = ts.create_train_state(net, Config(_training("AdamW")), False)
    ts.make_train_step(lambda: (net(*args) ** 2).mean())(state, ())
    sampled, composed = held()
    torch.testing.assert_close(sampled, composed, atol=ATOL, rtol=RTOL)
    # what a stale twin gives: its layout marked current after one more step
    stale = twin._sampling_weights
    ts.make_train_step(lambda: (net(*args) ** 2).mean())(state, ())
    twin._sampling_stamp = tuple((p.data_ptr(), p._version) for p in twin.parameters())
    twin._sampling_weights = stale
    sampled, composed = held()
    assert (sampled - composed).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# the experiment
# ---------------------------------------------------------------------------
L, A, R = 6, 4, 3  # the backbone's ds2-like geometry: 6 tokens of 12
A3 = 2  # the target's: 6 tokens of 6, mapped to 12 (ds2 -> ds3 maps 90 to 48)
V3 = L * A3 * R
BB_NET = dict(BACKBONE, condition_dim=L + 1, num_patches=[[2, 1, 3]], patch_dim=12)


def _backbone_run(work, name, param, seed=4):
    """A backbone run saved by the port (config_0.yaml, models/model_run0.pt)
    and the same weights in the reference's layout (``module.net.``
    prefixes, the positional grids as buffers) under ``reference/``."""
    run = work / "runs" / name / "bb"
    cfg = Config({
        "exp_type": "calochallenge", "exp_name": name, "run_name": "bb", "run_dir": str(run),
        "run_idx": 0, "ema": False,
        "model": {"_target_": "vit4hep_tpu.models.calochallenge.CaloChallengeCFM",
                  "in_channels": 1, "shape": [L, A, R], "patch_shape": [3, A, 1],
                  "net": {"_target_": "vit4hep_tpu.models.vit.ViT", "param": param}}})
    model = instantiate(cfg.model)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    (run / "models").mkdir(parents=True)
    (run / "config_0.yaml").write_text(cfg.to_yaml())
    save_checkpoint(run / "models" / "model_run0.pt",
                    ts.create_train_state(model, Config(_training("AdamW")), False))
    ref = work / "runs" / name / "reference"
    (ref / "models").mkdir(parents=True)
    cfg.run_dir = str(ref)
    (ref / "config_0.yaml").write_text(cfg.to_yaml())
    sd = {f"module.net.{k}": v for k, v in model.net.state_dict().items()}
    grids = pe_ops.create_meshgrid(((2, 1, 3),))
    sd.update({f"module.net.{n}": torch.from_numpy(g) for n, g in
               zip(("pos_z", "pos_y", "pos_x"), grids)})
    torch.save({"model": sd, "optimizer": {}, "scheduler": {}, "ema": None},
               ref / "models" / "model_run0.pt")
    return run, ref, {k: v.clone() for k, v in model.net.state_dict().items()}


def _ds3_tiny(work, backbone):
    make_binning_xml(work / "binning_dataset_3.xml", n_layers=L, n_r=R, n_alpha=A3)
    make_shower_hdf5(work / "dataset_3_1_full.hdf5", n_events=96, n_voxels=V3)
    make_shower_hdf5(work / "dataset_3_2_full.hdf5", n_events=32, n_voxels=V3, seed=1)
    return ["-cn", SHIPPED["ds2tods3"], f"data_dir={work}", f"base_dir={work}",
            "exp_name=FT", "run_name=ft", "seed=3", f"finetuning.backbone_cfg={backbone}",
            f"model.shape=[{L},{A3},{R}]", f"model.patch_shape=[3,{A3},1]",
            "model.net.param.num_patches=[[2,1,3]]", f"model.net.param.patch_dim={3 * A3}",
            f"model.net.param.condition_dim={L + 1}", "model.net.param.hidden_dim=48",
            "model.net.param.depth=2", "model.net.param.num_heads=4",
            f"data.transforms.ScaleTotalEnergy.n_layers={L}",
            f"data.transforms.CutValues.n_layers={L}",
            f"data.transforms.AddFeaturesToCond.split_index={V3}",
            f"data.transforms.Reshape.shape=[1,{L},{A3},{R}]",
            "data.train_val_frac=[0.8,0.2]", "training.batchsize=16", "training.eps=1e-6",
            "training.iterations=3", "training.validate_every_n_steps=100",
            "training.clip_grad_norm=0.5", "evaluate=false", "plot=false",
            "plotting.loss=false", "save_source=false", "device=cpu"]


@pytest.mark.parametrize("source", ["port", "reference"])
def test_ft_experiment_matches_jax_and_warm_starts(tmp_path, monkeypatch, source):
    run, ref, bb_sd = _backbone_run(tmp_path, "BB", BB_NET)
    backbone = (run if source == "port" else ref) / "config_0.yaml"
    seen = {}
    transfer = tft.transfer_backbone_params

    def recording_transfer(ft_sd, backbone_sd, flags):
        seen["fresh"] = {k: v.clone() for k, v in ft_sd.items()}
        seen["backbone"] = {k: v.clone() for k, v in backbone_sd.items()}
        return transfer(ft_sd, backbone_sd, flags)

    draws, batches = np.random.default_rng(21), []

    def recording_loss(self, x, c):
        t = draws.uniform(size=(x.shape[0], 1, 1, 1, 1)).astype(np.float32)
        x_0 = draws.normal(size=tuple(x.shape)).astype(np.float32)
        batches.append(tuple(np.array(a) for a in (x, c, t, x_0)))
        return self.model.batch_loss(x, c, t=torch.from_numpy(t), x_0=torch.from_numpy(x_0))

    original_train = texp.CaloChallengeFTCFM.train

    def recording_train(self):
        seen["start"] = {k: v.clone() for k, v in self.model.net.state_dict().items()}
        return original_train(self)

    monkeypatch.setattr(tft, "transfer_backbone_params", recording_transfer)
    monkeypatch.setattr(texp.CaloChallengeFTCFM, "loss", recording_loss)
    monkeypatch.setattr(texp.CaloChallengeFTCFM, "train", recording_train)
    exp = main(_ds3_tiny(tmp_path, backbone))
    assert type(exp).__name__ == "CaloChallengeFTCFM" and len(batches) == 3
    for k, v in bb_sd.items():  # the port's checkpoint or the reference's: the same weights
        assert torch.equal(seen["backbone"][k], v), k

    # init_model: JAX's transfer of the same backbone weights, bit for bit
    flags = jcfg.Config(exp.cfg.finetuning.to_container(resolve=True))
    want = convert_vit_params(jft.transfer_backbone_params(to_jax(seen["fresh"]),
                                                           to_jax(bb_sd), flags))
    assert set(want) == set(seen["start"])
    for k, v in seen["start"].items():
        if k in _interpolated(flags):  # c_embedder.0: 7 -> 7, the identity in both
            np.testing.assert_allclose(v.numpy(), _resized(bb_sd[k], v.shape[1], False),
                                       atol=1e-6, rtol=0)
        else:
            assert torch.equal(v, want[k]), k
    assert "x_mapper.weight" in want and want["x_mapper.weight"].shape == (12, 6)

    # the three steps: JAX's train step under make_ft_optimizer
    tcfg = jcfg.Config(exp.cfg.training.to_container(resolve=True))
    jnet = JaxViTNet(cfg=jft.build_ft_vit_params(BB_NET, exp.target_param, flags))
    from vit4hep_tpu.models.calochallenge import CaloChallengeCFM as JaxCaloChallengeCFM

    jmodel = JaxCaloChallengeCFM(jnet, patch_shape=[3, A3, 1], shape=[L, A3, R])
    params = to_jax(seen["start"])
    tx = jft.make_ft_optimizer(tcfg, flags, params)

    def loss_fn(p, x, c, t, x_0, rng):
        x_t, x_t_dot = jmodel.trajectory(x_0, x, t)
        v = jmodel.forward(p, x_t, t.reshape(-1, 1), c)
        return jnp.mean((v - x_t_dot) ** 2)

    jstate = jts.create_train_state(params, tx, use_ema=False)
    jstep = jax.jit(jts.make_train_step(loss_fn, tx, clip_grad_norm=float(tcfg.clip_grad_norm)))
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        np.testing.assert_allclose(exp.train_loss[i], float(jm["loss"]), rtol=1e-5)
        assert float(jm["grad_norm"]) > 0.5  # the global clip acts
    want = convert_vit_params(jstate.params)
    for k, v in exp.model.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)

    # a warm start resumes the three groups and reads no backbone
    saved = torch.load(Path(exp.cfg.run_dir) / "models" / "model_run0.pt", weights_only=True)
    for d in (run, ref):
        (d / "models" / "model_run0.pt").unlink()
    monkeypatch.undo()
    again = main(["-cp", exp.cfg.run_dir, "-cn", "config", "warm_start_idx=0", "train=false",
                  "device=cpu"])
    assert again.cfg.run_idx == 1 and again.state.step == 3
    assert again.state.schedule.base_lrs == [1e-4, 5e-4, 5e-4]
    assert again.state.schedule.last_epoch == 3
    assert len(again.state.optimizer.param_groups) == 3
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    for i, s in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(again.state.optimizer.state_dict()["state"][i][key], s[key])


def test_reference_buffers_are_checked(tmp_path):
    _, ref, _ = _backbone_run(tmp_path, "BB", BB_NET)
    path = ref / "models" / "model_run0.pt"
    cfg = Config({"net": {"_target_": "vit4hep_tpu.models.vit.ViT", "param": BB_NET}})
    sd, migrated = tmig.load_net_state_dict(cfg, path)
    assert migrated and "pos_z" not in sd
    ViT(BB_NET).load_state_dict(sd)
    payload = torch.load(path, weights_only=True)
    payload["model"]["module.net.pos_x"] = payload["model"]["module.net.pos_x"] + 0.5
    torch.save(payload, path)
    with pytest.raises(ValueError, match="pos_x differs"):
        tmig.load_net_state_dict(cfg, path)
    payload["model"]["module.net.pos_x"] = payload["model"]["module.net.pos_x"] - 0.5
    payload["model"]["module.net.attn_mask"] = torch.ones(6, 6, dtype=torch.bool)
    torch.save(payload, path)
    with pytest.raises(ValueError, match="attn_mask has no counterpart"):
        tmig.load_net_state_dict(cfg, path)


def test_fine_tuned_reference_layout_is_renamed():
    """A fine-tuned reference ViT's Sequential embedders become the mappers."""
    flags = dict(_flags("ds2tods3"), map_c_embedding=True)
    net = ViTNet(tft.build_ft_vit_params(BACKBONE, TARGET, flags))
    sd = net.state_dict()
    ref = {}
    for k, v in sd.items():
        for ours, theirs in (("x_mapper.", "x_embedder.0."), ("x_embedder.", "x_embedder.2."),
                             ("c_mapper.", "c_embedder.0."), ("c_embedder.", "c_embedder.2.")):
            if k.startswith(ours):
                k = theirs + k[len(ours):]
                break
        ref[f"net.{k}"] = v
    got = tmig.convert_net_checkpoint(
        Config({"net": {"_target_": "nn.vit.ViT", "param": dict(
            BACKBONE, num_patches=TARGET["num_patches"])}}), {"model": ref})
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_reference_energy_checkpoint_matches_jax(tmp_path):
    """A reference ``ParallelTransformer`` checkpoint (frozen Fourier weights
    ``time_embed.0.W``, the head's ``layer`` alias): the port's loader and
    JAX's converter give the same net."""
    from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxPT
    from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer

    param = dict(dims_in=6, dims_c=1, dim_embedding=16, nhead=2, num_encoder_layers=2,
                 num_decoder_layers=2, dim_feedforward=32, activation="relu", embeds=True,
                 encode_t_dim=16, encode_t_scale=30)
    rng = np.random.default_rng(1)
    net = ParallelTransformer(param)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    w = rng.normal(size=8).astype(np.float32) * 30
    sd = {f"module.net.{k}": v for k, v in net.state_dict().items()}
    sd["module.net.time_embed.0.W"] = torch.from_numpy(w)
    sd.update({f"module.net.layer.{k}": v for k, v in net.layers[0].state_dict().items()})
    path = tmp_path / "model_run0.pt"
    torch.save({"model": sd, "optimizer": {}, "scheduler": {}, "ema": None}, path)

    cfg = Config({"_target_": "vit4hep_tpu.models.cfm.CFM", "shape": [6], "net": {
        "_target_": "vit4hep_tpu.models.energy_transformer.ParallelTransformer",
        "param": param}})
    got, migrated = tmig.load_net_state_dict(cfg, path)
    assert migrated and cfg.net.param.fourier_w == pytest.approx(w.tolist())
    model = instantiate(cfg)
    model.net.load_state_dict(got)
    variables, patch = jmig.convert_energy_state_dict(tmig.load_torch_checkpoint(path))
    jnet = JaxPT(dict(param, **patch))
    x, t, c = (rng.normal(size=(3, 6)).astype(np.float32),
               rng.uniform(size=(3, 1)).astype(np.float32),
               rng.uniform(size=(3, 1)).astype(np.float32))
    ref = np.asarray(jnet.apply(variables, x, t, c))
    with torch.no_grad():
        port = model.net(*map(torch.from_numpy, (x, t, c)))
    np.testing.assert_allclose(port.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert convert_energy_params(variables).keys() == got.keys()


# ---------------------------------------------------------------------------
# sampling behind a LEMURS backbone
# ---------------------------------------------------------------------------
LEM_NET = dict(BB_NET, condition_dim=L + 8)  # [u | E | theta, phi, 5 labels]


def _lem_energy_run(work):
    """An energy run dir: its config (the ds2 energy chain at L layers) and u
    statistics; the nets are stubbed."""
    run = work / "runs" / "E" / "energy"
    run.mkdir(parents=True)
    tf = yaml.safe_load((ROOT / "configs/calochallenge/cfm/calochallenge_ds2_energy.yaml")
                        .read_text())["data"]["transforms"]
    tf["NormalizeByElayer"]["ptype"] = str(work / "binning_dataset_2.xml")
    tf["ScaleTotalEnergy"]["n_layers"] = L
    tf["SelectDims"] = {"start": -L, "end": 0}
    tf["StandardizeUsFromFile"] = {"n_us": L, "model_dir": None}
    tf["Reshape"]["shape"] = [L]
    rng = np.random.default_rng(8)
    np.save(run / "means_u.npy", rng.normal(size=L).astype(np.float32))
    np.save(run / "stds_u.npy", rng.uniform(0.5, 2, size=L).astype(np.float32))
    (run / "config.yaml").write_text(Config({"run_dir": str(run), "data": {
        "transforms": tf}}).to_yaml())
    return run


@pytest.mark.parametrize("sample_us", [True, False])
def test_from_lem_sampling_conditions_match_jax(tmp_path, monkeypatch, sample_us):
    run, _, _ = _backbone_run(tmp_path, "LEM", LEM_NET)
    make_binning_xml(tmp_path / "binning_dataset_2.xml", n_layers=L, n_r=R, n_alpha=A)
    make_shower_hdf5(tmp_path / "dataset_2_1.hdf5", n_events=64, n_voxels=L * A * R)
    make_shower_hdf5(tmp_path / "dataset_2_2.hdf5", n_events=24, n_voxels=L * A * R, seed=1)
    energy = _lem_energy_run(tmp_path)
    exp = main(["-cn", SHIPPED["lemurstods2"], f"data_dir={tmp_path}", f"base_dir={tmp_path}",
                "exp_name=FTL", "run_name=ftl", "seed=3", f"energy_model={energy}",
                f"finetuning.backbone_cfg={run / 'config_0.yaml'}", f"model.shape=[{L},{A},{R}]",
                "model.patch_shape=[3,4,1]", "model.net.param.num_patches=[[2,1,3]]",
                "model.net.param.patch_dim=12", f"model.net.param.condition_dim={L + 8}",
                f"data.transforms.ScaleTotalEnergy.n_layers={L}",
                f"data.transforms.CutValues.n_layers={L}",
                f"data.transforms.AddFeaturesToCond.split_index={L * A * R}",
                f"data.transforms.Reshape.shape=[1,{L},{A},{R}]", "data.train_val_frac=[0.8,0.2]",
                "train=false", "evaluate=false", "plot=false", "save_source=false",
                f"sample_us={str(sample_us).lower()}", "n_samples=10",
                "training.batchsize=16", "training.batchsize_sample=4", "device=cpu"])
    assert type(exp).__name__ == "CaloChallengeFT_fromLEM"

    jexp = object.__new__(jftexp.CaloChallengeFT_fromLEM)
    jexp.cfg = jcfg.OmegaConf.load(str(Path(exp.cfg.run_dir) / "config.yaml"))
    jexp.rank, jexp.base_key = 0, jax.random.PRNGKey(0)
    jexp.state, jexp.model = SimpleNamespace(params=None), "shape net"
    jexp.transforms_module = jtf
    jexp.init_data()
    energy_cfg = jcfg.OmegaConf.load(str(energy / "config.yaml"))

    def jax_energy():
        jexp.energy_model, jexp.energy_model_params = "energy net", None
        jexp.energy_model_transforms = jtf.build_pipeline(energy_cfg.data.transforms,
                                                          str(energy), jtf)

    def port_energy():
        exp.energy_model = "energy net"
        exp.energy_model_transforms = exp.build_transforms(
            Config(energy_cfg.to_container()).data.transforms, str(energy))
        exp._energy_model_path = str(exp.cfg.energy_model)

    monkeypatch.setattr(jexp, "load_energy_model", jax_energy)
    monkeypatch.setattr(exp, "load_energy_model", port_energy)
    draws = np.random.default_rng(0)
    fixed = {True: draws.normal(size=(64, L)).astype(np.float32),
             False: draws.normal(size=(64, 1, L, A, R)).astype(np.float32)}
    seen = {"port": [], "jax": []}

    def draw(tag, energy_net, conds):
        seen[tag].append(np.array(conds))
        return fixed[energy_net][:len(conds)].copy()

    monkeypatch.setattr(exp, "_sample_in_batches", lambda model, conds, bs, noise=None: draw(
        "port", model == "energy net", conds))
    monkeypatch.setattr(jexp, "_sample_in_batches", lambda model, params, conds, key, bs: draw(
        "jax", model == "energy net", conds))
    np.random.seed(17)
    samples, conds = exp.sample_n()
    np.random.seed(17)
    jsamples, jconds = jexp.sample_n()
    np.testing.assert_array_equal(conds, jconds)
    np.testing.assert_array_equal(samples, jsamples)
    assert len(seen["port"]) == len(seen["jax"]) == (2 if sample_us else 1)
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    n = 10 if sample_us else 24
    assert conds.shape == (n, L + 8)
    np.testing.assert_array_equal(conds[:, L + 1:], np.tile([0.5, 0.5, 1, 0, 0, 0, 0], (n, 1)))
    if sample_us:  # the energy model saw E alone
        assert seen["port"][0].shape == (10, 1)


def test_calohadronic_ft_appends_the_fixed_conditions():
    exp = object.__new__(CaloHadronicFT)
    exp.cfg = Config({"gen_theta": 0.5, "gen_phi": 0.25, "gen_label": [0.2] * 5})
    exp.transforms = []
    cond = exp.sampling_conditions(np.array([[10.0], [90.0]], np.float32))
    np.testing.assert_array_equal(cond, np.float32([[10.0, 0.5, 0.25] + [0.2] * 5,
                                                    [90.0, 0.5, 0.25] + [0.2] * 5]))
    assert cond.dtype == np.float32 and exp.energy_cond_width == 1


# ---------------------------------------------------------------------------
# the shipped configs
# ---------------------------------------------------------------------------
BACKBONE_CONFIG = {"ds2tods1ph": "calochallenge/cfm/calochallenge_ds2",
                   "ds2tods3": "calochallenge/cfm/calochallenge_ds2",
                   "lemurstods2": "lemurs/lemurs", "calogan": "calochallenge/cfm/calochallenge_ds2",
                   "calohadronic": "lemurs/lemurs"}


@pytest.mark.parametrize("config", SHIPPED)
def test_shipped_configs_build_the_jax_fine_tune_nets(config):
    overrides = ["data_dir=/nonexistent"]
    cfg = compose(str(ROOT / "configs"), SHIPPED[config], overrides)
    bb = compose(str(ROOT / "configs"), BACKBONE_CONFIG[config], overrides)
    jtarget = jcfg.compose(str(ROOT / "configs"), SHIPPED[config], overrides=overrides)
    jbb = jcfg.compose(str(ROOT / "configs"), BACKBONE_CONFIG[config], overrides=overrides)
    param = cfg.model.net.param.to_container(resolve=True)
    target = {k: param[k] for k in ("num_patches", "patch_dim", "condition_dim")}
    net_cfg = tft.build_ft_vit_params(bb.model.net.param.to_container(resolve=True), target,
                                      cfg.finetuning)
    model_cfg = cfg.model.to_container(resolve=True)
    del model_cfg["net"]
    with torch.device("meta"):
        port = instantiate(model_cfg, net=ViTNet(net_cfg))
    jnet_cfg = jft.build_ft_vit_params(dict(jbb.model.net.param.to_container(resolve=True)),
                                       target, jtarget.finetuning)
    jmodel = jcfg.instantiate(jtarget.model, net=JaxViTNet(cfg=jnet_cfg))
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
    assert port.param_count() == sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    assert cfg.exp_type in ("calochallenge_ft_cfm", "calochallenge_ft_lem_cfm",
                            "calogan_ft_cfm", "calohadronic_ft")
    assert port.net.cfg.hidden_dim == 480 and port.net.cfg.fused_block == "sample"
    if config == "ds2tods3":  # 90 -> 48 in front of the backbone's embedder, out 90
        assert (port.net.cfg.in_patch_dim, port.net.cfg.patch_dim,
                port.net.cfg.out_patch_dim) == (90, 48, 90)


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FILE_KEYS = ("training_file", "test_file", "training_file_dict", "test_file_dict")


def test_chip_smoke_fine_tuning_dicts_equal_yaml():
    """The smoke's fine-tuning settings are the shipped YAML's: the two
    ``finetuning:`` blocks, calochallenge_ds2tods3_ft's model, transforms
    and training, calohadronic_ft's model, transforms, LEMURS conditions,
    data (its file lists aside), evaluation and training."""
    smoke = _chip_smoke()
    assert smoke.DS2TODS3_FINETUNING == _flags("ds2tods3")
    assert smoke.CALOHAD_FINETUNING == _flags("calohadronic")
    raw = {k: yaml.safe_load((ROOT / "configs" / f"{SHIPPED[k]}.yaml").read_text())
           for k in ("ds2tods3", "calohadronic")}
    for key, model, transforms, training in (
            ("ds2tods3", smoke.DS3_SHAPE_MODEL, smoke.DS2TODS3_TRANSFORMS,
             smoke.DS2_SHAPE_TRAINING),
            ("calohadronic", smoke.CALOHAD_FT_MODEL, smoke.CALOHAD_FT_TRANSFORMS,
             smoke.CALOHAD_TRAINING)):
        name = raw[key]["defaults"][2]["/model"]
        assert model == yaml.safe_load((ROOT / "configs" / "model" / f"{name}.yaml").read_text())
        assert transforms == raw[key]["data"]["transforms"]
        cfg = compose(str(ROOT / "configs"), SHIPPED[key], ["data_dir=${data_dir}"])
        assert training == {k: (float(v) if k in ("eps", "lr") else v)  # YAML 1.1's 1e-8
                            for k, v in cfg["training"].to_container().items()}
    had = raw["calohadronic"]
    assert smoke.LEMURS_CONDITIONS == {k: had[k] for k in ("gen_theta", "gen_phi", "gen_label")}
    data = dict(smoke._family_data("calohadronic", "shape"),
                transforms=smoke.CALOHAD_FT_TRANSFORMS)
    assert {k: v for k, v in data.items() if k not in FILE_KEYS} == \
        {k: v for k, v in had["data"].items() if k not in FILE_KEYS}
    assert smoke.CALOHAD_EVALUATION == had["evaluation"]
