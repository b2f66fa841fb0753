"""The port's converters of the reference's cINN and EMA checkpoints
(``vit4hep_tpu_torch/utils/torch_migration.py``) against the JAX package's
(``vit4hep_tpu/utils/torch_migration.py``, then ``utils/jax_params``), on
the CPU. The reference tree is absent here, so the reference-layout
checkpoints are written by hand, in the layout JAX's converter reads:

- a FrEIA ``GraphINN`` of [coupling, permute] x 4 (``module_list.{i}``, the
  permutations' ``perm`` / ``perm_inv`` leaves, each ViT1D subnet with the
  time embedder it never calls and its ``grid`` buffer, the binned spline's
  buffers) for ``CaloRQSplineFrEIA`` and ``CaloRQSplineNFlows``: both
  packages give the same permutations and, bit for bit, the same flow
  weights; the port's flow agrees with the JAX flow on the same inputs
  within 1e-5 of scale, forward (z and log|det J|) and inverse;
- the EMA section (torch_ema's ``shadow_params`` in the order of the
  trainable parameters) of a ViT, an energy net (its ``layer`` alias and
  frozen Fourier weights) and a cINN: both packages pair the same shadows
  with the same weights;
- a warm start from a reference run's ``model_run0.pt`` through the
  launcher: the cINN rebuilt with the checkpoint's permutations (in the
  saved config too), the model and EMA loaded, the optimizer fresh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_binning_xml, make_shower_hdf5
from tests.test_torch_cinn import A, L, R, _tiny_cinn_kwargs
from vit4hep_tpu.models.calochallenge import CaloChallengeCINN as JaxCaloChallengeCINN
from vit4hep_tpu.utils import torch_migration as jtm
from vit4hep_tpu_torch.experiments.main import main
from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCINN
from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import ViT
from vit4hep_tpu_torch.utils import jax_params
from vit4hep_tpu_torch.utils import torch_migration as tm

PREFIXES = {"CaloRQSplineFrEIA": ("subnet1.vit.", "subnet2.vit."),
            "CaloRQSplineNFlows": ("_spline1.subnet.vit.", "_spline2.subnet.vit.")}
SPLINE_BUFFERS = {"bins": torch.tensor(10), "default_width": torch.tensor(1.6)}


def _kwargs(coupling):
    kw = dict(_tiny_cinn_kwargs(), cinn_kwargs=dict(_tiny_cinn_kwargs()["cinn_kwargs"],
                                                     fused_spline=False))
    if coupling == "CaloRQSplineNFlows":
        kw.update(coupling_block=coupling, cinn_kwargs={"num_bins": 8, "bounds_init": 4})
    return kw


def _perturbed(module, seed, std=0.05):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(std * torch.randn(p.shape, generator=gen))
    return module


def _reference_graphinn(flow, coupling, perms, hidden=32):
    """The state dict a reference run saves for ``flow``'s weights under the
    permutations ``perms``: ``net.module_list.{2k}`` the coupling k, whose
    subnets' keys carry the block type's prefix, the never-called time
    embedder and the ``grid`` buffer; ``net.module_list.{2k + 1}`` its
    permutation."""
    sd = {}
    gen = torch.Generator().manual_seed(99)
    for k in range(len(perms)):
        block = flow.blocks[2 * k]
        for j, prefix in enumerate(PREFIXES[coupling]):
            sub = getattr(block, f"subnet{j + 1}")
            head = f"net.module_list.{2 * k}.{prefix}"
            sd.update({head + name: v.clone() for name, v in sub.state_dict().items()})
            sd[head + "t_embedder.mlp.0.weight"] = torch.randn(hidden, 256, generator=gen)
            sd[head + "t_embedder.mlp.0.bias"] = torch.randn(hidden, generator=gen)
            sd[head + "grid"] = sub._grid.clone()
        if coupling == "CaloRQSplineFrEIA":
            sd.update({f"net.module_list.{2 * k}.{n}": v for n, v in SPLINE_BUFFERS.items()})
        perm = torch.as_tensor(perms[k])
        sd[f"net.module_list.{2 * k + 1}.perm"] = perm
        sd[f"net.module_list.{2 * k + 1}.perm_inv"] = torch.argsort(perm)
    return sd


def _perms(flow, rng):
    """A new permutation for each of the flow's (token or feature) permutes."""
    return [rng.permutation(flow.blocks[i].perm.numel()).tolist()
            for i in range(1, len(flow.blocks), 2)]


def _assert_same_sd(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], torch.as_tensor(np.asarray(want[k]))), k


@pytest.mark.parametrize("coupling", list(PREFIXES))
def test_graphinn_converts_as_jax_converts(coupling):
    kw = _kwargs(coupling)
    source = _perturbed(CaloChallengeCINN(**kw), 1)
    rng = np.random.default_rng(2)
    perms = _perms(source.net, rng)
    model_sd = tm.strip_state_dict_prefixes(_reference_graphinn(source.net, coupling, perms))

    sd, got_perms = tm.convert_cinn_state_dict(model_sd, coupling)
    jparams, jperms = jtm.convert_cinn_state_dict(model_sd, coupling)
    assert got_perms == jperms == perms
    _assert_same_sd(sd, jax_params.convert_cinn_params(jparams))

    model = CaloChallengeCINN(**kw, permutations=perms)
    model.net.load_state_dict(sd)
    for k in range(kw["nblocks"]):
        assert model.net.blocks[2 * k + 1].perm.tolist() == perms[k]
    jmodel = JaxCaloChallengeCINN(**kw, permutations=perms)
    variables = {"params": jparams}
    x = rng.normal(size=(3, 1, L, A, R)).astype(np.float32)
    c = rng.normal(size=(3, 5)).astype(np.float32)
    tokens = np.asarray(jmodel.to_patches(jnp.asarray(x)))
    jz, jlj = jmodel.net.apply(variables, jnp.asarray(tokens), jnp.asarray(c),
                               method=jmodel.net.forward)
    jback, _ = jmodel.net.apply(variables, jz, jnp.asarray(c), method=jmodel.net.inverse)
    with torch.no_grad():
        z, lj = model.net(torch.from_numpy(tokens), torch.from_numpy(c))
        back, _ = model.net.inverse(torch.from_numpy(np.asarray(jz)), torch.from_numpy(c))
    for got, want in ((z, jz), (lj, jlj), (back, jback)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_graphinn_guards():
    source = CaloChallengeCINN(**_kwargs("CaloRQSplineFrEIA"))
    perms = [list(range(source.net.blocks[i].perm.numel())) for i in range(1, 8, 2)]
    model_sd = tm.strip_state_dict_prefixes(_reference_graphinn(source.net, "CaloRQSplineFrEIA",
                                                                perms))
    with pytest.raises(ValueError, match="no cINN checkpoint converter"):
        tm.convert_cinn_state_dict(model_sd, "Nope")
    with pytest.raises(ValueError, match="not a \\[coupling, permute\\] graph"):
        tm.convert_cinn_state_dict({k: v for k, v in model_sd.items()
                                    if not k.startswith("module_list.1.")}, "CaloRQSplineFrEIA")
    with pytest.raises(ValueError, match="non-GraphINN"):
        tm.convert_cinn_state_dict(dict(model_sd, stray=torch.zeros(1)), "CaloRQSplineFrEIA")
    bad = dict(model_sd)
    bad["module_list.0.subnet1.vit.grid"] = bad["module_list.0.subnet1.vit.grid"] + 0.5
    with pytest.raises(ValueError, match="grid differs"):
        tm.convert_cinn_state_dict(bad, "CaloRQSplineFrEIA")
    with pytest.raises(ValueError, match="no port counterpart"):
        tm.convert_cinn_state_dict(dict(model_sd, **{"module_list.0.scale": torch.ones(1)}),
                                   "CaloRQSplineFrEIA")


VIT_PARAM = dict(dim=3, condition_dim=7, hidden_dim=24, out_channels=1, depth=2, num_heads=2,
                 mlp_ratio=2, num_patches=[[2, 1, 3]], patch_dim=12)
ENERGY_PARAM = dict(dims_in=6, dims_c=1, dim_embedding=16, nhead=2, num_encoder_layers=1,
                    num_decoder_layers=1, dim_feedforward=32, embeds=True, encode_t_dim=16)


def _ema(model_sd, kind):
    names = tm.trainable_param_names(model_sd, kind)
    assert names == jtm._trainable_param_names(model_sd, kind)
    return {"decay": 0.999, "num_updates": 7,
            "shadow_params": [1.01 * model_sd[n].float() + 0.001 for n in names]}


@pytest.mark.parametrize("kind", ["vit", "energy", "cinn"])
def test_ema_section_converts_as_jax_converts(kind):
    if kind == "vit":
        sd = dict(_perturbed(ViT(VIT_PARAM), 3).state_dict())
        sd.update({k: torch.from_numpy(v) for k, v in tm.expected_buffers(VIT_PARAM).items()})
        ema = _ema(sd, kind)
        got = tm.convert_ema_state_dict(ema, sd, kind, param=VIT_PARAM)
        want = jax_params.convert_vit_params(jtm.convert_ema_state_dict(ema, sd, kind))
    elif kind == "energy":
        net = _perturbed(ParallelTransformer(ENERGY_PARAM), 4)
        sd = {}
        for k, v in net.state_dict().items():  # the head's `layer`, registered before `layers`
            if k == "layers.0.weight":
                sd.update({f"layer.{n}": t for n, t in net.layers[0].state_dict().items()})
            sd[k] = v
        sd["time_embed.0.W"] = torch.randn(8)
        ema = _ema(sd, kind)
        got = tm.convert_ema_state_dict(ema, sd, kind)
        want = jax_params.convert_energy_params(jtm.convert_ema_state_dict(ema, sd, kind))
    else:
        source = _perturbed(CaloChallengeCINN(**_kwargs("CaloRQSplineFrEIA")), 5)
        perms = _perms(source.net, np.random.default_rng(5))
        sd = tm.strip_state_dict_prefixes(_reference_graphinn(source.net, "CaloRQSplineFrEIA",
                                                              perms))
        ema = _ema(sd, kind)
        got = tm.convert_ema_state_dict(ema, sd, kind, "CaloRQSplineFrEIA")
        want = jax_params.convert_cinn_params(
            jtm.convert_ema_state_dict(ema, sd, kind, "CaloRQSplineFrEIA")["params"])
    _assert_same_sd(got, want)
    with pytest.raises(ValueError, match="EMA shadow count"):
        tm.convert_ema_state_dict(dict(ema, shadow_params=ema["shadow_params"][1:]), sd, kind,
                                  "CaloRQSplineFrEIA", VIT_PARAM)


V = L * A * R


def test_warm_start_from_a_reference_cinn_run(tmp_path):
    from tests.test_torch_cinn_train import _shape_args

    make_binning_xml(tmp_path / "binning_dataset_2.xml", n_layers=L, n_r=R, n_alpha=A)
    make_shower_hdf5(tmp_path / "dataset_2_1.hdf5", n_events=160, n_voxels=V)
    first = main([*_shape_args(tmp_path), "training.iterations=1", "ema=true"])
    run = tmp_path / "runs" / "TinyC" / "shape"
    perms = _perms(first.model.net, np.random.default_rng(10))
    ref = _reference_graphinn(_perturbed(first.model, 6).net, "CaloRQSplineFrEIA", perms)
    model_sd = tm.strip_state_dict_prefixes(ref)
    ema = _ema(model_sd, "cinn")
    torch.save({"model": ref, "optimizer": {"state": {}}, "scheduler": {}, "ema": ema},
               run / "models" / "model_run0.pt")

    exp = main(["-cp", str(run), "-cn", "config", "warm_start_idx=0", "train=false",
                "device=cpu"])
    assert exp.cfg.model.permutations == perms
    assert "permutations" in (run / "config_1.yaml").read_text()
    assert [exp.model.net.blocks[2 * k + 1].perm.tolist() for k in range(2)] == perms
    want, _ = tm.convert_cinn_state_dict(model_sd, "CaloRQSplineFrEIA")
    _assert_same_sd(exp.model.net.state_dict(), want)
    shadows = tm.convert_ema_state_dict(ema, model_sd, "cinn", "CaloRQSplineFrEIA")
    names = [n.removeprefix("net.") for n, p in exp.model.named_parameters() if p.requires_grad]
    assert len(names) == len(exp.state.ema)
    for n, e in zip(names, exp.state.ema):
        assert torch.equal(e, shadows[n]), n
    assert exp.state.ema_updates == 7 and exp.state.step == 0
    assert not exp.state.optimizer.state
