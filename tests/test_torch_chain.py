"""The port's whole ds2-like slice against the JAX package, plus import
hygiene and the config surface.

- Generator (vit4hep_tpu_torch.utils.serving) against the JAX
  ``make_fused_generate`` on a tiny ds2-like geometry (6 layers x 4 alpha x 3
  radial bins, patch (3, 4, 1), tiny ViT and energy transformer, both
  ``fused_block: sample``) with the JAX params converted and the very noise
  JAX draws. ``step_size: 0.25`` keeps the JAX interpret-mode kernels quick;
  the ODE rule is the same. Then the port's MeV output against the JAX staged
  inverse of the JAX sample. The same on a ds3-like geometry (6 x 4 x 6,
  patch (3, 2, 3): every patch dim > 1, as ds3's (3, 10, 3)), plain and with
  the layer-causal ViT.
- The port imports no JAX; chip_smoke.py's ds2 and ds3 dicts equal the YAML
  configs; the composed ds3 models have JAX's parameter counts.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.conftest import make_binning_xml
from vit4hep_tpu.data.calochallenge.transforms import build_pipeline as jax_build_pipeline
from vit4hep_tpu.experiments.fused_chain import make_fused_generate as jax_make_fused_generate
from vit4hep_tpu.models.calochallenge import CaloChallengeCFM as JaxCaloChallengeCFM
from vit4hep_tpu.models.cfm import CFM as JaxCFM
from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer
from vit4hep_tpu.models.vit import ViT as JaxViT
from vit4hep_tpu_torch.data.calochallenge.transforms import build_pipeline
from vit4hep_tpu_torch.experiments.fused_chain import UnsupportedTransform, device_u_chain
from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCFM
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import ViT
from vit4hep_tpu_torch.utils.config import TARGET_REMAP, compose, instantiate
from vit4hep_tpu_torch.utils.jax_params import convert_energy_params, convert_vit_params
from vit4hep_tpu_torch.utils.serving import Generator

ROOT = Path(__file__).resolve().parent.parent
L, A, R = 6, 4, 3
ODE = {"method": "rk4", "options": {"step_size": 0.25}}


def _shape_param(**kw):
    return dict(dict(dim=3, condition_dim=L + 1, hidden_dim=24, out_channels=1, depth=2,
                     num_heads=2, mlp_ratio=2, pos_embedding_coords="cylindrical",
                     learn_pos_embed=True, causal_attn=False, num_patches=[[2, 1, 3]],
                     patch_dim=12, attn_impl="auto", fused_block="sample"), **kw)


def _energy_param():
    return dict(dims_in=L, dims_c=1, dim_embedding=16, nhead=2, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=32, activation="relu", embeds=True,
                encode_t_dim=16, encode_t_scale=30, fused_block="sample", fused_group=8)


def _pipelines(tmp_path, radial=R, standardize=None):
    """The ds2 transform chains of configs/calochallenge/cfm/calochallenge_ds2*.yaml
    (ds3's with ``standardize`` ``{"model_dir": None}``, no eps) at the tiny
    geometry of ``radial`` bins, with fitted statistics written to the run
    dirs: ``(port, jax)``, each a ``(shape_tf, energy_tf)`` pair of the same
    steps built by each package."""
    a_, r_ = A, radial
    standardize = standardize or {"model_dir": None, "eps": 1.0e-6}
    xml = make_binning_xml(tmp_path / "binning.xml", n_layers=L, n_r=r_, n_alpha=a_)
    rng = np.random.default_rng(7)
    shape_dir, energy_dir = tmp_path / "shape", tmp_path / "energy"
    shape_dir.mkdir()
    energy_dir.mkdir()
    np.save(shape_dir / "means.npy", np.float32(-6.0))
    np.save(shape_dir / "stds.npy", np.float32(3.0))
    np.save(energy_dir / "means_u.npy", rng.normal(0, 0.3, L).astype(np.float32))
    np.save(energy_dir / "stds_u.npy", rng.uniform(0.8, 1.5, L).astype(np.float32))
    common = {"NormalizeByElayer": {"ptype": str(xml), "xml_file": "electron"},
              "ScaleTotalEnergy": {"n_layers": L, "factor": 0.35}}
    scale = {"LogEnergy": {}, "ScaleEnergy": {"e_min": 6.907755, "e_max": 13.815510}}
    shape_cfg = {
        **common, "CutValues": {"cut": 1.0e-7, "n_layers": L},
        "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
        "GlobalStandardizeFromFile": standardize, **scale,
        "AddFeaturesToCond": {"split_index": L * a_ * r_},
        "Reshape": {"shape": [1, L, a_, r_]}}
    energy_cfg = {
        **common, "SelectDims": {"start": -L, "end": 0},
        "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
        "StandardizeUsFromFile": {"n_us": L, "model_dir": None}, **scale,
        "Reshape": {"shape": [L]}}
    return tuple((build(shape_cfg, str(shape_dir)), build(energy_cfg, str(energy_dir)))
                 for build in (build_pipeline, jax_build_pipeline))


def _perturb(params, rng, std):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        params)


def test_generator_matches_jax_fused_generate(tmp_path):
    _generator_vs_jax(tmp_path, R, [3, 4, 1], _shape_param())


@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
def test_generator_ds3_patching_matches_jax_fused_generate(tmp_path, causal):
    """A ds3-like patch shape: (3, 2, 3) on 6 x 4 x 6 voxels, 8 tokens of 18,
    the radial axis split into patches (ds2 never splits it); the ds3
    transform chain; the layer-causal ViT (``causal_attn``) through the
    masked K2v path."""
    _generator_vs_jax(tmp_path, 6, [3, 2, 3],
                      _shape_param(num_patches=[[2, 2, 2]], patch_dim=18, causal_attn=causal),
                      standardize={"model_dir": None})


def _generator_vs_jax(tmp_path, radial, patch, shape_param, standardize=None):
    (shape_tf, energy_tf), (jshape_tf, jenergy_tf) = _pipelines(tmp_path, radial, standardize)
    b = 4
    rng = np.random.default_rng(8)
    e_inc = 10 ** rng.uniform(3, 6, b)

    jshape = JaxCaloChallengeCFM(JaxViT(shape_param), patch_shape=patch,
                                 shape=[L, A, radial], odeint_kwargs=ODE)
    jenergy = JaxCFM(JaxParallelTransformer(_energy_param()), shape=[L], odeint_kwargs=ODE)
    key = jax.random.PRNGKey(3)
    ps = _perturb(jshape.init_params(key), rng, 0.1)  # non-zero adaLN / final layer
    pe = _perturb(jenergy.init_params(key), rng, 0.05)

    shape = CaloChallengeCFM(ViT(shape_param), patch_shape=patch, shape=[L, A, radial],
                             odeint_kwargs=ODE)
    energy = CFM(ParallelTransformer(_energy_param()), shape=[L], odeint_kwargs=ODE)
    shape.net.load_state_dict(convert_vit_params(ps))
    energy.net.load_state_dict(convert_energy_params(pe))
    gen = Generator(shape, energy, energy_tf, shape_tf, batch=b)
    assert shape.net_evals_per_sample() == jshape.net_evals_per_sample() == 16

    cond = gen.condition(e_inc)
    shower_j, cond_j = jax.jit(jax_make_fused_generate(jshape, jenergy, jenergy_tf, jshape_tf))(
        ps, pe, jnp.asarray(cond), key)
    # the noise JAX drew: fused_chain.py:264 and cfm.py:115,124
    k_u, k_s = jax.random.split(key)
    noise = (torch.from_numpy(np.array(jax.random.normal(k_u, (b, L), jnp.float32))),
             torch.from_numpy(np.array(jax.random.normal(k_s, shape.token_shape(b),
                                                         jnp.float32))))
    shower_t, cond_t = gen.generate(cond, noise=noise)
    # 16 f32 net evals per model and the logit/sigmoid u map between them:
    # ulp-level differences grow through the chain to ~1e-5 of the O(1)
    # values; 1e-4 leaves margin without hiding a wrong operation
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(shower_t.numpy(), np.asarray(shower_j), atol=1e-4, rtol=1e-4)

    # MeV voxels: the port's sample_showers against the JAX staged inverse
    mev_t = gen.sample_showers(e_inc, noise=noise)
    samples, conds = np.asarray(shower_j)[:, 0], np.asarray(cond_j)
    for fn in jshape_tf[::-1]:
        samples, conds = fn(samples, conds, rev=True)
    assert mev_t.shape == (b, L * A * radial) and np.isfinite(mev_t).all() \
        and (mev_t >= 0).all()
    # the inverse exponentiates (sigmoid of logits, layer energies up to
    # 1e6 MeV): relative 1e-3, and 1e-3 of the largest voxel
    np.testing.assert_allclose(mev_t, samples, rtol=1e-3, atol=1e-3 * samples.max())


def test_device_u_chain_matches_staged_numpy(tmp_path):
    """The on-device u mapping equals the JAX package's staged numpy loops."""
    (shape_tf, energy_tf), (jshape_tf, jenergy_tf) = _pipelines(tmp_path)
    u = np.random.default_rng(9).normal(size=(5, L)).astype(np.float32)
    ref = u.copy()
    for fn in jenergy_tf[::-1]:
        if hasattr(fn, "u_transform"):
            ref, _ = fn(ref, None, rev=True)
    for fn in jshape_tf:
        if hasattr(fn, "u_transform"):
            ref, _ = fn(ref, None)
    port = device_u_chain(energy_tf, shape_tf)(torch.from_numpy(u))
    np.testing.assert_allclose(port.numpy(), ref, atol=1e-4, rtol=1e-4)
    with pytest.raises(UnsupportedTransform):
        device_u_chain([type("Foo", (), {"u_transform": True})()], [])


def test_port_imports_no_jax():
    """The port's modules (the experiment's sampling half and the evaluation
    package among them), its launcher and chip_smoke.py load nothing of JAX
    and nothing of the JAX package."""
    code = ("import importlib.util, sys, vit4hep_tpu_torch.utils.serving, "
            "vit4hep_tpu_torch.utils.config, vit4hep_tpu_torch.utils.jax_params, "
            "vit4hep_tpu_torch.models.calochallenge, "
            "vit4hep_tpu_torch.data.calochallenge.transforms, "
            "vit4hep_tpu_torch.data.calochallenge.datasets, "
            "vit4hep_tpu_torch.experiments.main, vit4hep_tpu_torch.experiments.calochallenge, "
            "vit4hep_tpu_torch.experiments.base, vit4hep_tpu_torch.experiments.train_state, "
            "vit4hep_tpu_torch.ops.fused_qkv_attention, vit4hep_tpu_torch.utils.checkpoint, "
            "vit4hep_tpu_torch.ops.fused_spline, vit4hep_tpu_torch.ops.rqs, "
            "vit4hep_tpu_torch.models.bijectors, vit4hep_tpu_torch.models.cinn, "
            "vit4hep_tpu_torch.evaluation, vit4hep_tpu_torch.evaluation.classifiers, "
            "vit4hep_tpu_torch.evaluation.metrics, vit4hep_tpu_torch.evaluation.plots, "
            "vit4hep_tpu_torch.evaluation.high_level_features, "
            "vit4hep_tpu_torch.evaluation.ugr_evaluation, "
            "vit4hep_tpu_torch.evaluation.us_evaluation, vit4hep_tpu_torch.data.xml_handler, "
            "vit4hep_tpu_torch.experiments.fused_chain; "
            "from vit4hep_tpu_torch.experiments.main import get_experiment; "
            "get_experiment('calochallenge'); "
            "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py'); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "bad = [m for m in sys.modules "
            "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'vit4hep_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_configs_equal_yaml():
    smoke = _chip_smoke()
    load = lambda rel: yaml.safe_load((ROOT / "configs" / rel).read_text())  # noqa: E731
    assert smoke.DS2_SHAPE_MODEL == load("model/cfm/cfm_ds2_electrons.yaml")
    assert smoke.DS2_ENERGY_MODEL == load("model/cfm/cfm_ds2_energy.yaml")
    assert smoke.DS2_SHAPE_TRANSFORMS == load("calochallenge/cfm/calochallenge_ds2.yaml")[
        "data"]["transforms"]
    assert smoke.DS2_ENERGY_TRANSFORMS == load("calochallenge/cfm/calochallenge_ds2_energy.yaml")[
        "data"]["transforms"]
    assert smoke.DS2_CINN_MODEL == load("model/cinn/cinn_ds2_electrons.yaml")
    assert smoke.DS2_CINN_TRANSFORMS == load("calochallenge/cinn/calochallenge_ds2_noise.yaml")[
        "data"]["transforms"]
    assert smoke.DS2_EVALUATION == load("calochallenge/cfm/calochallenge_ds2.yaml")["evaluation"]
    assert smoke.DS2_ENERGY_EVALUATION == load("calochallenge/cfm/calochallenge_ds2_energy.yaml")[
        "evaluation"]


def test_chip_smoke_ds3_configs_equal_yaml():
    smoke = _chip_smoke()
    load = lambda rel: yaml.safe_load((ROOT / "configs" / rel).read_text())  # noqa: E731
    assert smoke.DS3_SHAPE_MODEL == load("model/cfm/cfm_ds3_electrons.yaml")
    assert smoke.DS3_ENERGY_MODEL == load("model/cfm/cfm_ds3_energy.yaml")
    assert smoke.DS3_CINN_MODEL == load("model/cinn/cinn_ds3_electrons.yaml")
    assert smoke.DS3_SHAPE_TRANSFORMS == load("calochallenge/cfm/calochallenge_ds3.yaml")[
        "data"]["transforms"]
    assert smoke.DS3_CINN_TRANSFORMS == load("calochallenge/cinn/calochallenge_ds3_noise.yaml")[
        "data"]["transforms"]
    assert smoke.DS3_ENERGY_TRANSFORMS == load("calochallenge/cfm/calochallenge_ds3_energy.yaml")[
        "data"]["transforms"]


@pytest.mark.parametrize("name,count", [("calochallenge/cfm/calochallenge_ds3", 26_082_890),
                                        ("calochallenge/cinn/calochallenge_ds3_noise", 53_510_520)],
                         ids=["cfm", "cinn"])
def test_ds3_models_have_the_jax_parameter_counts(name, count):
    """The composed ds3 shape models (CFM: hidden 480, depth 6, 450 tokens x
    90; cINN: 10 couplings, 20 ViT1D subnets of 225 tokens x 90) build the
    port's classes with JAX's parameter counts (JAX's from jax.eval_shape)."""
    import math

    from vit4hep_tpu.utils.config import compose as jax_compose
    from vit4hep_tpu.utils.config import instantiate as jax_instantiate

    model = instantiate(compose(str(ROOT / "configs"), name, ["data_dir=/nonexistent"])["model"])
    jmodel = jax_instantiate(jax_compose(str(ROOT / "configs"), name,
                                         overrides=["data_dir=/nonexistent"]).model)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
    jcount = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    assert model.param_count() == jcount == count
    if isinstance(model, CaloChallengeCFM):
        assert model.token_shape(2) == (2, 450, 90) and model.net.cfg.fused_block == "sample"
    else:
        assert model.num_patches == (15, 5, 6) and len(model.net.blocks) == 20


def test_chip_smoke_training_configs_equal_yaml():
    """The smoke's training dicts are configs/training/default.yaml with
    cfm/shape.yaml and cfm/energy.yaml on top."""
    smoke = _chip_smoke()
    load = lambda rel: yaml.safe_load((ROOT / "configs" / rel).read_text())  # noqa: E731
    default = {k: (float(v) if k in ("eps", "lr") else v)  # YAML 1.1 reads "1e-8" as a string
               for k, v in load("training/default.yaml").items()}
    for name, want in (("shape", smoke.DS2_SHAPE_TRAINING), ("energy", smoke.DS2_ENERGY_TRAINING)):
        top = {k: v for k, v in load(f"training/cfm/{name}.yaml").items() if k != "defaults"}
        assert want == {**default, **top}, name


def test_chip_smoke_fails_without_cuda():
    """No CUDA device: non-zero exit and no result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_compose_and_instantiate_ds2_configs_to_port_classes():
    """The shared YAML tree (vit4hep_tpu.* targets) builds the port's classes."""
    cfg = compose(str(ROOT / "configs"), "calochallenge/cfm/calochallenge_ds2",
                  ["data_dir=/nonexistent", "model.net.param.depth=1"])
    model = instantiate(cfg["model"])
    assert isinstance(model, CaloChallengeCFM) and model.token_shape(2) == (2, 135, 48)
    assert model.net_evals_per_sample() == 80 and model.net.cfg.fused_block == "sample"
    energy = instantiate(_chip_smoke().DS2_ENERGY_MODEL)
    assert isinstance(energy, CFM) and energy.net.cfg.d_model == 128
    assert all(v.startswith("vit4hep_tpu_torch.") for v in TARGET_REMAP.values())
    with pytest.raises(NotImplementedError, match="not ported"):
        instantiate({"_target_": "vit4hep_tpu.models.cinn.CINN"})
