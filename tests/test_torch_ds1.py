"""CaloChallenge dataset 1 (photons and pions) in the port against the JAX
package, on the CPU.

The geometry is ds1's published one: photons layers 0-3 and 12 with r x
alpha bins 8 x 1, 16 x 10, 19 x 10, 5 x 1, 5 x 1 (368 voxels), pions
layers 0-3 and 12-14 with 8 x 1, 10 x 10, 10 x 10, 5 x 1, 15 x 10, 16 x
10, 10 x 1 (533 voxels); the binning files are written here with synthetic
radial edges (only the bin counts enter the transforms and the patching).

- ``MultiSectionPatcher``: tokens and their inverse bit for bit on the ds1
  photons and pions sections, CaloGAN's (per-section patch shapes) and
  CaloHadronic's, and the round trip.
- ``AddAngularBins`` forward and reverse bit for bit for the CFM's and the
  cINN's ``add_bins``; ``NormalizeByElayer`` and ``CutValues`` on the ds1
  geometry (the same numpy operations in both packages).
- A tiny ``CaloChallengeCFM_DS1`` on ds1 photons' sections (depth 2,
  hidden 48, 2 heads; 88 tokens x 5), composed: velocity and
  ``batch_loss`` with explicit t and x_0 within atol 1e-5 (f32 both sides,
  summation order only), ``sample_batch`` on JAX's own noise within 1e-4
  of the scale.
- The ds1 two-stage chain (energy CFM -> u map -> the tiny DS1 shape model
  with ``fused_block: sample``, JAX's Pallas ViT in interpret mode against
  the port's K2v path -> the calochallenge_ds1_photons inverse pipeline to
  368 MeV voxels) against JAX ``make_fused_generate``, 1e-4, as
  tests/test_torch_chain.py.
- The same chain with a tiny ds1 cINN on the (53, 1, 10) grid that
  ``AddAngularBins`` pads photons to (``add_bins`` 10; its spline inverse
  JAX's kernel in interpret mode against K4's plain version): the sample
  on JAX's z within 1e-4 of the scale, then reversed to 368 voxels.
- The shipped ds1 configs compose to the port's classes with JAX's
  parameter counts; the smoke's ds1 dicts equal the YAML.
- The launcher through calochallenge_ds1_photons(_energy) on a tiny
  synthetic dataset: training, ``sample_n`` on ds1's incident energies and
  ``eval_sample``.
"""

import importlib.util
import math
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vit4hep_tpu.data.calochallenge.transforms import build_pipeline as jax_build_pipeline
from vit4hep_tpu.experiments.fused_chain import make_fused_generate as jax_make_fused_generate
from vit4hep_tpu.models.calochallenge import CaloChallengeCFM_DS1 as JaxCFM_DS1
from vit4hep_tpu.models.calochallenge import CaloChallengeCINN as JaxCaloChallengeCINN
from vit4hep_tpu.models.cfm import CFM as JaxCFM
from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer
from vit4hep_tpu.models.vit import ViT as JaxViT
from vit4hep_tpu.ops import patching as jpatching
from vit4hep_tpu_torch.data.calochallenge.transforms import build_pipeline
from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCFM_DS1, CaloChallengeCINN
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import ViT
from vit4hep_tpu_torch.ops import patching
from vit4hep_tpu_torch.utils.config import compose, instantiate
from vit4hep_tpu_torch.utils.jax_params import (convert_cinn_params, convert_energy_params,
                                                convert_vit_params)
from vit4hep_tpu_torch.utils.serving import Generator

ROOT = Path(__file__).resolve().parent.parent
ODE = {"method": "rk4", "options": {"step_size": 0.25}}

# ds1's published layouts: (layer id, radial bins, alpha bins)
DS1 = {"photon": [(0, 8, 1), (1, 16, 10), (2, 19, 10), (3, 5, 1), (12, 5, 1)],
       "pion": [(0, 8, 1), (1, 10, 10), (2, 10, 10), (3, 5, 1), (12, 15, 10), (13, 16, 10),
                (14, 10, 1)]}
# configs/model/cfm/cfm_ds1_{photons,pions}.yaml
SECTIONS = {
    "photon": ([[1, 8, 5], [1, 16, 10], [1, 19, 10], [1, 5, 5], [1, 5, 5]],
               [40, 160, 190, 25, 25]),
    "pion": ([[1, 8, 5], [1, 10, 10], [1, 10, 10], [1, 5, 5], [1, 15, 10], [1, 16, 10],
              [1, 10, 5]], [40, 100, 100, 25, 150, 160, 50]),
}
# the AddAngularBins settings of calochallenge_ds1_* (CFM) and *_noise (cINN)
ANGULAR = {"photon": ([1, 10, 10, 1, 1], [5, 10, 10, 5, 5], [10] * 5),
           "pion": ([1, 10, 10, 1, 10, 10, 1], [5, 10, 10, 5, 10, 10, 5], [10] * 7)}


def write_ds1_xml(path, particle):
    """A binning file with ds1's layers for ``particle``; radial edges
    synthetic (5 mm steps)."""
    lines = ["<Bins>", f'  <Particle name="{particle}">']
    for layer, n_r, n_alpha in DS1[particle]:
        edges = ",".join(str(5.0 * j) for j in range(n_r + 1))
        lines.append(f'    <Layer id="{layer}" r_edges="{edges}" n_bin_alpha="{n_alpha}"/>')
    path.write_text("\n".join(lines + ["  </Particle>", "</Bins>"]))
    return path


def _voxels(particle):
    return sum(n_r * n_a for _, n_r, n_a in DS1[particle])


def _perturb(params, rng, std):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        params)


# ---------------------------------------------------------------------------
# patching and host transforms
# ---------------------------------------------------------------------------
PATCHERS = {
    "ds1-photons": (*SECTIONS["photon"], [1, 1, 5]),
    "ds1-pions": (*SECTIONS["pion"], [1, 1, 5]),
    # configs/model/cfm_calogan/cfm_eplus.yaml: per-section patch shapes
    "calogan": ([[1, 96, 3], [1, 12, 12], [1, 6, 12]], [288, 144, 72],
                [[1, 6, 1], [1, 2, 3], [1, 2, 3]]),
    # configs/model/cfm_calohad/cfm_calohad.yaml
    "calohad": ([[10, 15, 15], [48, 30, 30]], [2250, 43200], [[5, 5, 3], [3, 5, 5]]),
}


@pytest.mark.parametrize("layout", list(PATCHERS))
def test_multi_section_patcher_matches_jax(layout):
    list_shape, list_edges, patch = PATCHERS[layout]
    jp = jpatching.MultiSectionPatcher(list_shape, list_edges, patch)
    tp = patching.MultiSectionPatcher(list_shape, list_edges, patch)
    assert (tp.num_patches_per_dim, tp.patch_dim, tp.total_patches) == \
        (jp.num_patches_per_dim, jp.patch_dim, jp.total_patches)
    x = np.random.default_rng(0).normal(size=(2, 1, sum(list_edges))).astype(np.float32)
    tokens = tp.to_patches(torch.from_numpy(x))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jp.to_patches(jnp.asarray(x))))
    t = np.random.default_rng(1).normal(size=tokens.shape).astype(np.float32)
    np.testing.assert_array_equal(tp.from_patches(torch.from_numpy(t)).numpy(),
                                  np.asarray(jp.from_patches(jnp.asarray(t))))
    assert torch.equal(tp.from_patches(tokens), torch.from_numpy(x))


def test_multi_section_patcher_refuses_mixed_patch_dims():
    with pytest.raises(AssertionError, match="patch_dim"):
        patching.MultiSectionPatcher([[1, 4, 4], [1, 4, 4]], [16, 16], [[1, 1, 4], [1, 2, 4]])


@pytest.mark.parametrize("particle", ["photon", "pion"])
@pytest.mark.parametrize("flavour", ["cfm", "cinn"])
def test_add_angular_bins_matches_jax(tmp_path, particle, flavour):
    """Forward (the zero padding, the u's passed through) and reverse (the
    max over the added bins) bit for bit; the padded widths are the shipped
    configs' (440 / 625 for the CFMs, 530 / 740 for the cINNs)."""
    xml = write_ds1_xml(tmp_path / "binning.xml", particle)
    num_bins, cfm_bins, cinn_bins = ANGULAR[particle]
    kw = {"ptype": str(xml), "xml_filename": particle, "num_bins": num_bins,
          "add_bins": cfm_bins if flavour == "cfm" else cinn_bins}
    port, = build_pipeline({"AddAngularBins": kw}, str(tmp_path))
    ref, = jax_build_pipeline({"AddAngularBins": kw}, str(tmp_path))
    n_layers, v = len(num_bins), _voxels(particle)
    padded = {("photon", "cfm"): 440, ("pion", "cfm"): 625, ("photon", "cinn"): 530,
              ("pion", "cinn"): 740}[particle, flavour]
    rng = np.random.default_rng(3)
    shower = rng.exponential(size=(4, v + n_layers)).astype(np.float32)
    energy = rng.uniform(1e3, 1e6, (4, 1)).astype(np.float32)
    out, e = port(shower, energy)
    want, _ = ref(shower, energy)
    assert out.shape == (4, padded + n_layers) and out.dtype == np.float32 and e is energy
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out[:, -n_layers:], shower[:, -n_layers:])
    back, _ = port(out, energy, rev=True)
    np.testing.assert_array_equal(back, shower)  # non-negative voxels: the max restores them
    noisy = rng.normal(size=out.shape).astype(np.float32)
    np.testing.assert_array_equal(port(noisy, energy, rev=True)[0],
                                  ref(noisy, energy, rev=True)[0])


@pytest.mark.parametrize("particle", ["photon", "pion"])
def test_normalize_and_cut_on_ds1_geometry(tmp_path, particle):
    """NormalizeByElayer and CutValues of calochallenge_ds1_* on the ds1
    layers, forward and reverse, bit for bit."""
    xml = write_ds1_xml(tmp_path / "binning.xml", particle)
    n_layers, v = len(DS1[particle]), _voxels(particle)
    cfg = {"NormalizeByElayer": {"ptype": str(xml), "xml_file": particle},
           "CutValues": {"cut": 5.0e-3, "n_layers": n_layers}}
    rng = np.random.default_rng(4)
    shower = (rng.exponential(size=(6, v)) * (rng.random((6, v)) > 0.4)).astype(np.float32)
    energy = rng.uniform(1e3, 1e6, (6, 1)).astype(np.float32)
    for name, kw in cfg.items():
        port, = build_pipeline({name: kw}, str(tmp_path))
        ref, = jax_build_pipeline({name: kw}, str(tmp_path))
        x = shower if name == "NormalizeByElayer" else \
            rng.uniform(size=(6, v + n_layers)).astype(np.float32) * 0.02
        fwd = port(x, energy)[0]
        np.testing.assert_array_equal(fwd, ref(x, energy)[0])
        np.testing.assert_array_equal(port(fwd, energy, rev=True)[0],
                                      ref(fwd, energy, rev=True)[0])


# ---------------------------------------------------------------------------
# the DS1 CFM
# ---------------------------------------------------------------------------
def _ds1_param(condition_dim=6, fused_block="sample"):
    """A tiny ViT at ds1's patch dim; ``num_patches`` is the model's to set."""
    return dict(dim=3, condition_dim=condition_dim, hidden_dim=48, out_channels=1, depth=2,
                num_heads=2, mlp_ratio=2, pos_embedding_coords="cylindrical",
                learn_pos_embed=True, causal_attn=False, num_patches=[[1, 1, 1]],
                patch_dim=5, attn_impl="auto", fused_block=fused_block)


def _ds1_pair(rng, condition_dim=6, fused_block="sample"):
    list_shape, list_edges = SECTIONS["photon"]
    kw = dict(list_shape=list_shape, list_edges=list_edges, patch_shape=[1, 1, 5],
              shape=[440], odeint_kwargs=ODE)
    jmodel = JaxCFM_DS1(JaxViT(_ds1_param(condition_dim, fused_block)), **kw)
    params = _perturb(jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)), rng, 0.1)
    model = CaloChallengeCFM_DS1(ViT(_ds1_param(condition_dim, fused_block)), **kw)
    model.net.load_state_dict(convert_vit_params(params))
    return jmodel, params, model


def test_tiny_ds1_cfm_matches_jax():
    """The composed net (``fused_block: false``; the two-stage test below
    samples through the K2v path)."""
    rng = np.random.default_rng(5)
    jmodel, params, model = _ds1_pair(rng, fused_block=False)
    assert model.net.cfg.num_patches == tuple(jmodel.net.cfg.num_patches) == (
        (1, 8, 1), (1, 16, 2), (1, 19, 2), (1, 5, 1), (1, 5, 1))
    assert model.token_shape(3) == jmodel.token_shape(3) == (3, 88, 5)
    assert model.x_shape(3) == (3, 1, 440)
    assert model.param_count() == jmodel.param_count(params)
    b = 3
    x = rng.normal(size=(b, 1, 440)).astype(np.float32)
    c = rng.normal(size=(b, 6)).astype(np.float32)
    t = rng.uniform(size=(b, 1, 1)).astype(np.float32)
    x_0 = rng.normal(size=x.shape).astype(np.float32)
    x_t, x_t_dot = jmodel.trajectory(jnp.asarray(x_0), jnp.asarray(x), jnp.asarray(t))
    v_ref = np.asarray(jax.jit(jmodel.forward)(params, x_t, jnp.asarray(t).reshape(-1, 1), c))
    loss_ref = float(jnp.mean((v_ref - x_t_dot) ** 2))
    tt = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    with torch.no_grad():
        v = model(tt(x_t), tt(t).reshape(-1, 1), tt(c))
        loss = model.batch_loss(tt(x), tt(c), t=tt(t), x_0=tt(x_0))
    np.testing.assert_allclose(v.numpy(), v_ref, atol=1e-5)
    assert abs(float(loss) - loss_ref) <= 1e-5 * max(1.0, loss_ref)

    key = jax.random.PRNGKey(6)
    ref = np.asarray(jax.jit(jmodel.sample_batch)(params, jnp.asarray(c), key))
    x_T = tt(jax.random.normal(key, jmodel.token_shape(b), jnp.float32))
    out = model.sample_batch(tt(c), x_T=x_T)
    assert out.shape == (b, 1, 440)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * np.abs(ref).max())


def _energy_param(n_layers):
    return dict(dims_in=n_layers, dims_c=1, dim_embedding=16, nhead=2, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=32, activation="relu", embeds=True,
                encode_t_dim=16, encode_t_scale=30, fused_block="sample", fused_group=32)


def _ds1_pipelines(tmp_path, flavour="cfm"):
    """The photon transform chains of calochallenge_ds1_photons (``cfm``) or
    calochallenge_ds1_photons_noise (``cinn``) and
    calochallenge_ds1_photons_energy on the written geometry, built by each
    package: ``(port, jax)`` pairs of (shape, energy) steps."""
    xml = str(write_ds1_xml(tmp_path / "binning.xml", "photon"))
    rng = np.random.default_rng(7)
    shape_dir, energy_dir = tmp_path / "shape", tmp_path / "energy"
    shape_dir.mkdir()
    energy_dir.mkdir()
    np.save(shape_dir / "means.npy", np.float32(-6.0))
    np.save(shape_dir / "stds.npy", np.float32(3.0))
    np.save(energy_dir / "means_u.npy", rng.normal(0, 0.3, 5).astype(np.float32))
    np.save(energy_dir / "stds_u.npy", rng.uniform(0.8, 1.5, 5).astype(np.float32))
    num_bins, cfm_bins, cinn_bins = ANGULAR["photon"]
    common = {"NormalizeByElayer": {"ptype": xml, "xml_file": "photon"},
              "ScaleTotalEnergy": {"n_layers": 5, "factor": 0.25}}
    scale = {"LogEnergy": {}, "ScaleEnergy": {"e_min": 5.5452, "e_max": 15.2492}}
    angular = {"ptype": xml, "xml_filename": "photon", "num_bins": num_bins}
    if flavour == "cfm":
        middle = {"AddAngularBins": dict(angular, add_bins=cfm_bins),
                  "CutValues": {"cut": 5.0e-7, "n_layers": 5}}
        tail = {"AddFeaturesToCond": {"split_index": 440}, "Reshape": {"shape": [1, 440]}}
    else:
        middle = {"AddAngularBins": dict(angular, add_bins=cinn_bins),
                  "SelectiveUniformNoise": {"a": 1.0e-7, "b": 1.0e-6, "cut": True,
                                            "exclusions": [-5, -4, -3, -2, -1]}}
        tail = {"AddFeaturesToCond": {"split_index": 530},
                "Reshape": {"shape": [1, 53, 1, 10]}}
    shape_cfg = {**common, **middle,
                 "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
                 "GlobalStandardizeFromFile": {"model_dir": None}, **scale, **tail}
    energy_cfg = {**common, "SelectDims": {"start": -5, "end": 0},
                  "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
                  "StandardizeUsFromFile": {"n_us": 5, "model_dir": None}, **scale,
                  "Reshape": {"shape": [5]}}
    return tuple((build(shape_cfg, str(shape_dir)), build(energy_cfg, str(energy_dir)))
                 for build in (build_pipeline, jax_build_pipeline))


def _energy_pair(rng):
    jenergy = JaxCFM(JaxParallelTransformer(_energy_param(5)), shape=[5], odeint_kwargs=ODE)
    pe = _perturb(jax.jit(jenergy.init_params)(jax.random.PRNGKey(3)), rng, 0.05)
    energy = CFM(ParallelTransformer(_energy_param(5)), shape=[5], odeint_kwargs=ODE)
    energy.net.load_state_dict(convert_energy_params(pe))
    return jenergy, pe, energy


def _chain_vs_jax(tmp_path, flavour, shape_pair, noise_shape):
    (shape_tf, energy_tf), (jshape_tf, jenergy_tf) = _ds1_pipelines(tmp_path, flavour)
    b = 4
    rng = np.random.default_rng(8)
    e_inc = 2.0 ** rng.integers(8, 23, b)  # ds1's incident energies
    jshape, ps, shape = shape_pair(rng)
    jenergy, pe, energy = _energy_pair(rng)
    gen = Generator(shape, energy, energy_tf, shape_tf, batch=b)
    assert gen.cond_dim == 1
    cond = gen.condition(e_inc)
    key = jax.random.PRNGKey(3)
    shower_j, cond_j = jax.jit(jax_make_fused_generate(jshape, jenergy, jenergy_tf, jshape_tf))(
        ps, pe, jnp.asarray(cond), key)
    k_u, k_s = jax.random.split(key)  # the noise JAX drew (fused_chain.py:264)
    noise = (torch.from_numpy(np.array(jax.random.normal(k_u, (b, 5), jnp.float32))),
             torch.from_numpy(np.array(jax.random.normal(k_s, noise_shape(jshape, b),
                                                         jnp.float32))))
    shower_t, cond_t = gen.generate(cond, noise=noise)
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(shower_t.numpy(), np.asarray(shower_j),
                               atol=1e-4 * max(1.0, np.abs(shower_j).max()), rtol=1e-4)
    mev_t = gen.sample_showers(e_inc, noise=noise)
    samples, conds = np.asarray(shower_j)[:, 0], np.asarray(cond_j)
    for fn in jshape_tf[::-1]:
        samples, conds = fn(samples, conds, rev=True)
    assert mev_t.shape == (b, 368) and np.isfinite(mev_t).all() and (mev_t >= 0).all()
    np.testing.assert_allclose(mev_t, samples, rtol=1e-3, atol=1e-3 * samples.max())


def test_ds1_generator_matches_jax_fused_generate(tmp_path):
    """The two-stage chain with the DS1 shape CFM (88 tokens x 5, through
    the K2v plain path) behind a 5-layer energy CFM, to 368 MeV voxels
    through AddAngularBins' reverse."""
    _chain_vs_jax(tmp_path, "cfm", _ds1_pair, lambda m, b: m.token_shape(b))


def _tiny_ds1_cinn_kwargs(condition_dim):
    return dict(shape=[53, 1, 10], patch_shape=[[1, 1, 5]], in_channels=1,
                coupling_block="CaloRQSplineFrEIA", nblocks=1, is_spatial=[False],
                cinn_kwargs={"fused_spline": True, "bins": 10, "min_bin_sizes": [0.001, 0.001],
                             "default_domain": [-8.0, 8.0, -8.0, 8.0], "identity_tails": False,
                             "domain_clamping": None},
                vit_kwargs={"dim": 1, "condition_dim": condition_dim, "hidden_dim": 24,
                            "out_channels": 1, "depth": 1, "num_heads": 2, "mlp_ratio": 2.0,
                            "learn_pos_embed": True, "causal_attn": False,
                            "checkpoint_grads": False})


def _ds1_cinn_pair(rng, condition_dim=6):
    jmodel = JaxCaloChallengeCINN(**_tiny_ds1_cinn_kwargs(condition_dim))
    params = _perturb(jax.jit(jmodel.init_params)(jax.random.PRNGKey(1)), rng, 0.05)
    model = CaloChallengeCINN(**_tiny_ds1_cinn_kwargs(condition_dim))
    model.net.load_state_dict(convert_cinn_params(params))
    return jmodel, params, model


def test_ds1_cinn_generator_matches_jax_fused_generate(tmp_path):
    """ds1 photons' cINN grid (53, 1, 10): 106 tokens x 5, subnets of 53
    tokens (the plain attention under ``auto``, as in JAX), the spline
    inverse through K4's plain version; its sample on JAX's z within 1e-4
    of scale inside the two-stage chain, then to 368 MeV voxels."""
    model = _ds1_cinn_pair(np.random.default_rng(9))[2]
    assert model.num_patches == (53, 1, 2) and model.x_shape(2) == (2, 1, 53, 1, 10)
    assert model.net.blocks[0].subnet1.cfg.prod_num_patches == 53
    _chain_vs_jax(tmp_path, "cinn", _ds1_cinn_pair, lambda m, b: m.x_shape(b))


# ---------------------------------------------------------------------------
# the shipped configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,count", [
    ("calochallenge/cfm/calochallenge_ds1_photons", 25_982_005),
    ("calochallenge/cfm/calochallenge_ds1_pions", 25_982_965),
    ("calochallenge/cfm/calochallenge_ds1_photons_energy", 1_956_225),
    ("calochallenge/cfm/calochallenge_ds1_pions_energy", 1_956_353),
    ("calochallenge/cinn/calochallenge_ds1_photons_noise", 52_853_500),
    ("calochallenge/cinn/calochallenge_ds1_pions_noise", 52_863_100),
], ids=["cfm-photons", "cfm-pions", "energy-photons", "energy-pions", "cinn-photons",
        "cinn-pions"])
def test_ds1_configs_have_the_jax_parameter_counts(name, count):
    """The shipped ds1 configs build the port's classes (the DS1 CFM with
    the patcher's grids, 88 / 125 tokens x 5; the cINNs on (53 / 74, 1, 10))
    with JAX's parameter counts (JAX's from jax.eval_shape; the port's on
    the meta device)."""
    from vit4hep_tpu.utils.config import compose as jax_compose
    from vit4hep_tpu.utils.config import instantiate as jax_instantiate

    with torch.device("meta"):
        model = instantiate(compose(str(ROOT / "configs"), name,
                                    ["data_dir=/nonexistent"])["model"])
    jmodel = jax_instantiate(jax_compose(str(ROOT / "configs"), name,
                                         overrides=["data_dir=/nonexistent"]).model)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
    jcount = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    assert model.param_count() == jcount == count
    if isinstance(model, CaloChallengeCFM_DS1):
        n_tok = 88 if "photons" in name else 125
        assert model.token_shape(2) == jmodel.token_shape(2) == (2, n_tok, 5)
        assert model.net.cfg.num_patches == tuple(jmodel.net.cfg.num_patches)
        assert model.net.cfg.fused_block == "sample"
    elif isinstance(model, CaloChallengeCINN):
        assert model.num_patches == jmodel.num_patches
        assert len(model.net.blocks) == 20
        assert model.net.blocks[0].subnet1.cfg.num_heads == 4
        assert model.net.blocks[0].subnet1.cfg.hidden_dim == 240


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_ds1_configs_equal_yaml():
    """The smoke's ds1 and _tpu dicts are the shipped YAML (model configs,
    and the data.transforms mappings with ${data_dir} kept)."""
    smoke = _chip_smoke()
    load = lambda rel: yaml.safe_load((ROOT / "configs" / rel).read_text())  # noqa: E731
    for rel, want in (
            ("model/cfm/cfm_ds1_photons.yaml", smoke.DS1_SHAPE_MODEL["photons"]),
            ("model/cfm/cfm_ds1_pions.yaml", smoke.DS1_SHAPE_MODEL["pions"]),
            ("model/cfm/cfm_ds1_photons_energy.yaml", smoke.DS1_ENERGY_MODEL["photons"]),
            ("model/cfm/cfm_ds1_pions_energy.yaml", smoke.DS1_ENERGY_MODEL["pions"]),
            ("model/cinn/cinn_ds1_photons.yaml", smoke.DS1_CINN_MODEL["photons"]),
            ("model/cinn/cinn_ds1_pions.yaml", smoke.DS1_CINN_MODEL["pions"]),
            ("model/cfm/cfm_ds2_electrons_tpu.yaml", smoke.DS2_TPU_SHAPE_MODEL),
            ("model/cinn/cinn_ds2_electrons_tpu.yaml", smoke.DS2_TPU_CINN_MODEL)):
        assert want == load(rel), rel
    for rel, want in (
            ("calochallenge/cfm/calochallenge_ds1_photons.yaml",
             smoke.DS1_SHAPE_TRANSFORMS["photons"]),
            ("calochallenge/cfm/calochallenge_ds1_pions.yaml",
             smoke.DS1_SHAPE_TRANSFORMS["pions"]),
            ("calochallenge/cfm/calochallenge_ds1_photons_energy.yaml",
             smoke.DS1_ENERGY_TRANSFORMS["photons"]),
            ("calochallenge/cfm/calochallenge_ds1_pions_energy.yaml",
             smoke.DS1_ENERGY_TRANSFORMS["pions"]),
            ("calochallenge/cinn/calochallenge_ds1_photons_noise.yaml",
             smoke.DS1_CINN_TRANSFORMS["photons"]),
            ("calochallenge/cinn/calochallenge_ds1_pions_noise.yaml",
             smoke.DS1_CINN_TRANSFORMS["pions"])):
        assert want == load(rel)["data"]["transforms"], rel
    evaluation = load("calochallenge/cfm/calochallenge_ds1_photons.yaml")["evaluation"]
    assert smoke.DS1_EVALUATION == evaluation
    # the smoke's binning files: the published bin counts, 368 and 533 voxels
    for particle, geometry in (("photon", "ds1_photons"), ("pion", "ds1_pions")):
        layers = smoke.GEOMETRY[geometry]
        assert [(i, len(r) - 1, a) for i, a, r in layers] == DS1[particle]
        assert smoke._voxels(geometry) == _voxels(particle)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _shower_file(path, particle, n_events, seed):
    import h5py

    rng = np.random.default_rng(seed)
    v = _voxels(particle)
    energies = 2.0 ** rng.integers(8, 23, (n_events, 1))
    showers = rng.exponential(1.0, (n_events, v)) * (rng.random((n_events, v)) > 0.3)
    showers = showers / showers.sum(1, keepdims=True) * energies * 0.8
    with h5py.File(path, "w") as f:
        f.create_dataset("incident_energies", data=energies.astype(np.float32))
        f.create_dataset("showers", data=showers.astype(np.float32))


def _common(work, name, seed):
    return [f"data_dir={work}", f"base_dir={work}", f"exp_name={name}", "run_name=run",
            f"seed={seed}", "data.train_val_frac=[0.8,0.2]", "training.batchsize=16",
            "training.validate_every_n_steps=2", "training.iterations=3", "evaluate=false",
            "plotting.loss=false", "save_source=false", "plot=false",
            "model.odeint_kwargs.options.step_size=0.5"]


def test_launcher_trains_samples_and_evaluates_ds1_photons(tmp_path):
    """calochallenge_ds1_photons_energy and calochallenge_ds1_photons (depth
    1, hidden 24) trained through the launcher on 80 synthetic photon
    showers; then the shape run samples through ``sample_n`` (ds1's
    incident energies, one copy of the spectrum: 121 showers, the u's from
    the energy run), writes them, and ``eval_sample`` evaluates them against
    the test file (the high-level features' classifier for one epoch); then
    the per-energy E_tot / E_inc panels of ds1's spectrum."""
    from vit4hep_tpu_torch.evaluation import plots
    from vit4hep_tpu_torch.evaluation.high_level_features import HighLevelFeatures
    from vit4hep_tpu_torch.experiments.calochallenge import CaloChallenge
    from vit4hep_tpu_torch.utils.config import OmegaConf

    write_ds1_xml(tmp_path / "binning_dataset_1_photons.xml", "photon")
    _shower_file(tmp_path / "gamma_data_1.hdf5", "photon", 80, 0)
    _shower_file(tmp_path / "gamma_data_2.hdf5", "photon", 121, 1)
    energy_run = tmp_path / "runs" / "TinyE" / "run"
    energy = ["-cn", "calochallenge/cfm/calochallenge_ds1_photons_energy",
              *_common(tmp_path, "TinyE", 4), "model.net.param.dim_embedding=16",
              "+model.net.param.encode_t_dim=16", "model.net.param.nhead=2",
              "model.net.param.num_encoder_layers=1", "model.net.param.num_decoder_layers=1",
              "model.net.param.dim_feedforward=32"]
    shape = ["-cn", "calochallenge/cfm/calochallenge_ds1_photons", *_common(tmp_path, "TinyS", 3),
             "model.net.param.hidden_dim=24", "model.net.param.depth=1",
             "model.net.param.num_heads=2", f"energy_model={energy_run}",
             "training.batchsize_sample=64"]
    launcher = [sys.executable, "-m", "vit4hep_tpu_torch.experiments.main"]
    procs = [subprocess.Popen([*launcher, *args, "device=cpu"], cwd=ROOT,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for args in (energy, shape)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    shape_run = tmp_path / "runs" / "TinyS" / "run"
    for f in ("config.yaml", "means.npy", "stds.npy", "models/model_run0.pt"):
        assert (shape_run / f).exists(), f

    cfg = OmegaConf.load(shape_run / "config.yaml")
    cfg.train, cfg.warm_start_idx = False, 0
    cfg.evaluation.eval_cls_n_epochs = 1
    exp = CaloChallenge(cfg, device="cpu")
    exp()  # the warm start
    assert exp.model.net.cfg.num_patches[1] == (1, 16, 2)
    exp.generate_Einc_ds1 = lambda: CaloChallenge.generate_Einc_ds1(exp, sample_multiplier=1)
    np.random.seed(0)
    samples, cond = exp.sample_n()
    assert samples.shape == (121, 1, 440) and cond.shape == (121, 6)
    mev, e_inc = exp.to_mev(samples, cond)
    assert mev.shape == (121, 368) and np.isfinite(mev).all() and (mev >= 0).all()
    # E_inc back through LogEnergy and ScaleEnergy in f32: ~1e-6 relative
    np.testing.assert_allclose(np.sort(e_inc[:, 0]),
                               np.sort(CaloChallenge.generate_Einc_ds1(exp, 1)), rtol=1e-5)
    exp.save_sample(mev, e_inc, name=f"_{exp.cfg.run_idx}")
    exp.cfg.evaluation.eval_mode = "cls-high"
    exp.eval_sample()
    out = shape_run / f"eval_{exp.cfg.run_idx}"
    assert (out / "classifier_cls-high_cls-high_1-photons.txt").exists()
    # the per-energy E_tot / E_inc panels of ds1's discrete spectrum
    hlf = HighLevelFeatures("photon", filename=str(tmp_path / "binning_dataset_1_photons.xml"))
    hlf.CalculateFeatures(mev)
    hlf.Einc = e_inc
    arg = types.SimpleNamespace(output_dir=str(out), dataset="1-photons")
    plots.plot_Etot_Einc_discrete(hlf, hlf, arg)
    assert any(out.glob("*Etot_Einc*"))
