"""Sampling through the port's CaloChallenge experiment against the JAX
package's, on the CPU at a tiny ds2-like geometry (6 layers x 4 alpha x 3
radial bins, the transform chains of calochallenge_ds2(_energy).yaml).

An energy run and a shape run are trained through the port's launcher
(``python -m vit4hep_tpu_torch.experiments.main``); then JAX params
(perturbed from JAX's init, so that no adaLN or final layer is zero) are
converted into both: the energy run's ``model_run0.pt`` (read back by the
port's ``load_energy_model``) and the shape experiment's model. A JAX
``CaloChallenge`` built over the same run dirs samples with its own keys,
and the port is given the very noise JAX draws from them (``fold_in`` of a
split key per batch). n_samples 10 at batch 4: the last batch is padded
with 2 repeated conditions and cut.

Tolerance: 16 f32 net evals per model (RK4 step 0.25) and the logit /
sigmoid u map between the stages give ulp-level differences that grow to
~1e-5 of the O(1) values; 1e-4 absolute and relative, as
tests/test_torch_chain.py holds the two-stage generator.
"""

import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_binning_xml, make_shower_hdf5
from vit4hep_tpu.data.calochallenge import transforms as jtf
from vit4hep_tpu.experiments.calochallenge import CaloChallenge as JaxCaloChallenge
from vit4hep_tpu.models.calochallenge import CaloChallengeCINN as JaxCaloChallengeCINN
from vit4hep_tpu.parallel import mesh as jmesh
from vit4hep_tpu.utils import config as jcfg
from vit4hep_tpu_torch.evaluation import ugr_evaluation
from vit4hep_tpu_torch.experiments import fused_chain
from vit4hep_tpu_torch.experiments.calochallenge import CaloChallenge
from vit4hep_tpu_torch.experiments.main import main
from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCINN
from vit4hep_tpu_torch.utils.jax_params import (convert_cinn_params, convert_energy_params,
                                                convert_vit_params)

ROOT = Path(__file__).resolve().parent.parent
L, A, R = 6, 4, 3
V = L * A * R
N_SAMPLES, BATCH = 10, 4  # three batches, the last padded by 2
TOL = dict(atol=1e-4, rtol=1e-4)
STEP = "model.odeint_kwargs.options.step_size=0.25"


def _common(work, name, run, seed):
    return [f"data_dir={work}", f"base_dir={work}", f"exp_name={name}", f"run_name={run}",
            f"seed={seed}", "data.train_val_frac=[0.8,0.2]", "training.batchsize=16",
            "training.validate_every_n_steps=2", "evaluate=false", "plotting.loss=false",
            "save_source=false", STEP]


def _energy_args(work, run="energy", seed=4, iterations=4):
    return ["-cn", "calochallenge/cfm/calochallenge_ds2_energy", *_common(work, "TinyE", run, seed),
            "model.net.param.fused_block=false",
            f"model.shape=[{L}]", f"model.net.param.dims_in={L}",
            "model.net.param.dim_embedding=16", "+model.net.param.encode_t_dim=16",
            "model.net.param.nhead=2", "model.net.param.num_encoder_layers=1",
            "model.net.param.num_decoder_layers=1", "model.net.param.dim_feedforward=32",
            f"data.transforms.ScaleTotalEnergy.n_layers={L}",
            f"data.transforms.SelectDims.start=-{L}", f"data.transforms.StandardizeUsFromFile.n_us={L}",
            f"data.transforms.Reshape.shape=[{L}]", f"training.iterations={iterations}",
            "plot=false"]


def _shape_args(work, energy_run, run="shape", iterations=4):
    return ["-cn", "calochallenge/cfm/calochallenge_ds2", *_common(work, "TinyS", run, 3),
            "model.net.param.fused_block=false",
            f"model.shape=[{L},{A},{R}]", "model.patch_shape=[3,4,1]",
            "model.net.param.num_patches=[[2,1,3]]", "model.net.param.patch_dim=12",
            f"model.net.param.condition_dim={L + 1}", "model.net.param.hidden_dim=48",
            "model.net.param.depth=2", "model.net.param.num_heads=4",
            f"data.transforms.ScaleTotalEnergy.n_layers={L}",
            f"data.transforms.CutValues.n_layers={L}",
            f"data.transforms.AddFeaturesToCond.split_index={V}",
            f"data.transforms.Reshape.shape=[1,{L},{A},{R}]", f"energy_model={energy_run}",
            f"n_samples={N_SAMPLES}", f"training.batchsize_sample={BATCH}",
            f"training.iterations={iterations}"]


def _perturb(params, rng, std):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        params)


def _write_energy_params(run, params):
    """The energy run's checkpoint with ``params`` (JAX) in place of the
    trained weights."""
    path = run / "models" / "model_run0.pt"
    ckpt = torch.load(path, weights_only=True)
    ckpt["model"] = {f"net.{k}": v for k, v in convert_energy_params(params).items()}
    torch.save(ckpt, path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Energy and shape runs trained through the launcher, with JAX params
    converted into the energy run's checkpoint; returns the work dir, the
    run dirs and the JAX params."""
    work = tmp_path_factory.mktemp("sampling")
    make_binning_xml(work / "binning_dataset_2.xml", n_layers=L, n_r=R, n_alpha=A)
    make_shower_hdf5(work / "dataset_2_1.hdf5", n_events=160, n_voxels=V)
    make_shower_hdf5(work / "dataset_2_2.hdf5", n_events=64, n_voxels=V, seed=1)
    energy_run = work / "runs" / "TinyE" / "energy"
    launcher = [sys.executable, "-m", "vit4hep_tpu_torch.experiments.main"]
    # the shape run only names the energy run, so both train at once
    procs = [subprocess.Popen([*launcher, *args, "device=cpu"], cwd=ROOT,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for args in (_energy_args(work), [*_shape_args(work, energy_run), "plot=false"])]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    shape_run = work / "runs" / "TinyS" / "shape"
    for f in ("config.yaml", "means_u.npy", "stds_u.npy", "models/model_run0.pt"):
        assert (energy_run / f).exists(), f
    for f in ("config.yaml", "means.npy", "stds.npy", "models/model_run0.pt"):
        assert (shape_run / f).exists(), f

    rng = np.random.default_rng(5)
    energy_cfg = jcfg.OmegaConf.load(energy_run / "config.yaml")
    shape_cfg = jcfg.OmegaConf.load(shape_run / "config.yaml")
    key = jax.random.PRNGKey(2)
    jenergy, jshape = jcfg.instantiate(energy_cfg.model), jcfg.instantiate(shape_cfg.model)
    pe = _perturb(jax.jit(jenergy.init_params)(key), rng, 0.05)
    ps = _perturb(jax.jit(jshape.init_params)(key), rng, 0.1)
    _write_energy_params(energy_run, pe)
    return types.SimpleNamespace(work=work, energy=energy_run, shape=shape_run, pe=pe, ps=ps,
                                 jenergy=jenergy, jshape=jshape, jit_cache={})


def _port_experiment(runs, *overrides):
    """The shape run restored by a warm start (no training, nothing saved),
    its net holding the JAX params."""
    exp = main(["-cp", str(runs.shape), "-cn", "config", "warm_start_idx=0", "train=false",
                "plot=false", "save=false", *overrides], device="cpu")
    exp.model.net.load_state_dict(convert_vit_params(runs.ps))
    exp.model.eval()
    return exp


def _jax_experiment(runs, exp, base_key):
    """A JAX CaloChallenge over the same run dirs and config, with the
    energy model and params given (JAX cannot read the port's checkpoint:
    it has no ``time_embed.0.W`` buffer)."""
    jexp = object.__new__(JaxCaloChallenge)
    jexp.cfg = jcfg.Config(exp.cfg.to_container(resolve=False))
    jexp.transforms = jtf.build_pipeline(jexp.cfg.data.transforms, str(runs.shape), jtf)
    jexp.model = runs.jshape
    jexp.state = types.SimpleNamespace(params=runs.ps)
    jexp.mesh = jmesh.create_mesh(num_devices=1)
    jexp.base_key = base_key
    energy_cfg = jcfg.OmegaConf.load(runs.energy / "config.yaml")
    jexp.energy_model = runs.jenergy
    jexp.energy_model_params = runs.pe
    jexp.energy_model_transforms = jtf.build_pipeline(energy_cfg.data.transforms,
                                                      str(runs.energy), jtf)
    jexp.load_energy_model = lambda: None
    # one compiled sampler per JAX model for the whole module
    jexp._sampling_fn = lambda model: runs.jit_cache.setdefault(
        id(model), jax.jit(lambda p, c, k: model.sample_batch(p, c, k)))
    return jexp


def _noise(key, shape, n_batches):
    """The per-batch draws of JAX's ``_sample_in_batches``."""
    return [np.array(jax.random.normal(jax.random.fold_in(key, i), shape, jnp.float32))
            for i in range(n_batches)]


def _staged_noise(base_key, shape_noise_shape):
    """(energy, shape) noise of JAX's staged sample_n: sample_us takes the
    first split of the base key, the shape stage the next."""
    key_u, rest = jax.random.split(base_key)
    key_s, _ = jax.random.split(rest)
    n = -(-N_SAMPLES // BATCH)
    return _noise(key_u, (BATCH, L), n), _noise(key_s, shape_noise_shape, n)


def test_sample_n_staged_and_sample_us_match_jax(runs):
    exp = _port_experiment(runs)
    base_key = jax.random.PRNGKey(11)
    jexp = _jax_experiment(runs, exp, base_key)
    u_noise, s_noise = _staged_noise(base_key, exp.model.token_shape(BATCH))

    np.random.seed(21)
    sample_j, cond_j = jexp.sample_n()
    np.random.seed(21)
    sample_t, cond_t = exp.sample_n(noise=(u_noise, s_noise))
    assert not exp.last_sampling_fused
    assert sample_t.shape == (N_SAMPLES, 1, L, A, R) and cond_t.shape == (N_SAMPLES, L + 1)
    np.testing.assert_allclose(cond_t, cond_j, **TOL)
    np.testing.assert_allclose(sample_t, sample_j, **TOL)
    # the energy model came from the run's checkpoint, which holds JAX's params
    assert exp._energy_model_path == str(runs.energy)

    # sample_us alone, on another set of conditions
    cond = cond_j[:, -1:][::-1].copy()
    jexp.base_key = base_key
    np.testing.assert_allclose(exp.sample_us(cond, BATCH, u_noise), jexp.sample_us(cond, BATCH),
                               **TOL)


def test_sample_n_fused_matches_jax(runs, monkeypatch):
    exp = _port_experiment(runs, "+fused_generation=true")
    base_key = jax.random.PRNGKey(12)
    jexp = _jax_experiment(runs, exp, base_key)
    key, _ = jax.random.split(base_key)
    noise = ([], [])  # per batch: split(fold_in(key, i)) -> (energy, shape)
    for i in range(-(-N_SAMPLES // BATCH)):
        k_u, k_s = jax.random.split(jax.random.fold_in(key, i))
        noise[0].append(np.array(jax.random.normal(k_u, (BATCH, L), jnp.float32)))
        noise[1].append(np.array(jax.random.normal(k_s, exp.model.token_shape(BATCH),
                                                   jnp.float32)))
    np.random.seed(22)
    sample_j, cond_j = jexp.sample_n()
    np.random.seed(22)
    sample_t, cond_t = exp.sample_n(noise=noise)
    assert exp.last_sampling_fused
    assert sample_t.shape == (N_SAMPLES, 1, L, A, R) and cond_t.shape == (N_SAMPLES, L + 1)
    np.testing.assert_allclose(cond_t, cond_j, **TOL)
    np.testing.assert_allclose(sample_t, sample_j, **TOL)
    # the chain is built once per (energy model, transform state)
    gen = exp._fused_gen
    exp.sample_n()
    assert exp._fused_gen is gen

    # a u-transform without a device twin: the staged path on the same noise
    monkeypatch.delitem(fused_chain._REGISTRY, "ScaleTotalEnergy")
    exp = _port_experiment(runs, "+fused_generation=true")
    np.random.seed(24)
    fallback = exp.sample_n(noise=noise)
    assert exp._fused_gen is None and not exp.last_sampling_fused
    exp.cfg.fused_generation = False
    np.random.seed(24)
    staged = exp.sample_n(noise=noise)
    for a, b in zip(fallback, staged):
        np.testing.assert_array_equal(a, b)


def test_cinn_shape_model_through_sample_n_matches_jax(runs):
    """A tiny cINN shape model (2 couplings, the plain spline inverse) behind
    the same energy model, through the staged sample_n."""
    kw = dict(shape=[L, A, R], patch_shape=[[3, 2, 1]], in_channels=1,
              coupling_block="CaloRQSplineFrEIA", nblocks=2, is_spatial=[False, True],
              cinn_kwargs={"fused_spline": False, "bins": 10, "min_bin_sizes": [0.001, 0.001],
                           "default_domain": [-8.0, 8.0, -8.0, 8.0], "identity_tails": False,
                           "domain_clamping": None},
              vit_kwargs={"dim": 1, "condition_dim": L + 1, "hidden_dim": 32, "out_channels": 1,
                          "depth": 1, "num_heads": 2, "mlp_ratio": 2.0, "learn_pos_embed": True,
                          "causal_attn": False, "checkpoint_grads": False})
    jmodel = JaxCaloChallengeCINN(**kw)
    params = _perturb(jax.jit(jmodel.init_params)(jax.random.PRNGKey(1)),
                      np.random.default_rng(8), 0.05)
    exp = _port_experiment(runs)
    exp.model = CaloChallengeCINN(**kw).eval()
    exp.model.net.load_state_dict(convert_cinn_params(params))
    base_key = jax.random.PRNGKey(13)
    jexp = _jax_experiment(runs, exp, base_key)
    jexp.model, jexp.state = jmodel, types.SimpleNamespace(params=params)
    u_noise, z = _staged_noise(base_key, (BATCH, 1, L, A, R))

    np.random.seed(23)
    sample_j, cond_j = jexp.sample_n()
    np.random.seed(23)
    sample_t, cond_t = exp.sample_n(noise=(u_noise, z))
    np.testing.assert_allclose(cond_t, cond_j, **TOL)
    np.testing.assert_allclose(sample_t, sample_j, atol=1e-4 * np.abs(sample_j).max(), rtol=1e-4)


def test_load_energy_model_follows_cfg_energy_model(runs):
    """Two energy runs: changing ``cfg.energy_model`` reloads the energy
    model for sample_us and rebuilds the fused chain on it (the JAX
    package's fused path keeps the first one)."""
    other = runs.work / "runs" / "TinyE" / "energy2"
    if not other.exists():
        main([*_energy_args(runs.work, "energy2", seed=9, iterations=2)], device="cpu")
    exp = _port_experiment(runs)
    cond = np.full((3, 1), 0.5, np.float32)
    noise = [np.random.default_rng(1).normal(size=(BATCH, L)).astype(np.float32)]
    u1 = exp.sample_us(cond, BATCH, noise)
    first = exp.energy_model
    exp._fused_generator()
    gen1 = exp._fused_gen

    exp.cfg.energy_model = str(other)
    u2 = exp.sample_us(cond, BATCH, noise)
    assert exp.energy_model is not first and exp._energy_model_path == str(other)
    want = torch.load(other / "models" / "model_run0.pt", weights_only=True)["model"]
    for k, v in exp.energy_model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert not np.allclose(u1, u2)
    exp._fused_generator()
    assert exp._fused_gen is not gen1
    # the same path again: nothing reloaded
    model = exp.energy_model
    exp.sample_us(cond, BATCH, noise)
    assert exp.energy_model is model


def test_save_load_sample_round_trip_and_ds1_energies(runs, tmp_path):
    exp = object.__new__(CaloChallenge)
    exp.cfg = types.SimpleNamespace(run_dir=str(tmp_path), run_idx=3)
    rng = np.random.default_rng(4)
    showers, energies = rng.random((7, V)).astype(np.float32), rng.random((7, 1))
    exp.save_sample(showers, energies, name="_3")
    got_showers, got_energies = exp.load_sample()
    np.testing.assert_array_equal(got_showers, showers)
    np.testing.assert_array_equal(got_energies, energies)
    import h5py

    with h5py.File(tmp_path / "samples_3.hdf5") as f:
        assert f["showers"].compression == "gzip" and f["incident_energies"].compression == "gzip"

    np.random.seed(31)
    port = exp.generate_Einc_ds1(sample_multiplier=3)
    np.random.seed(31)
    ref = JaxCaloChallenge.generate_Einc_ds1(None, sample_multiplier=3)
    np.testing.assert_array_equal(port, ref)
    assert len(port) == 3 * 121


def test_launcher_plots_and_evaluates_tiny_ds2(runs, monkeypatch):
    """The launcher's default ``plot: true`` on the tiny geometry: train 2
    steps, sample 40 showers through the energy run (staged), save
    ``samples_0.hdf5`` and evaluate them into ``eval_0/`` (``eval_mode:
    cls-low``, as the JAX package's AUC-gate test runs it); then
    ``eval_sample`` on the saved file with the DNN on high-level features.
    Only the dataset's voxel count is adapted to the tiny geometry. The
    drawing modes and FPD/KPD are held against JAX in
    tests/test_torch_evaluation.py (matplotlib and 10,000-sample draws take
    minutes here)."""
    monkeypatch.setitem(ugr_evaluation.DATASET_NUM_FEATURES, "2", V)
    args = [a for a in _shape_args(runs.work, runs.energy, run="plotted", iterations=2)
            if not a.startswith("n_samples=")]
    exp = main([*args, "n_samples=40", "evaluation.eval_mode=cls-low",
                "evaluation.eval_cls_n_hidden=32", "evaluation.eval_cls_n_epochs=2",
                "evaluation.eval_cls_batch_size=16"], device="cpu")
    run = Path(exp.cfg.run_dir)
    assert exp.cfg.plot is True
    showers, energies = exp.load_sample()
    assert showers.shape == (40, V) and energies.shape == (40, 1)
    assert np.isfinite(showers).all() and (showers >= 0).all()
    exp.cfg.evaluation.eval_mode = "cls-high"
    exp.eval_sample()
    for key in ("cls-low", "cls-high"):
        text = (run / "eval_0" / f"classifier_{key}_{key}_2.txt").read_text()
        auc, jsd = (float(v) for v in text.split("\n")[1].split(" / "))
        assert 0.0 <= auc <= 1.0 and np.isfinite(jsd)
    shutil.rmtree(run)
