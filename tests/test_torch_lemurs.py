"""LEMURS in the port against the JAX package, on the CPU.

- The seven dict-protocol transforms (the chains of lemurs.yaml and
  lemurs_energy_*.yaml, and ``LEMURSScaleTotalEnergy`` with the plain
  logit), forward and reverse, bit for bit, the fitted statistics too.
- ``LEMURSDataset``, ``LEMURSCollator`` and ``CollatedBatchIterator`` on
  tiny HDF5 files of two detectors written here (events (9, 16, 45)): the
  same rows and batches for the same indices and seed, bit for bit.
- A tiny ``LEMURSCFM`` (the shipped (45, 16, 9) grid in (3, 16, 1) patches:
  135 tokens x 48; depth 2, hidden 48, 2 heads) with JAX's parameters:
  velocity within atol 1e-5, ``batch_loss`` (its (B, H, W, L) -> (B, 1, L,
  W, H) move) on JAX's own draws within 1e-5 relative, every gradient
  within 1e-4 of its tensor's scale.
- The chain with ``energy_cond_width=3`` (the energy model sees [E, theta,
  phi], the shape model [u | E, theta, phi | labels]) against JAX
  ``make_fused_generate`` on JAX's noise, 1e-4; the LEMURS u-twins against
  the staged dict steps, 1e-5.
- The launcher on ``lemurs/lemurs_energy_ODD`` and ``lemurs/lemurs`` with
  ``device=cpu`` (tiny nets, 3 steps, every file of the configs written
  with 4 or 8 events): training, ``plot`` on the test set's u's (cls-high one
  epoch), ``sample_n`` on the energy run's u's staged and fused on the same
  noise (1e-5); the energy run again with ``data.native_cache`` set trains
  to the same losses, bit for bit, from its record caches.
- ``sample_n`` and ``plot`` against the JAX experiment built over the
  same runs, both packages' nets stubbed by the same fixed draws: the
  conditions each net is given ([E, theta, phi] to the energy net, [u | E,
  theta, phi | labels] to the shape net, u's from ``sample_us`` or the test
  files), and what ``plot`` saves, evaluates and draws, bit for bit.
- ``evaluate_lemurs`` against JAX's ``run_from_py``: the classifiers' and
  FPD/KPD's inputs, bit for bit.
- The shipped configs compose, build, and give JAX's parameter counts.
"""

import math
from pathlib import Path
from types import SimpleNamespace

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.conftest import make_binning_xml
from vit4hep_tpu.data.lemurs import datasets as jds
from vit4hep_tpu.data.lemurs import transforms as jtf
from vit4hep_tpu.evaluation import lemurs as jeval
from vit4hep_tpu.experiments.fused_chain import make_fused_generate as jax_make_fused_generate
from vit4hep_tpu.models.cfm import CFM as JaxCFM
from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer
from vit4hep_tpu.models.lemurs import LEMURSCFM as JaxLEMURSCFM
from vit4hep_tpu.models.vit import ViT as JaxViT
from vit4hep_tpu_torch.data.lemurs import datasets as tds
from vit4hep_tpu_torch.data.lemurs import transforms as ttf
from vit4hep_tpu_torch.evaluation import lemurs as teval
from vit4hep_tpu_torch.experiments.fused_chain import device_u_chain
from vit4hep_tpu_torch.experiments.main import main
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.lemurs import LEMURSCFM
from vit4hep_tpu_torch.models.vit import ViT
from vit4hep_tpu_torch.utils.config import Config, compose, instantiate
from vit4hep_tpu_torch.utils.jax_params import convert_energy_params, convert_vit_params
from vit4hep_tpu_torch.utils.serving import Generator

ROOT = Path(__file__).resolve().parent.parent
ODE = {"method": "rk4", "options": {"step_size": 0.25}}
H, W, L = 9, 16, 45
SHAPE_TF = yaml.safe_load((ROOT / "configs/lemurs/lemurs.yaml").read_text())["data"][
    "transforms"]
ENERGY_TF = yaml.safe_load((ROOT / "configs/lemurs/lemurs_energy_ODD.yaml").read_text())[
    "data"]["transforms"]
SCALED_TF = {"LEMURSNormalizeByElayer": {}, "LEMURSScaleTotalEnergy": {"factor": 0.5},
             "LEMURSExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": False},
             "LEMURSStandardizeUsFromFile": {"n_us": L, "model_dir": None},
             "LEMURSPreprocessConds": {}}
COND_KEYS = ("incident_energy", "incident_theta", "incident_phi")


def _events(n, seed):
    """Raw LEMURS events as a structured table: showers (n, H, W, L) in MeV
    summing to 0.7 E_inc."""
    rng = np.random.default_rng(seed)
    dt = np.dtype([(k, np.float32) for k in COND_KEYS] + [("showers", np.float32, (H, W, L))])
    events = np.zeros(n, dt)
    events["incident_energy"] = 10 ** rng.uniform(3, 6, n)
    events["incident_theta"] = rng.uniform(0.9, 2.2, n)
    events["incident_phi"] = rng.uniform(-3.1, 3.1, n)
    showers = rng.exponential(1.0, (n, H, W, L)) * (rng.random((n, H, W, L)) > 0.3)
    showers = showers / showers.sum((1, 2, 3), keepdims=True).clip(1e-9)
    events["showers"] = showers * events["incident_energy"][:, None, None, None] * 0.7
    return events


def _write(path, n, seed):
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("events", data=_events(n, seed))
    return str(path)


def _raw(n, seed):
    ev = _events(n, seed)
    return {k: np.asarray(ev[k]).reshape(n, -1) if k != "showers" else np.asarray(ev[k])
            for k in (*COND_KEYS, "showers")}


def _dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _perturb(params, rng, std):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        params)


# ---------------------------------------------------------------------------
# transforms, dataset, collator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [SHAPE_TF, ENERGY_TF, SCALED_TF],
                         ids=["lemurs", "energy", "scaled-plain-logit"])
def test_transforms_match_jax(tmp_path, cfg):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    port, ref = ttf.build_pipeline(cfg, str(port_dir)), jtf.build_pipeline(cfg, str(jax_dir))
    assert [type(t).__name__ for t in port] == [type(t).__name__ for t in ref]
    d_port, d_ref = _raw(10, 0), _raw(10, 0)
    d_port["label"] = d_ref["label"] = np.eye(5, dtype=np.float32)[np.arange(10) % 5]
    for p, r in zip(port, ref):
        d_port, d_ref = p(d_port), r(d_ref)
        _dicts_equal(d_port, d_ref)
    for name in ("means.npy", "stds.npy", "means_u.npy", "stds_u.npy"):
        assert (port_dir / name).exists() == (jax_dir / name).exists()
        if (jax_dir / name).exists():
            np.testing.assert_array_equal(np.load(port_dir / name), np.load(jax_dir / name))
    noisy = {k: v + np.float32(0.05) for k, v in d_port.items()}
    r_port, r_ref = dict(noisy), {k: v.copy() for k, v in noisy.items()}
    for p, r in zip(port[::-1], ref[::-1]):
        r_port, r_ref = p(r_port, rev=True), r(r_ref, rev=True)
        _dicts_equal(r_port, r_ref)


@pytest.fixture
def files(tmp_path):
    return {"DetA": [_write(tmp_path / "a1.h5", 12, 1), _write(tmp_path / "a2.h5", 9, 2)],
            "DetB": [_write(tmp_path / "b1.h5", 11, 3)]}


@pytest.mark.parametrize("return_us", [False, True], ids=["shape", "energy"])
def test_dataset_collator_and_iterator_match_jax(tmp_path, files, return_us):
    port_ds, ref_ds = tds.LEMURSDataset(files, 2), jds.LEMURSDataset(files, 2)
    assert len(port_ds) == len(ref_ds) == 32 and port_ds.index_map == ref_ds.index_map
    idx = np.random.default_rng(4).permutation(32)[:13]
    (pd, pc), (rd, rc) = port_ds.read_indices(idx), ref_ds.read_indices(idx)
    _dicts_equal(pd, rd)
    np.testing.assert_array_equal(pc, rc)
    cfg = ENERGY_TF if return_us else SHAPE_TF
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    port_c = tds.LEMURSCollator(files, ttf.build_pipeline(cfg, str(tmp_path / "p")), 2,
                                return_us=return_us)
    ref_c = jds.LEMURSCollator(files, jtf.build_pipeline(cfg, str(tmp_path / "j")), 2,
                               return_us=return_us)
    port_it = tds.CollatedBatchIterator(port_ds, port_c, 8, seed=5)
    ref_it = jds.CollatedBatchIterator(ref_ds, ref_c, 8, seed=5)
    for (px, pcond), (rx, rcond) in zip(port_it.epoch_batches(), ref_it.epoch_batches()):
        np.testing.assert_array_equal(px, rx)
        np.testing.assert_array_equal(pcond, rcond)
    assert px.shape == ((8, L) if return_us else (8, H, W, L))
    assert pcond.shape == ((8, 3) if return_us else (8, L + 3 + 2))
    # in-memory events with the same read_indices
    arrays = tds.ArrayEvents({label: tds.read_first_file({label: fs}) for label, fs in
                              {"DetA": files["DetA"][:1], "DetB": files["DetB"]}.items()})
    data, classes = arrays.read_indices([0, 13, 5])
    assert list(classes) == [0, 1, 0] and data["showers"].shape == (3, H, W, L)


# ---------------------------------------------------------------------------
# the model and the chain
# ---------------------------------------------------------------------------
def _vit_param(fused_block=False):
    return dict(dim=3, condition_dim=L + 8, hidden_dim=48, out_channels=1, depth=2, num_heads=2,
                mlp_ratio=2, pos_embedding_coords="cylindrical", learn_pos_embed=True,
                causal_attn=False, num_patches=[[15, 1, 9]], patch_dim=48, attn_impl="auto",
                fused_block=fused_block)


def _shape_pair(rng, fused_block=False):
    kw = dict(patch_shape=[3, 16, 1], shape=[L, W, H], odeint_kwargs=ODE)
    jmodel = JaxLEMURSCFM(JaxViT(_vit_param(fused_block)), **kw)
    params = _perturb(jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)), rng, 0.1)
    model = LEMURSCFM(ViT(_vit_param(fused_block)), **kw)
    model.net.load_state_dict(convert_vit_params(params))
    return jmodel, params, model


def test_tiny_lemurs_cfm_matches_jax():
    rng = np.random.default_rng(2)
    jmodel, params, model = _shape_pair(rng)
    assert model.token_shape(2) == jmodel.token_shape(2) == (2, 135, 48)
    b = 2
    x = rng.normal(size=(b, H, W, L)).astype(np.float32)  # LEMURS's layout
    c = rng.normal(size=(b, L + 8)).astype(np.float32)
    tt = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    key = jax.random.PRNGKey(4)
    loss_ref, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.batch_loss(p, jnp.asarray(x), jnp.asarray(c), key)))(params)
    k_t, k_x0 = jax.random.split(key)  # the draws of JAX's batch_loss, in the moved layout
    t_j = jax.random.uniform(k_t, (b, 1, 1, 1, 1))
    x0_j = jax.random.normal(k_x0, (b, 1, L, W, H))
    x_moved = np.transpose(x, (0, 3, 2, 1))[:, None]
    x_t, _ = jmodel.trajectory(x0_j, jnp.asarray(x_moved), t_j)
    v_ref = np.asarray(jax.jit(jmodel.forward)(params, x_t, t_j.reshape(-1, 1), c))
    with torch.no_grad():
        v = model(tt(x_t), tt(t_j).reshape(-1, 1), tt(c))
    np.testing.assert_allclose(v.numpy(), v_ref, atol=1e-5)
    loss = model.batch_loss(tt(x), tt(c), t=tt(t_j), x_0=tt(x0_j))
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= 1e-5 * float(loss_ref)
    want = convert_vit_params(grads)
    for k, p in model.net.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=k)


def _energy_param():
    # without embeds the one-hot layout needs dim_embedding > dims_in
    return dict(dims_in=L, dims_c=3, dim_embedding=64, nhead=2, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=32, activation="relu", embeds=False,
                encode_t_dim=16, encode_t_scale=30, fused_block="sample", fused_group=32)


def _fitted(tmp_path, tag, build, cfg):
    d = tmp_path / tag
    d.mkdir()
    steps = build(cfg, str(d))
    data = _raw(24, 6)
    data["label"] = np.eye(5, dtype=np.float32)[np.arange(24) % 5]
    for fn in steps:
        data = fn(data)
    return steps


def test_lemurs_chain_matches_jax_fused_generate(tmp_path):
    shape_tf, energy_tf = (_fitted(tmp_path, f"p{i}", ttf.build_pipeline, c)
                           for i, c in enumerate((SHAPE_TF, ENERGY_TF)))
    jshape_tf, jenergy_tf = (_fitted(tmp_path, f"j{i}", jtf.build_pipeline, c)
                             for i, c in enumerate((SHAPE_TF, ENERGY_TF)))
    rng = np.random.default_rng(7)
    jshape, ps, shape = _shape_pair(rng, fused_block="sample")
    jenergy = JaxCFM(JaxParallelTransformer(_energy_param()), shape=[L], odeint_kwargs=ODE)
    pe = _perturb(jax.jit(jenergy.init_params)(jax.random.PRNGKey(3)), rng, 0.05)
    energy = CFM(ParallelTransformer(_energy_param()), shape=[L], odeint_kwargs=ODE)
    energy.net.load_state_dict(convert_energy_params(pe))
    b = 2
    gen = Generator(shape, energy, energy_tf, shape_tf, batch=b, energy_cond_width=3)
    assert gen.cond_dim == 8
    cond = np.concatenate([rng.uniform(0, 1, (b, 3)),
                           np.eye(5)[[0, 3]]], axis=1).astype(np.float32)
    key = jax.random.PRNGKey(8)
    shower_j, cond_j = jax.jit(jax_make_fused_generate(
        jshape, jenergy, jenergy_tf, jshape_tf, energy_cond_width=3))(ps, pe, jnp.asarray(cond),
                                                                      key)
    k_u, k_s = jax.random.split(key)
    noise = (torch.from_numpy(np.array(jax.random.normal(k_u, (b, L)))),
             torch.from_numpy(np.array(jax.random.normal(k_s, jshape.token_shape(b)))))
    shower_t, cond_t = gen.generate(cond, noise=noise)
    np.testing.assert_array_equal(cond_t.numpy()[:, L:], cond)  # [u | E, theta, phi | labels]
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(shower_t.numpy(), np.asarray(shower_j),
                               atol=1e-4 * max(1.0, np.abs(shower_j).max()), rtol=1e-4)
    assert shower_t.shape == (b, 1, L, W, H)


@pytest.mark.parametrize("cfg", [ENERGY_TF, SCALED_TF], ids=["shipped", "scaled-plain-logit"])
def test_lemurs_twins_match_the_staged_steps(tmp_path, cfg):
    """The energy chain reversed then the shape chain forward, on the
    device against the staged u-only dict (``LEMURSStandardizeUsFromFile``,
    ``LEMURSScaleTotalEnergy``, both logits, ``LEMURSGlobalStandardizeFromFile``)."""
    e_steps = _fitted(tmp_path, "e", ttf.build_pipeline, cfg)
    s_steps = _fitted(tmp_path, "s", ttf.build_pipeline, SHAPE_TF)
    u = np.random.default_rng(9).normal(size=(5, L)).astype(np.float32)
    ref = {"extra_dims": u.copy()}
    for fn in e_steps[::-1]:
        if hasattr(fn, "u_transform"):
            ref = fn(ref, rev=True)
    for fn in s_steps:
        if hasattr(fn, "u_transform"):
            ref = fn(ref)
    got = device_u_chain(e_steps, s_steps)(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), ref["extra_dims"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the launcher and the evaluation
# ---------------------------------------------------------------------------
def _write_config_files(work, name):
    """Every file the composed config names (training files 4 events, test
    files 8: a validation batch of 8), and the ds2 binning file of the
    evaluation's features."""
    cfg = compose(str(ROOT / "configs"), name, [f"data_dir={work}"])
    seed = 10
    for key, n in (("training_file_dict", 4), ("test_file_dict", 8)):
        for paths in cfg.data[key].values():
            for p in paths:
                seed += 1
                if not Path(p).exists():
                    _write(Path(p), n, seed)
    if not Path(str(cfg.evaluation.eval_hdf5_file)).exists():
        _write(Path(str(cfg.evaluation.eval_hdf5_file)), 24, 99)
    make_binning_xml(Path(str(cfg.data.xml_filename)), "electron", L, H, W)


def _common(work, name, seed):
    return [f"data_dir={work}", f"base_dir={work}", f"exp_name={name}", "run_name=run",
            f"seed={seed}", "training.batchsize=8", "training.batchsize_sample=8",
            "training.validate_every_n_steps=2", "training.iterations=3", "evaluate=false",
            "plotting.loss=false", "save_source=false", "n_samples=10",
            "model.odeint_kwargs.options.step_size=0.5", "evaluation.eval_cls_n_epochs=1",
            "evaluation.eval_cls_n_hidden=16", "data.max_files_per_worker=4"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launcher's energy run on lemurs/lemurs_energy_ODD, then its shape
    run on lemurs/lemurs (``plot`` on the test set's u's, cls-high one
    epoch): (work dir, energy experiment, shape experiment)."""
    work = tmp_path_factory.mktemp("launch")
    _write_config_files(work, "lemurs/lemurs_energy_ODD")
    _write_config_files(work, "lemurs/lemurs")
    energy = main(["-cn", "lemurs/lemurs_energy_ODD", *_common(work, "E", 4), "plot=false",
                   "model.net.param.nhead=2",
                   "model.net.param.num_encoder_layers=1", "model.net.param.num_decoder_layers=1",
                   "model.net.param.dim_feedforward=32", "model.net.param.encode_t_dim=16"],
                  device="cpu")
    shape = main(["-cn", "lemurs/lemurs", *_common(work, "S", 5),
                  "model.net.param.hidden_dim=24", "model.net.param.depth=1",
                  "model.net.param.num_heads=2", f"energy_model={work / 'runs' / 'E' / 'run'}",
                  "evaluation.eval_mode=cls-high"], device="cpu")
    return work, energy, shape


def test_launcher_trains_samples_and_plots_lemurs(runs):
    tmp_path, energy, shape = runs
    assert energy.state.step == 3 and all(math.isfinite(v) for v in energy.train_loss)
    energy_run = tmp_path / "runs" / "E" / "run"
    assert (energy_run / "means_u.npy").exists()
    run = tmp_path / "runs" / "S" / "run"
    assert shape.state.step == 3 and (run / "means.npy").exists()
    assert (run / "samples_0.hdf5").exists()
    assert (run / "eval_0" / "classifier_cls-high_cls-high_LEMURS.txt").exists()

    shape.cfg.sample_us = True
    b, n = 8, 10
    gen = torch.Generator().manual_seed(0)
    noise = ([torch.randn(b, L, generator=gen) for _ in range(2)],
             [torch.randn(b, 135, 48, generator=gen) for _ in range(2)])
    conds = shape.draw_conditions(n, np.random.default_rng(0))
    assert np.all((conds[2] >= 0.87 - 1e-6) & (conds[2] <= 2.27 + 1e-6))
    staged, cond = shape.sample_n(noise=noise, conditions=conds)
    shape.cfg.fused_generation = True
    fused, cond_f = shape.sample_n(noise=noise, conditions=conds)
    assert shape.last_sampling_fused is True
    assert staged.shape == (n, 1, L, W, H) and cond.shape == (n, L + 8)
    np.testing.assert_array_equal(cond[:, L + 3:], np.tile([1, 0, 0, 0, 0], (n, 1)))
    np.testing.assert_allclose(cond_f, cond, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(fused, staged, atol=1e-5 * np.abs(staged).max())
    data = shape.to_showers(staged, cond)
    assert data["showers"].shape == (n, H, W, L) and np.isfinite(data["showers"]).all()
    np.testing.assert_allclose(data["incident_energy"], conds[0], rtol=1e-4)

    # the energy run again with data.native_cache: its batches come from the
    # record caches, so its training is the first run's, bit for bit
    cache = tmp_path / "cache"
    cached = main(["-cn", "lemurs/lemurs_energy_ODD", *_common(tmp_path, "C", 4), "plot=false",
                   "model.net.param.nhead=2", "model.net.param.num_encoder_layers=1",
                   "model.net.param.num_decoder_layers=1", "model.net.param.dim_feedforward=32",
                   "model.net.param.encode_t_dim=16", f"data.native_cache={cache}"],
                  device="cpu")
    assert cached.state.step == 3 and cached.train_loss == energy.train_loss
    assert cached.val_loss == energy.val_loss
    assert sorted(p.suffix for p in cache.iterdir()) == [".v4cache", ".v4cache"]


# the sampling and plot of the port's experiment against JAX's: both nets
# replaced by the same fixed draws, so every array in between is host code
N_DRAWS = 10


def _jax_experiment(port, monkeypatch):
    """The JAX experiment over the port run's ``config.yaml`` and files (the
    port's fitted statistics read back), its energy net a stub."""
    from vit4hep_tpu.experiments import lemurs as jexp
    from vit4hep_tpu.utils.config import OmegaConf as JaxOmegaConf

    monkeypatch.setattr(jexp, "load_net_params", lambda *a: ("energy net", None, False))
    exp = object.__new__(jexp.LEMURS)
    exp.cfg = JaxOmegaConf.load(str(Path(port.cfg.run_dir) / "config.yaml"))
    # YAML 1.1 reads 1e3 as a string, which numpy's global draw cannot take
    exp.cfg.data.gen_Einc = [float(v) for v in exp.cfg.data.gen_Einc]
    exp.rank, exp.base_key, exp.state = 0, jax.random.PRNGKey(0), SimpleNamespace(params=None)
    exp.model = "energy net" if port.cfg.model_type == "energy" else "shape net"
    exp.init_data()
    return exp


def _stub_nets(port, jexp, monkeypatch, sample_shape):
    """Both packages' sampling nets give the same fixed draws (an energy
    net U, a shape net S); each call's conditions are recorded."""
    energy_run = port.cfg.model_type == "energy"
    rng = np.random.default_rng(0)
    # an energy run's u's wide, so that energy_us's clip to [0, 1] acts
    draws = {True: ((10 if energy_run else 1) * rng.normal(size=(64, L))).astype(np.float32),
             False: rng.normal(size=(64, *sample_shape)).astype(np.float32)}
    seen = {"port": [], "jax": []}

    def draw(tag, energy, conds):
        seen[tag].append((energy, np.array(conds)))
        return draws[energy][:len(conds)].copy()

    monkeypatch.setattr(port, "_sample_in_batches", lambda model, conds, bs, noise=None: draw(
        "port", energy_run or model is not port.model, conds))
    monkeypatch.setattr(jexp, "_sample_in_batches", lambda model, params, conds, key, bs: draw(
        "jax", model == "energy net", conds))
    return seen


def _capture_plot(port, jexp, monkeypatch):
    """What each package's ``plot`` saves, evaluates and draws."""
    from vit4hep_tpu.evaluation import us_evaluation as jus
    from vit4hep_tpu_torch.evaluation import us_evaluation as tus

    got = {"port": {}, "jax": {}}
    for tag, exp, ev, us in (("port", port, teval, tus), ("jax", jexp, jeval, jus)):
        put = got[tag].__setitem__
        monkeypatch.setattr(exp, "save_sample", lambda d, name="", put=put: put(
            "saved", {k: np.array(v) for k, v in d.items()}))
        monkeypatch.setattr(ev, "run_from_py", lambda *a, put=put, **kw: put("evaluated", a[:-1]))
        monkeypatch.setattr(us, "plot_ui_dists", lambda *a, put=put, **kw: put("drawn", a))
        monkeypatch.setattr(us, "eval_ui_dists", lambda *a, put=put, **kw: put("evaluated", a))
    return got


def _assert_same_arrays(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["energy", "shape-sampled-us", "shape-test-us"])
def test_sampling_and_plot_match_the_jax_experiment(runs, monkeypatch, case):
    """``plot`` of both packages on the launcher's runs, from one seeded
    draw (numpy's global generator for JAX, the same stream handed to the
    port), the nets stubbed: the conditions each net is given ([E, theta,
    phi] to the energy net, [u | E, theta, phi | labels] to the shape net,
    the u's mapped from the energy run's basis by ``sample_us`` or read from
    the test files), and the saved, evaluated and drawn arrays of the
    inverse chain (``to_showers``, ``energy_us``), bit for bit."""
    _, energy, shape = runs
    port = energy if case == "energy" else shape
    jexp = _jax_experiment(port, monkeypatch)
    for cfg in (port.cfg, jexp.cfg):
        cfg.n_samples, cfg.sample_us = N_DRAWS, case == "shape-sampled-us"
    port.cfg.fused_generation = False
    seen = _stub_nets(port, jexp, monkeypatch, (1, L, W, H))
    got = _capture_plot(port, jexp, monkeypatch)
    monkeypatch.setattr(port, "conditions_rng", lambda: np.random.RandomState(7))
    np.random.seed(7)
    jexp.plot()
    port.plot()
    kinds = {"energy": [True], "shape-sampled-us": [True, False], "shape-test-us": [False]}
    assert [e for e, _ in seen["port"]] == [e for e, _ in seen["jax"]] == kinds[case]
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    if case != "energy":
        assert seen["port"][-1][1].shape[1] == L + 3 + 5
    assert sorted(got["port"]) == sorted(got["jax"]) == \
        (["drawn", "evaluated", "saved"] if case == "energy" else ["evaluated", "saved"])
    for key in got["jax"]:
        _assert_same_arrays(got["port"][key], got["jax"][key])


@pytest.mark.parametrize("mode", ["all-cls", "fpd"])
def test_evaluation_matches_jax(tmp_path, monkeypatch, mode):
    ref_file = _write(tmp_path / "ref.h5", 40, 12)
    make_binning_xml(tmp_path / "binning.xml", "electron", L, H, W)
    cfg = Config({"run_dir": str(tmp_path), "run_idx": 0,
                  "data": {"xml_filename": str(tmp_path / "binning.xml")},
                  "evaluation": {
                      "eval_hdf5_file": ref_file, "eval_mode": mode, "eval_dataset": "2",
                      "eval_cut": 0.015, "eval_energy_bin": [1e3, 1e5],
                      "eval_theta_bin": [0.87, 2.27], "eval_phi_bin": None,
                      "eval_labels": ["ViT-CFM"], "eval_p_label": "", "eval_cls_lr": 2e-4,
                      "eval_cls_batch_size": 1000, "eval_cls_n_epochs": 1, "eval_cls_n_layer": 2,
                      "eval_cls_n_hidden": 16, "eval_cls_dropout": 0.0}})
    seen = {"jax": [], "port": []}
    for tag, mod in (("jax", jeval), ("port", teval)):
        monkeypatch.setattr(mod, "_run_classifier",
                            lambda key, a, b, arg, tag=tag: seen[tag].append((key, a, b)) or
                            (0.5, 0.5, 0.0))
        monkeypatch.setattr(mod, "fpd", lambda r, s, tag=tag, **kw: seen[tag].append(
            ("fpd", r, s)) or (0.0, 0.0))
        monkeypatch.setattr(mod, "kpd", lambda r, s, tag=tag, **kw: seen[tag].append(
            ("kpd", r, s)) or (0.0, 0.0))
    sample = _events(30, 13)
    args = (np.asarray(sample["showers"]),
            *(np.asarray(sample[k]).reshape(-1, 1) for k in COND_KEYS))
    from vit4hep_tpu.utils.config import OmegaConf as JaxOmegaConf

    jeval.run_from_py(*args, JaxOmegaConf.create(cfg.to_container()))
    teval.run_from_py(*args, cfg, device="cpu")
    assert len(seen["port"]) == len(seen["jax"]) == (3 if mode == "all-cls" else 2)
    for (pk, pa, pb), (jk, ja, jb) in zip(seen["port"], seen["jax"]):
        assert pk == jk
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pb, jb)


# ---------------------------------------------------------------------------
# the shipped configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["cfm_lemurs", "cfm_lemurs_tpu", "cfm_lemurs_energy"])
def test_shipped_configs_have_the_jax_parameter_counts(model):
    from vit4hep_tpu.utils.config import compose as jax_compose
    from vit4hep_tpu.utils.config import instantiate as jax_instantiate

    name = "lemurs/lemurs_energy_ODD" if model.endswith("energy") else "lemurs/lemurs"
    overrides = ["data_dir=/nonexistent", f"model=cfm_lemurs/{model}"]
    with torch.device("meta"):
        port = instantiate(compose(str(ROOT / "configs"), name, overrides)["model"])
    jmodel = jax_instantiate(jax_compose(str(ROOT / "configs"), name, overrides=overrides).model)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
    count = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    assert port.param_count() == count
    if model != "cfm_lemurs_energy":
        assert isinstance(port, LEMURSCFM) and port.token_shape(2) == (2, 135, 48)
        assert port.condition_dim == 53


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FILE_KEYS = ("training_file", "test_file", "training_file_dict", "test_file_dict")


@pytest.mark.parametrize("run", ["shape", "energy"])
def test_chip_smoke_lemurs_dicts_equal_yaml(run):
    """The smoke's LEMURS model, transforms, evaluation, training and
    data settings are the shipped YAML's (its file lists aside: the card
    gets synthetic events)."""
    smoke = _chip_smoke()
    f = smoke.FAMILIES["lemurs"]
    name = {"shape": "lemurs/lemurs", "energy": "lemurs/lemurs_energy_ODD"}[run]
    cfg = compose(str(ROOT / "configs"), name, ["data_dir=${data_dir}"])
    raw = yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text())
    model = yaml.safe_load((ROOT / "configs" / "model" / f"{raw['defaults'][2]['/model']}.yaml"
                            ).read_text())
    assert f[run] == model
    assert f["energy_tf" if run == "energy" else "shape_tf"] == raw["data"]["transforms"]
    data = smoke._family_data("lemurs", run)
    assert {k: v for k, v in data.items() if k not in FILE_KEYS} == \
        {k: v for k, v in raw["data"].items() if k not in FILE_KEYS}
    training = {k: (float(v) if k in ("eps", "lr") else v)  # YAML 1.1 reads 1e-8 as a string
                for k, v in cfg["training"].to_container().items()}
    if run == "shape":
        assert f["training"] == training and f["evaluation"] == raw["evaluation"]
    else:
        assert smoke.DS2_ENERGY_TRAINING == training
