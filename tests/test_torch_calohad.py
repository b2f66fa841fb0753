"""CaloHadronic in the port against the JAX package, on the CPU.

- The ten dict-protocol transforms (the chains of calohadronic.yaml and
  calohadronic_energy.yaml on raw 30x180x180 ECal and 48x30x30 HCal events,
  ``CaloHadScaleTotalEnergy`` with the plain logit, ``AddLEMURSConditions``),
  forward and reverse, bit for bit, and ``build_pipeline``'s rule: a
  ``*FromFile`` step keeps an explicit ``model_dir``.
- ``CaloHadDataset``, ``CaloHadCollator`` and the batch iterator on tiny
  HDF5 files written here: the same batches for the same seed, bit for bit.
- A tiny ``CaloHadCFM`` (the shipped sections and patches: 30 + 576 = 606
  tokens x 75; depth 2, hidden 48, 2 heads) with JAX's parameters:
  velocity within atol 1e-5, ``batch_loss`` on JAX's own draws within 1e-5
  relative, every gradient within 1e-4 of its tensor's scale.
- The chain ([u | E]) against JAX ``make_fused_generate`` on JAX's noise,
  1e-4 of scale; the CaloHadronic u-twins (the (std + 1) standardization
  among them) against the staged dict steps, 1e-5.
- The launcher on ``calohadronic/calohadronic_energy`` and
  ``calohadronic/calohadronic`` with ``device=cpu`` (tiny nets, 3 steps):
  training, ``plot`` on the test set's u's (the classifier one epoch),
  ``sample_n`` on the energy run's u's staged and fused on the same noise
  (1e-5); ``calohadronic_ft`` raises.
- ``sample_n`` and ``plot`` against the JAX experiment built over the
  same runs, both packages' nets stubbed by the same fixed draws: the
  conditions each net is given (E, then [u | E] from ``sample_us`` or the
  test files), and what ``plot`` saves, evaluates and draws, bit for bit.
- ``evaluate_calohad`` against JAX's ``run_from_py``: the features, the
  pooled reference and the classifier's labelled inputs, bit for bit.
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

from vit4hep_tpu.data.calohadronic import datasets as jds
from vit4hep_tpu.data.calohadronic import transforms as jtf
from vit4hep_tpu.evaluation import calohadronic as jeval
from vit4hep_tpu.experiments.fused_chain import make_fused_generate as jax_make_fused_generate
from vit4hep_tpu.models.calohadronic import CaloHadCFM as JaxCaloHadCFM
from vit4hep_tpu.models.cfm import CFM as JaxCFM
from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer
from vit4hep_tpu.models.vit import ViT as JaxViT
from vit4hep_tpu_torch.data.calohadronic import datasets as tds
from vit4hep_tpu_torch.data.calohadronic import transforms as ttf
from vit4hep_tpu_torch.evaluation import calohadronic as teval
from vit4hep_tpu_torch.experiments.fused_chain import device_u_chain
from vit4hep_tpu_torch.experiments.main import get_experiment, main
from vit4hep_tpu_torch.models.calohadronic import CaloHadCFM
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import ViT
from vit4hep_tpu_torch.utils.config import Config, compose, instantiate
from vit4hep_tpu_torch.utils.jax_params import convert_energy_params, convert_vit_params
from vit4hep_tpu_torch.utils.serving import Generator

ROOT = Path(__file__).resolve().parent.parent
ODE = {"method": "rk4", "options": {"step_size": 0.5}}
ECAL_RAW, HCAL = (30, 180, 180), (48, 30, 30)
N_US = 58
# configs/model/cfm_calohad/cfm_calohad.yaml
SECTIONS = dict(list_shape=[[10, 15, 15], [48, 30, 30]], list_edges=[2250, 43200],
                list_patch_shape=[[5, 5, 3], [3, 5, 5]])
GRID = [[2, 3, 5], [16, 6, 6]]
SHAPE_TF = yaml.safe_load((ROOT / "configs/calohadronic/calohadronic.yaml").read_text())[
    "data"]["transforms"]
ENERGY_TF = yaml.safe_load((ROOT / "configs/calohadronic/calohadronic_energy.yaml").read_text(
))["data"]["transforms"]
SCALED_TF = {"SumPool3dDownScale": {}, "CaloHadNormalizeByElayer": {},
             "CaloHadScaleTotalEnergy": {"factor": 2.0},
             "CaloHadExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": False},
             "CaloHadStandardizeUsFromFile": {"n_us": N_US, "model_dir": None},
             "CaloHadPreprocessConds": {}, "AddLEMURSConditions": {}}


def _events(n, seed):
    """Raw CaloHadronic events: energy (GeV), ECal 30x180x180, HCal 48x30x30,
    depositing 0.7 E_inc."""
    rng = np.random.default_rng(seed)
    dt = np.dtype([("energy", np.float32), ("ecal", np.float32, ECAL_RAW),
                   ("hcal", np.float32, HCAL)])
    events = np.zeros(n, dt)
    events["energy"] = rng.uniform(10, 90, n)
    ecal = rng.exponential(1.0, (n, *ECAL_RAW)).astype(np.float32) * \
        (rng.random((n, *ECAL_RAW)) > 0.9)
    hcal = rng.exponential(1.0, (n, *HCAL)).astype(np.float32) * (rng.random((n, *HCAL)) > 0.5)
    scale = events["energy"] * 0.7 / (ecal.sum((1, 2, 3)) + hcal.sum((1, 2, 3)))
    events["ecal"] = ecal * scale[:, None, None, None]
    events["hcal"] = hcal * scale[:, None, None, None]
    return events


def _write(path, n, seed):
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("events", data=_events(n, seed))
    return str(path)


def _raw(n, seed):
    ev = _events(n, seed)
    return {"energy": np.asarray(ev["energy"]).reshape(n, 1), "ecal": np.asarray(ev["ecal"]),
            "hcal": np.asarray(ev["hcal"])}


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
                         ids=["calohadronic", "energy", "scaled-plain-logit"])
def test_transforms_match_jax(tmp_path, cfg):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    port, ref = ttf.build_pipeline(cfg, str(port_dir)), jtf.build_pipeline(cfg, str(jax_dir))
    assert [type(t).__name__ for t in port] == [type(t).__name__ for t in ref]
    d_port, d_ref = _raw(3, 0), _raw(3, 0)
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
    assert r_port.get("ecal", np.zeros((3, 10))).shape[1] == 10


def test_build_pipeline_keeps_an_explicit_model_dir(tmp_path):
    """CaloHadronic injects the run dir only where ``model_dir`` is unset
    (the other families overwrite it), in both packages."""
    cfg = {"CaloHadGlobalStandardizeFromFile": {"model_dir": str(tmp_path / "pretrained")},
           "CaloHadStandardizeUsFromFile": {"n_us": N_US, "model_dir": None}}
    for build in (ttf.build_pipeline, jtf.build_pipeline):
        glob, us = build(cfg, str(tmp_path / "run"))
        assert glob.model_dir == str(tmp_path / "pretrained")
        assert us.model_dir == str(tmp_path / "run")


def test_dataset_collator_and_iterator_match_jax(tmp_path):
    files = {"CaloHad": [_write(tmp_path / "a.h5", 5, 1), _write(tmp_path / "b.h5", 4, 2)]}
    port_ds, ref_ds = tds.CaloHadDataset(files, 2), jds.CaloHadDataset(files, 2)
    assert len(port_ds) == len(ref_ds) == 9
    idx = [7, 2, 4, 0]
    (pd, pc), (rd, rc) = port_ds.read_indices(idx), ref_ds.read_indices(idx)
    _dicts_equal(pd, rd)
    np.testing.assert_array_equal(pc, rc)
    for return_us, cfg in ((False, SHAPE_TF), (True, ENERGY_TF)):
        d_p, d_j = tmp_path / f"p{return_us}", tmp_path / f"j{return_us}"
        d_p.mkdir()
        d_j.mkdir()
        port_it = tds.CollatedBatchIterator(port_ds, tds.CaloHadCollator(
            files, ttf.build_pipeline(cfg, str(d_p)), return_us), 4, seed=3)
        ref_it = jds.CollatedBatchIterator(ref_ds, jds.CaloHadCollator(
            files, jtf.build_pipeline(cfg, str(d_j)), return_us), 4, seed=3)
        n = 0
        for (px, pcond), (rx, rcond) in zip(port_it.epoch_batches(), ref_it.epoch_batches()):
            np.testing.assert_array_equal(px, rx)
            np.testing.assert_array_equal(pcond, rcond)
            n += 1
        assert n == 2
        assert px.shape == ((4, N_US) if return_us else (4, 1, 45450))
        assert pcond.shape == ((4, 1) if return_us else (4, N_US + 1))


# ---------------------------------------------------------------------------
# the model and the chain
# ---------------------------------------------------------------------------
def _vit_param(fused_block=False):
    return dict(dim=3, condition_dim=N_US + 1, hidden_dim=48, out_channels=1, depth=2,
                num_heads=2, mlp_ratio=2, pos_embedding_coords="cylindrical",
                learn_pos_embed=True, causal_attn=False, num_patches=GRID, patch_dim=75,
                attn_impl="auto", fused_block=fused_block)


def _shape_pair(rng, fused_block=False):
    kw = dict(SECTIONS, shape=[45450], odeint_kwargs=ODE)
    jmodel = JaxCaloHadCFM(JaxViT(_vit_param(fused_block)), **kw)
    params = _perturb(jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)), rng, 0.1)
    model = CaloHadCFM(ViT(_vit_param(fused_block)), **kw)
    model.net.load_state_dict(convert_vit_params(params))
    return jmodel, params, model


def test_tiny_calohad_cfm_matches_jax():
    rng = np.random.default_rng(2)
    jmodel, params, model = _shape_pair(rng)
    assert model.token_shape(2) == jmodel.token_shape(2) == (2, 606, 75)
    assert model.param_count() == jmodel.param_count(params)
    b = 2
    x = rng.normal(size=(b, 1, 45450)).astype(np.float32)
    c = rng.normal(size=(b, N_US + 1)).astype(np.float32)
    tt = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    key = jax.random.PRNGKey(4)
    loss_ref, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.batch_loss(p, jnp.asarray(x), jnp.asarray(c), key)))(params)
    k_t, k_x0 = jax.random.split(key)  # the draws of JAX's batch_loss (models/cfm.py)
    t_j = jax.random.uniform(k_t, (b, 1, 1))
    x0_j = jax.random.normal(k_x0, x.shape)
    x_t, _ = jmodel.trajectory(x0_j, jnp.asarray(x), t_j)
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
    return dict(dims_in=N_US, dims_c=1, dim_embedding=64, nhead=2, num_encoder_layers=1,
                num_decoder_layers=1, dim_feedforward=32, activation="relu", embeds=False,
                encode_t_dim=16, encode_t_scale=30, fused_block="sample", fused_group=32)


def _fitted(tmp_path, tag, build, cfg):
    d = tmp_path / tag
    d.mkdir()
    steps = build(cfg, str(d))
    data = _raw(4, 6)
    for fn in steps:
        data = fn(data)
    return steps


def test_calohad_chain_matches_jax_fused_generate(tmp_path):
    shape_tf, energy_tf = (_fitted(tmp_path, f"p{i}", ttf.build_pipeline, c)
                           for i, c in enumerate((SHAPE_TF, ENERGY_TF)))
    jshape_tf, jenergy_tf = (_fitted(tmp_path, f"j{i}", jtf.build_pipeline, c)
                             for i, c in enumerate((SHAPE_TF, ENERGY_TF)))
    rng = np.random.default_rng(7)
    jshape, ps, shape = _shape_pair(rng, fused_block="sample")
    jenergy = JaxCFM(JaxParallelTransformer(_energy_param()), shape=[N_US], odeint_kwargs=ODE)
    pe = _perturb(jax.jit(jenergy.init_params)(jax.random.PRNGKey(3)), rng, 0.05)
    energy = CFM(ParallelTransformer(_energy_param()), shape=[N_US], odeint_kwargs=ODE)
    energy.net.load_state_dict(convert_energy_params(pe))
    b = 2
    gen = Generator(shape, energy, energy_tf, shape_tf, batch=b)
    assert gen.cond_dim == 1
    cond = rng.uniform(0, 1, (b, 1)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    shower_j, cond_j = jax.jit(jax_make_fused_generate(jshape, jenergy, jenergy_tf, jshape_tf))(
        ps, pe, jnp.asarray(cond), key)
    k_u, k_s = jax.random.split(key)
    noise = (torch.from_numpy(np.array(jax.random.normal(k_u, (b, N_US)))),
             torch.from_numpy(np.array(jax.random.normal(k_s, jshape.token_shape(b)))))
    shower_t, cond_t = gen.generate(cond, noise=noise)
    np.testing.assert_array_equal(cond_t.numpy()[:, N_US:], cond)  # [u | E]
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(shower_t.numpy(), np.asarray(shower_j),
                               atol=1e-4 * max(1.0, np.abs(shower_j).max()), rtol=1e-4)
    assert shower_t.shape == (b, 1, 45450)


@pytest.mark.parametrize("cfg", [ENERGY_TF, SCALED_TF], ids=["shipped", "scaled-plain-logit"])
def test_calohad_twins_match_the_staged_steps(tmp_path, cfg):
    e_steps = _fitted(tmp_path, "e", ttf.build_pipeline, cfg)
    s_steps = _fitted(tmp_path, "s", ttf.build_pipeline, SHAPE_TF)
    u = np.random.default_rng(9).normal(size=(5, N_US)).astype(np.float32)
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
def _common(work, name, seed):
    return [f"data_dir={work}", f"base_dir={work}", f"exp_name={name}", "run_name=run",
            f"seed={seed}", "training.batchsize=4", "training.batchsize_sample=4",
            "training.validate_every_n_steps=2", "training.iterations=3", "evaluate=false",
            "plotting.loss=false", "save_source=false", "n_samples=6",
            "model.odeint_kwargs.options.step_size=0.5", "evaluation.eval_cls_n_epochs=1",
            "evaluation.eval_cls_n_hidden=16"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launcher's energy run on calohadronic/calohadronic_energy, then
    its shape run on calohadronic/calohadronic (``plot`` on the test file's
    u's): (work dir, energy experiment, shape experiment)."""
    work = tmp_path_factory.mktemp("launch")
    data = work / "calohadronic"
    # the test file is the evaluation's reference too: 10 events a side
    for i, (name, n) in enumerate((("2", 4), ("3", 4), ("4", 4), ("10_test", 10))):
        _write(data / f"pions_ECAL+HCAL_10-90GeV_{name}.hdf5", n, 20 + i)
    energy = main(["-cn", "calohadronic/calohadronic_energy", *_common(work, "E", 4),
                   "plot=false", "model.net.param.nhead=2",
                   "model.net.param.num_encoder_layers=1", "model.net.param.num_decoder_layers=1",
                   "model.net.param.dim_feedforward=32", "model.net.param.encode_t_dim=16"],
                  device="cpu")
    shape = main(["-cn", "calohadronic/calohadronic", *_common(work, "S", 5),
                  "model.net.param.hidden_dim=24", "model.net.param.depth=1",
                  "model.net.param.num_heads=2", f"energy_model={work / 'runs' / 'E' / 'run'}"],
                 device="cpu")
    return work, energy, shape


def test_launcher_trains_samples_and_plots_calohadronic(runs):
    tmp_path, energy, shape = runs
    assert energy.state.step == 3 and all(math.isfinite(v) for v in energy.train_loss)
    run = tmp_path / "runs" / "S" / "run"
    assert shape.state.step == 3 and (run / "means.npy").exists()
    assert (run / "samples_0.hdf5").exists() and (run / "eval_0" / "classifier.txt").exists()

    shape.cfg.sample_us = True
    b, n = 4, 6
    gen = torch.Generator().manual_seed(0)
    noise = ([torch.randn(b, N_US, generator=gen) for _ in range(2)],
             [torch.randn(b, 606, 75, generator=gen) for _ in range(2)])
    e_inc = shape.draw_conditions(n, np.random.default_rng(0))
    assert ((e_inc >= 10) & (e_inc <= 90)).all()
    staged, cond = shape.sample_n(noise=noise, conditions=e_inc)
    shape.cfg.fused_generation = True
    fused, cond_f = shape.sample_n(noise=noise, conditions=e_inc)
    assert shape.last_sampling_fused is True
    assert staged.shape == (n, 1, 45450) and cond.shape == (n, N_US + 1)
    np.testing.assert_allclose(cond_f, cond, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(fused, staged, atol=1e-5 * np.abs(staged).max())
    showers = shape.to_showers(staged, cond)
    assert showers["ecal"].shape == (n, 10, 15, 15) and showers["hcal"].shape == (n, *HCAL)
    np.testing.assert_allclose(showers["energy"], e_inc, rtol=1e-5)
    assert get_experiment("calohadronic_ft").__name__ == "CaloHadronicFT"


# the sampling and plot of the port's experiment against JAX's: both nets
# replaced by the same fixed draws, so every array in between is host code
N_DRAWS = 6


def _jax_experiment(port, monkeypatch):
    """The JAX experiment over the port run's ``config.yaml`` and files (the
    port's fitted statistics read back), its energy net a stub."""
    from vit4hep_tpu.experiments import calohadronic as jexp
    from vit4hep_tpu.utils.config import OmegaConf as JaxOmegaConf

    monkeypatch.setattr(jexp, "load_net_params", lambda *a: ("energy net", None, False))
    exp = object.__new__(jexp.CaloHadronic)
    exp.cfg = JaxOmegaConf.load(str(Path(port.cfg.run_dir) / "config.yaml"))
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
    draws = {True: ((10 if energy_run else 1) * rng.normal(size=(16, N_US))).astype(np.float32),
             False: rng.normal(size=(16, *sample_shape)).astype(np.float32)}
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


@pytest.mark.parametrize("case", ["energy", "shape-sampled-us", "shape-test-us"])
def test_sampling_and_plot_match_the_jax_experiment(runs, monkeypatch, case):
    """``plot`` of both packages on the launcher's runs, from one seeded
    draw (numpy's global generator for JAX, the same stream handed to the
    port), the nets stubbed: the conditions each net is given (E to the
    energy net, [u | E] to the shape net, the u's mapped from the energy
    run's basis by ``sample_us`` or read from the test files), and the
    saved, evaluated and drawn arrays of the inverse chain (``to_showers``
    with the ECal/HCal split, ``energy_us``), bit for bit."""
    _, energy, shape = runs
    port = energy if case == "energy" else shape
    jexp = _jax_experiment(port, monkeypatch)
    for cfg in (port.cfg, jexp.cfg):
        cfg.n_samples, cfg.sample_us = N_DRAWS, case == "shape-sampled-us"
    port.cfg.fused_generation = False
    seen = _stub_nets(port, jexp, monkeypatch, (1, 45450))
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
        assert seen["port"][-1][1].shape[1] == N_US + 1
    assert sorted(got["port"]) == sorted(got["jax"]) == \
        (["drawn", "evaluated", "saved"] if case == "energy" else ["evaluated", "saved"])
    for key in got["jax"]:
        a, b = got["port"][key], got["jax"][key]
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            a, b = [a[k] for k in sorted(a)], [b[k] for k in sorted(b)]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_evaluation_matches_jax(tmp_path, monkeypatch):
    ref_file = _write(tmp_path / "ref.h5", 5, 30)
    cfg = Config({"run_dir": str(tmp_path), "run_idx": 0, "evaluation": {
        "eval_hdf5_file": ref_file, "eval_cls_lr": 2e-4, "eval_cls_batch_size": 1000,
        "eval_cls_n_epochs": 1, "eval_cls_n_layer": 2, "eval_cls_n_hidden": 16,
        "eval_cls_dropout": 0.0}})
    seen = {}
    monkeypatch.setattr(jeval, "run_dnn_classifier",
                        lambda a, b, ev, path: seen.setdefault("jax", (a, b)))
    monkeypatch.setattr(jeval, "ratio_panel", lambda *a, **kw: None)
    monkeypatch.setattr(teval, "run_dnn_classifier",
                        lambda a, b, ev, path, device: seen.setdefault("port", (a, b)))
    monkeypatch.setattr(teval, "_histograms", lambda *a: None)
    rng = np.random.default_rng(31)
    ecal = rng.exponential(1e-3, (6, 10, 15, 15)).astype(np.float32)
    hcal = rng.exponential(1e-3, (6, *HCAL)).astype(np.float32)
    energy = rng.uniform(10, 90, (6, 1)).astype(np.float32)
    from vit4hep_tpu.utils.config import OmegaConf as JaxOmegaConf

    jeval.run_from_py(ecal, hcal, energy, JaxOmegaConf.create(cfg.to_container()))
    teval.run_from_py(ecal, hcal, energy, cfg, device="cpu")
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    assert seen["port"][0].shape == (6, 5 + 58 + 1) and seen["port"][1].shape == (5, 64)
    ref = jds.load_data(h5py.File(ref_file, "r"))
    np.testing.assert_array_equal(teval._sum_pool_ecal(ref["ecal"]),
                                  jeval._sum_pool_ecal(ref["ecal"]))


# ---------------------------------------------------------------------------
# the shipped configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["cfm_calohad", "cfm_calohad_tpu", "cfm_calohad_energy"])
def test_shipped_configs_have_the_jax_parameter_counts(model):
    from vit4hep_tpu.utils.config import compose as jax_compose
    from vit4hep_tpu.utils.config import instantiate as jax_instantiate

    name = "calohadronic/calohadronic_energy" if model.endswith("energy") else \
        "calohadronic/calohadronic"
    overrides = ["data_dir=/nonexistent", f"model=cfm_calohad/{model}"]
    with torch.device("meta"):
        port = instantiate(compose(str(ROOT / "configs"), name, overrides)["model"])
    jmodel = jax_instantiate(jax_compose(str(ROOT / "configs"), name, overrides=overrides).model)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
    count = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    assert port.param_count() == count
    if model != "cfm_calohad_energy":
        assert isinstance(port, CaloHadCFM) and port.token_shape(2) == (2, 606, 75)
        assert port.condition_dim == N_US + 1


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FILE_KEYS = ("training_file", "test_file", "training_file_dict", "test_file_dict")


@pytest.mark.parametrize("run", ["shape", "energy"])
def test_chip_smoke_calohad_dicts_equal_yaml(run):
    """The smoke's CaloHadronic model, transforms, evaluation, training and
    data settings are the shipped YAML's (its file lists aside: the card
    gets synthetic events)."""
    smoke = _chip_smoke()
    f = smoke.FAMILIES["calohadronic"]
    name = {"shape": "calohadronic/calohadronic", "energy": "calohadronic/calohadronic_energy"}[run]
    cfg = compose(str(ROOT / "configs"), name, ["data_dir=${data_dir}"])
    raw = yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text())
    model = yaml.safe_load((ROOT / "configs" / "model" / f"{raw['defaults'][2]['/model']}.yaml"
                            ).read_text())
    assert f[run] == model
    assert f["energy_tf" if run == "energy" else "shape_tf"] == raw["data"]["transforms"]
    data = smoke._family_data("calohadronic", run)
    assert {k: v for k, v in data.items() if k not in FILE_KEYS} == \
        {k: v for k, v in raw["data"].items() if k not in FILE_KEYS}
    training = {k: (float(v) if k in ("eps", "lr") else v)  # YAML 1.1 reads 1e-8 as a string
                for k, v in cfg["training"].to_container().items()}
    if run == "shape":
        assert f["training"] == training and f["evaluation"] == raw["evaluation"]
    else:
        assert smoke.DS2_ENERGY_TRAINING == training
