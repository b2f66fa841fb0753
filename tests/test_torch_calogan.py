"""CaloGAN in the port against the JAX package, on the CPU.

- The five dict-protocol transforms, forward and reverse, and
  ``build_pipeline`` (run dir injected into every ``*FromFile`` step, the
  statistics fitted and written on the first call) bit for bit.
- ``CaloGANDataset`` on a tiny HDF5 file written here (layers (N, 3, 96),
  (N, 12, 12), (N, 12, 6)), for the shape and the energy model, bit for bit.
- A tiny ``CaloGANCFM`` (the shipped sections and patch shapes: 84 tokens x
  6; depth 2, hidden 48, 2 heads) with JAX's parameters carried across:
  velocity within atol 1e-5, ``batch_loss`` on JAX's own draws of t and x_0
  within 1e-5 relative and every gradient within 1e-4 of its tensor's scale
  (f32 both sides, summation order only).
- The two-stage chain with ``u_position="last"`` ([E | u], the staged
  ``sample_n``'s order) against JAX ``make_fused_generate`` on JAX's noise,
  1e-4 (JAX's Pallas ViT in interpret mode against the port's K2v path);
  the CaloGAN u-twins against the staged dict steps, 1e-5.
- The launcher on ``calogan/calogan_eplus_energy`` and ``calogan/calogan``
  with ``device=cpu`` (tiny nets, 3 steps): training, ``plot`` (the truth
  u's, the classifier one epoch), then ``sample_n`` on the energy run's
  u's, staged and fused on the same noise (1e-5).
- ``sample_n`` and ``plot`` against the JAX experiment built over the
  same runs, both packages' nets stubbed by the same fixed draws: the
  conditions each net is given (E, then [E | u] from ``sample_us`` or the
  test file), and what ``plot`` evaluates and draws, bit for bit.
- ``evaluate_calogan`` against JAX's ``eval_calogan_lowlevel``: the same
  labelled classifier inputs, bit for bit.
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

from vit4hep_tpu.data.calogan import datasets as jds
from vit4hep_tpu.data.calogan import transforms as jtf
from vit4hep_tpu.evaluation import calogan as jeval
from vit4hep_tpu.experiments.fused_chain import make_fused_generate as jax_make_fused_generate
from vit4hep_tpu.models.calogan import CaloGANCFM as JaxCaloGANCFM
from vit4hep_tpu.models.cfm import CFM as JaxCFM
from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer
from vit4hep_tpu.models.vit import ViT as JaxViT
from vit4hep_tpu_torch.data.calogan import datasets as tds
from vit4hep_tpu_torch.data.calogan import transforms as ttf
from vit4hep_tpu_torch.evaluation import calogan as teval
from vit4hep_tpu_torch.experiments.fused_chain import device_u_chain
from vit4hep_tpu_torch.experiments.main import get_experiment, main
from vit4hep_tpu_torch.models.calogan import CaloGANCFM
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import ViT
from vit4hep_tpu_torch.utils.config import Config, compose, instantiate
from vit4hep_tpu_torch.utils.jax_params import convert_energy_params, convert_vit_params
from vit4hep_tpu_torch.utils.serving import Generator

ROOT = Path(__file__).resolve().parent.parent
ODE = {"method": "rk4", "options": {"step_size": 0.25}}
LAYER_SHAPES = ((3, 96), (12, 12), (12, 6))
# configs/model/cfm_calogan/cfm_eplus.yaml
SECTIONS = dict(list_shape=[[1, 96, 3], [1, 12, 12], [1, 6, 12]], list_edges=[288, 144, 72],
                list_patch_shape=[[1, 6, 1], [1, 2, 3], [1, 2, 3]])
GRID = [[1, 16, 3], [1, 6, 4], [1, 3, 4]]
SHAPE_TF = yaml.safe_load((ROOT / "configs/calogan/calogan.yaml").read_text())["data"][
    "transforms"]
ENERGY_TF = yaml.safe_load((ROOT / "configs/calogan/calogan_eplus_energy.yaml").read_text())[
    "data"]["transforms"]


def _events(n, seed):
    """Raw CaloGAN events: layers in MeV, energies in GeV (1-100)."""
    rng = np.random.default_rng(seed)
    energy = rng.uniform(1, 100, (n, 1)).astype(np.float32)
    data = {"energy": energy}
    for i, shape in enumerate(LAYER_SHAPES):
        layer = rng.exponential(1.0, (n, *shape)) * (rng.random((n, *shape)) > 0.3)
        data[f"layer_{i}"] = (layer * energy[:, :, None]).astype(np.float32)
    return data


def _write(path, data):
    with h5py.File(path, "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)
    return path


def _gev(data):
    """The dict ``load_data`` returns: the layers scaled to GeV, flat."""
    out = {k: (v / 1e3 if k.startswith("layer") else v).reshape(len(v), -1)
           for k, v in data.items()}
    return {k: v.astype(np.float32) for k, v in out.items()}


def _dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _perturb(params, rng, std):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        params)


# ---------------------------------------------------------------------------
# transforms and dataset
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [SHAPE_TF, ENERGY_TF, {
    "NormalizeLayerEnergyGAN": {"cut": 1e-3}, "ExclusiveLogitTransformGAN": {
        "delta": 1.0e-6, "rescale": True}}], ids=["calogan", "energy", "rescaled-logit"])
def test_transforms_match_jax(tmp_path, cfg):
    """Each step forward, then the chain reversed, bit for bit; the first
    forward call fits and writes the statistics in both run dirs alike."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    port, ref = ttf.build_pipeline(cfg, str(port_dir)), jtf.build_pipeline(cfg, str(jax_dir))
    assert [type(t).__name__ for t in port] == [type(t).__name__ for t in ref]
    for t in port:
        if "FromFile" in type(t).__name__:
            assert t.model_dir == str(port_dir)
    d_port, d_ref = _gev(_events(12, 0)), _gev(_events(12, 0))
    for p, r in zip(port, ref):
        d_port, d_ref = p(d_port), r(d_ref)
        _dicts_equal(d_port, d_ref)
    for name in ("means.npy", "stds.npy"):
        if (jax_dir / name).exists():
            np.testing.assert_array_equal(np.load(port_dir / name), np.load(jax_dir / name))
    noisy = {k: v + np.float32(0.05) for k, v in d_port.items()}
    r_port, r_ref = dict(noisy), {k: v.copy() for k, v in noisy.items()}
    for p, r in zip(port[::-1], ref[::-1]):
        r_port, r_ref = p(r_port, rev=True), r(r_ref, rev=True)
        _dicts_equal(r_port, r_ref)


@pytest.mark.parametrize("return_us", [False, True], ids=["shape", "energy"])
def test_dataset_matches_jax(tmp_path, return_us):
    f = _write(tmp_path / "train.hdf5", _events(20, 1))
    cfg = ENERGY_TF if return_us else SHAPE_TF
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    port = tds.CaloGANDataset(str(f), ttf.build_pipeline(cfg, str(tmp_path / "p")), return_us)
    ref = jds.CaloGANDataset(str(f), jtf.build_pipeline(cfg, str(tmp_path / "j")), return_us)
    np.testing.assert_array_equal(port.layers, ref.layers)
    np.testing.assert_array_equal(port.energy, ref.energy)
    assert port.layers.shape == ((20, 3) if return_us else (20, 1, 504))
    assert port.energy.shape == ((20, 1) if return_us else (20, 4))
    # the dict read from the file stands in for the file
    again = tds.CaloGANDataset(None, ttf.build_pipeline(cfg, str(tmp_path / "p")), return_us,
                               data=tds.load_data(str(f)))
    np.testing.assert_array_equal(again.layers, port.layers)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _vit_param(condition_dim=4, fused_block=False):
    return dict(dim=3, condition_dim=condition_dim, hidden_dim=48, out_channels=1, depth=2,
                num_heads=2, mlp_ratio=2, pos_embedding_coords="cylindrical",
                learn_pos_embed=True, causal_attn=False, num_patches=GRID, patch_dim=6,
                attn_impl="auto", fused_block=fused_block)


def _shape_pair(rng, fused_block=False):
    kw = dict(SECTIONS, shape=[504], odeint_kwargs=ODE)
    jmodel = JaxCaloGANCFM(JaxViT(_vit_param(fused_block=fused_block)), **kw)
    params = _perturb(jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)), rng, 0.1)
    model = CaloGANCFM(ViT(_vit_param(fused_block=fused_block)), **kw)
    model.net.load_state_dict(convert_vit_params(params))
    return jmodel, params, model


def _grads_match(model, jgrads, convert, rtol):
    want = convert(jgrads)
    got = {k: p.grad for k, p in model.net.named_parameters()}
    assert got.keys() == want.keys()
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=rtol * max(np.abs(w).max(), 1e-6),
                                   err_msg=k)


def test_tiny_calogan_cfm_matches_jax():
    rng = np.random.default_rng(2)
    jmodel, params, model = _shape_pair(rng)
    assert model.token_shape(3) == jmodel.token_shape(3) == (3, 84, 6)
    assert model.param_count() == jmodel.param_count(params)
    b = 3
    x = rng.normal(size=(b, 1, 504)).astype(np.float32)
    c = rng.normal(size=(b, 4)).astype(np.float32)
    t = rng.uniform(size=(b, 1, 1)).astype(np.float32)
    tt = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    v_ref = np.asarray(jax.jit(jmodel.forward)(params, jnp.asarray(x),
                                               jnp.asarray(t).reshape(-1, 1), c))
    with torch.no_grad():
        v = model(tt(x), tt(t).reshape(-1, 1), tt(c))
    np.testing.assert_allclose(v.numpy(), v_ref, atol=1e-5)

    key = jax.random.PRNGKey(4)
    loss_ref, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.batch_loss(p, jnp.asarray(x), jnp.asarray(c), key)))(params)
    k_t, k_x0 = jax.random.split(key)  # the draws of JAX's batch_loss (models/cfm.py)
    t_j = jax.random.uniform(k_t, (b, 1, 1))
    x0_j = jax.random.normal(k_x0, x.shape)
    loss = model.batch_loss(tt(x), tt(c), t=tt(t_j), x_0=tt(x0_j))
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= 1e-5 * float(loss_ref)
    _grads_match(model, grads, convert_vit_params, 1e-4)


# ---------------------------------------------------------------------------
# the two-stage chain
# ---------------------------------------------------------------------------
def _energy_param():
    return dict(dims_in=3, dims_c=1, dim_embedding=16, nhead=2, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=32, activation="relu", embeds=True,
                encode_t_dim=16, encode_t_scale=30, fused_block="sample", fused_group=32)


def _energy_pair(rng):
    jenergy = JaxCFM(JaxParallelTransformer(_energy_param()), shape=[3], odeint_kwargs=ODE)
    pe = _perturb(jax.jit(jenergy.init_params)(jax.random.PRNGKey(3)), rng, 0.05)
    energy = CFM(ParallelTransformer(_energy_param()), shape=[3], odeint_kwargs=ODE)
    energy.net.load_state_dict(convert_energy_params(pe))
    return jenergy, pe, energy


def _fitted_pipelines(tmp_path):
    """The shipped CaloGAN chains (shape, energy), fitted on the same events
    in both packages: ``(port, jax)`` pairs of (shape, energy) steps."""
    out = []
    for tag, build in (("p", ttf.build_pipeline), ("j", jtf.build_pipeline)):
        pair = []
        for name, cfg in (("shape", SHAPE_TF), ("energy", ENERGY_TF)):
            d = tmp_path / f"{tag}_{name}"
            d.mkdir()
            steps = build(cfg, str(d))
            data = _gev(_events(32, 5))
            for fn in steps:
                data = fn(data)
            pair.append(steps)
        out.append(tuple(pair))
    return out


def test_calogan_chain_matches_jax_fused_generate(tmp_path):
    (shape_tf, energy_tf), (jshape_tf, jenergy_tf) = _fitted_pipelines(tmp_path)
    rng = np.random.default_rng(6)
    jshape, ps, shape = _shape_pair(rng, fused_block="sample")
    jenergy, pe, energy = _energy_pair(rng)
    b = 4
    gen = Generator(shape, energy, energy_tf, shape_tf, batch=b, u_position="last")
    assert gen.cond_dim == 1
    cond = rng.uniform(0, 1, (b, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    shower_j, cond_j = jax.jit(jax_make_fused_generate(
        jshape, jenergy, jenergy_tf, jshape_tf, u_position="last"))(ps, pe, jnp.asarray(cond), key)
    k_u, k_s = jax.random.split(key)
    noise = (torch.from_numpy(np.array(jax.random.normal(k_u, (b, 3)))),
             torch.from_numpy(np.array(jax.random.normal(k_s, jshape.token_shape(b)))))
    shower_t, cond_t = gen.generate(cond, noise=noise)
    np.testing.assert_array_equal(cond_t.numpy()[:, :1], cond)  # [E | u]
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(shower_t.numpy(), np.asarray(shower_j),
                               atol=1e-4 * max(1.0, np.abs(shower_j).max()), rtol=1e-4)
    assert shower_t.shape == (b, 1, 504)


def test_calogan_twins_match_the_staged_steps(tmp_path):
    """``GlobalStandardizeFromFileGAN`` and ``ExclusiveLogitTransformGAN``
    (plain and rescaled) on the device against the staged u-only dict."""
    (shape_tf, energy_tf), _ = _fitted_pipelines(tmp_path)
    rescaled = ttf.build_pipeline({"ExclusiveLogitTransformGAN": {"delta": 1e-6,
                                                                   "rescale": True}}, "")
    u = np.random.default_rng(8).normal(size=(6, 3)).astype(np.float32)
    for e_steps, s_steps in ((energy_tf, shape_tf), (rescaled, rescaled)):
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
            f"seed={seed}", "training.batchsize=8", "training.batchsize_sample=8",
            "training.validate_every_n_steps=2", "training.iterations=3", "evaluate=false",
            "plotting.loss=false", "save_source=false", "n_samples=12",
            "model.odeint_kwargs.options.step_size=0.5", "evaluation.eval_cls_n_epochs=1",
            "evaluation.eval_cls_n_hidden=16"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launcher's energy run on calogan/calogan_eplus_energy, then its
    shape run on calogan/calogan (``plot`` on the test file's u's, the
    classifier one epoch): (work dir, energy experiment, shape experiment)."""
    work = tmp_path_factory.mktemp("launch")
    for name, n, seed in (("train_eplus", 40, 1), ("test_eplus", 12, 2),
                          ("full_cls_eplus", 30, 3)):
        _write(work / f"{name}.hdf5", _events(n, seed))
    energy = main(["-cn", "calogan/calogan_eplus_energy", *_common(work, "E", 4),
                   "plot=false", "model.net.param.dim_embedding=16",
                   "+model.net.param.encode_t_dim=16", "model.net.param.nhead=2",
                   "model.net.param.num_encoder_layers=1", "model.net.param.num_decoder_layers=1",
                   "model.net.param.dim_feedforward=32"], device="cpu")
    shape = main(["-cn", "calogan/calogan", *_common(work, "S", 5),
                  "model.net.param.hidden_dim=24", "model.net.param.depth=1",
                  "model.net.param.num_heads=2", f"energy_model={work / 'runs' / 'E' / 'run'}"],
                 device="cpu")
    return work, energy, shape


def test_launcher_trains_samples_and_plots_calogan(runs):
    """The energy run, then the shape run (``plot`` on the test file's u's);
    then the shape run samples on the energy run's u's, staged and through
    the fused chain with the same noise."""
    tmp_path, energy, shape = runs
    assert energy.state.step == 3 and all(math.isfinite(v) for v in energy.train_loss)
    run = tmp_path / "runs" / "S" / "run"
    assert (run / "models" / "model_run0.pt").exists() and (run / "means.npy").exists()
    assert (run / "eval_0" / "classifier_low-level_CaloGAN.txt").exists()
    assert shape.last_sampling_fused is False

    shape.cfg.sample_us = True
    b, n = 8, 12
    gen = torch.Generator().manual_seed(0)
    noise = ([torch.randn(b, 3, generator=gen) for _ in range(2)],
             [torch.randn(b, 84, 6, generator=gen) for _ in range(2)])
    e_inc = shape.draw_conditions(n, np.random.default_rng(0))
    staged, cond = shape.sample_n(noise=noise, conditions=e_inc)
    shape.cfg.fused_generation = True
    fused, cond_f = shape.sample_n(noise=noise, conditions=e_inc)
    assert shape.last_sampling_fused is True
    assert staged.shape == (n, 1, 504) and cond.shape == (n, 4)
    np.testing.assert_allclose(cond_f, cond, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(fused, staged, atol=1e-5 * np.abs(staged).max())
    data = shape.to_showers(staged, cond)
    np.testing.assert_allclose(data["energy"], e_inc, rtol=1e-5)
    for i, (h, w) in enumerate(LAYER_SHAPES):
        assert data[f"layer_{i}"].shape == (n, h * w) and np.isfinite(data[f"layer_{i}"]).all()
    assert (data["layer_0"] >= 0).all()


# the sampling and plot of the port's experiment against JAX's: both nets
# replaced by the same fixed draws, so every array in between is host code
N_DRAWS = 10


def _jax_experiment(port, monkeypatch):
    """The JAX experiment over the port run's ``config.yaml`` and files (the
    port's fitted statistics read back), its energy net a stub."""
    from vit4hep_tpu.experiments import calogan as jexp
    from vit4hep_tpu.utils.config import OmegaConf as JaxOmegaConf

    monkeypatch.setattr(jexp, "load_net_params", lambda *a: ("energy net", None, False))
    exp = object.__new__(jexp.CaloGAN)
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
    draws = {True: ((10 if energy_run else 1) * rng.normal(size=(64, 3))).astype(np.float32),
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


def _capture_plot(monkeypatch):
    """What each package's ``plot`` evaluates and draws."""
    from vit4hep_tpu.evaluation import us_evaluation as jus
    from vit4hep_tpu_torch.evaluation import us_evaluation as tus

    got = {"port": {}, "jax": {}}
    for tag, ev, us in (("port", teval, tus), ("jax", jeval, jus)):
        put = got[tag].__setitem__
        monkeypatch.setattr(ev, "eval_calogan_lowlevel",
                            lambda *a, put=put, **kw: put("evaluated", a[:1]))
        monkeypatch.setattr(us, "plot_ui_dists", lambda *a, put=put, **kw: put("drawn", a))
        monkeypatch.setattr(us, "eval_ui_dists", lambda *a, put=put, **kw: put("evaluated", a))
    return got


@pytest.mark.parametrize("case", ["energy", "shape-sampled-us", "shape-test-us"])
def test_sampling_and_plot_match_the_jax_experiment(runs, monkeypatch, case):
    """``plot`` of both packages on the launcher's runs, from one seeded
    draw (numpy's global generator for JAX, the same stream handed to the
    port), the nets stubbed: the conditions each net is given (E to the
    energy net, [E | u] to the shape net, the u's mapped from the energy
    run's basis by ``sample_us`` or read from the test file), and the
    evaluated and drawn arrays of the inverse chain (``to_showers``,
    ``energy_us``), bit for bit."""
    _, energy, shape = runs
    port = energy if case == "energy" else shape
    jexp = _jax_experiment(port, monkeypatch)
    for cfg in (port.cfg, jexp.cfg):
        cfg.n_samples, cfg.sample_us = N_DRAWS, case == "shape-sampled-us"
    port.cfg.fused_generation = False
    seen = _stub_nets(port, jexp, monkeypatch, (1, 504))
    got = _capture_plot(monkeypatch)
    monkeypatch.setattr(port, "conditions_rng", lambda: np.random.RandomState(7))
    np.random.seed(7)
    jexp.plot()
    port.plot()
    kinds = {"energy": [True], "shape-sampled-us": [True, False], "shape-test-us": [False]}
    assert [e for e, _ in seen["port"]] == [e for e, _ in seen["jax"]] == kinds[case]
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    if case != "energy":
        assert seen["port"][-1][1].shape[1] == 4
    assert sorted(got["port"]) == sorted(got["jax"]) == \
        (["drawn", "evaluated"] if case == "energy" else ["evaluated"])
    for key in got["jax"]:
        assert len(got["port"][key]) == len(got["jax"][key])
        for a, b in zip(got["port"][key], got["jax"][key]):
            np.testing.assert_array_equal(a, b)


def test_evaluation_matches_jax(tmp_path, monkeypatch):
    """The classifier's labelled inputs of both packages, bit for bit (the
    classifier itself is held by tests/test_torch_evaluation.py)."""
    ref = _events(30, 9)
    _write(tmp_path / "cls.hdf5", ref)
    cfg = Config({"run_dir": str(tmp_path), "run_idx": 0, "evaluation": {
        "eval_hdf5_file": str(tmp_path / "cls.hdf5"), "eval_mode": "low-level",
        "eval_dataset": "CaloGAN", "eval_cls_lr": 2e-4, "eval_cls_batch_size": 1000,
        "eval_cls_n_epochs": 1, "eval_cls_n_layer": 2, "eval_cls_n_hidden": 16,
        "eval_cls_dropout": 0.0}})
    seen = {}
    monkeypatch.setattr(jeval, "run_dnn_classifier",
                        lambda a, b, ev, path: seen.setdefault("jax", (a, b, path)))
    monkeypatch.setattr(teval, "run_dnn_classifier",
                        lambda a, b, ev, path, device: seen.setdefault("port", (a, b, path)))
    source = np.random.default_rng(10).exponential(size=(25, 504)).astype(np.float32)
    from vit4hep_tpu.utils.config import OmegaConf as JaxOmegaConf

    jeval.eval_calogan_lowlevel(source, JaxOmegaConf.create(cfg.to_container()))
    teval.eval_calogan_lowlevel(source, cfg, device="cpu")
    for a, b in zip(seen["port"], seen["jax"]):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    assert seen["port"][0].shape == (25, 505) and seen["port"][1].shape == (30, 505)


# ---------------------------------------------------------------------------
# the shipped configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["cfm_eplus", "cfm_eplus_tpu", "cfm_eplus_energy"])
def test_shipped_configs_have_the_jax_parameter_counts(model):
    from vit4hep_tpu.utils.config import compose as jax_compose
    from vit4hep_tpu.utils.config import instantiate as jax_instantiate

    name = "calogan/calogan_eplus_energy" if model.endswith("energy") else "calogan/calogan"
    overrides = ["data_dir=/nonexistent", f"model=cfm_calogan/{model}"]
    with torch.device("meta"):
        port = instantiate(compose(str(ROOT / "configs"), name, overrides)["model"])
    jmodel = jax_instantiate(jax_compose(str(ROOT / "configs"), name, overrides=overrides).model)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
    count = sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    assert port.param_count() == count
    if model != "cfm_eplus_energy":
        assert isinstance(port, CaloGANCFM) and port.token_shape(2) == (2, 84, 6)
        assert port.net.cfg.num_heads == (4 if model.endswith("tpu") else 6)
        assert port.net.cfg.fused_block == "sample"


def test_fine_tuning_types_still_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_experiment("calogan_ft_cfm")
    assert get_experiment("calogan").__name__ == "CaloGAN"


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FILE_KEYS = ("training_file", "test_file", "training_file_dict", "test_file_dict")


@pytest.mark.parametrize("run", ["shape", "energy"])
def test_chip_smoke_calogan_dicts_equal_yaml(run):
    """The smoke's CaloGAN model, transforms, evaluation, training and
    data settings are the shipped YAML's (its file lists aside: the card
    gets synthetic events)."""
    smoke = _chip_smoke()
    f = smoke.FAMILIES["calogan"]
    name = {"shape": "calogan/calogan", "energy": "calogan/calogan_eplus_energy"}[run]
    cfg = compose(str(ROOT / "configs"), name, ["data_dir=${data_dir}"])
    raw = yaml.safe_load((ROOT / "configs" / f"{name}.yaml").read_text())
    model = yaml.safe_load((ROOT / "configs" / "model" / f"{raw['defaults'][2]['/model']}.yaml"
                            ).read_text())
    assert f[run] == model
    assert f["energy_tf" if run == "energy" else "shape_tf"] == raw["data"]["transforms"]
    data = smoke._family_data("calogan", run)
    assert {k: v for k, v in data.items() if k not in FILE_KEYS} == \
        {k: v for k, v in raw["data"].items() if k not in FILE_KEYS}
    training = {k: (float(v) if k in ("eps", "lr") else v)  # YAML 1.1 reads 1e-8 as a string
                for k, v in cfg["training"].to_container().items()}
    if run == "shape":
        assert f["training"] == training and f["evaluation"] == raw["evaluation"]
    else:
        assert smoke.DS2_ENERGY_TRAINING == training


def test_family_modules_import_without_jax_h5py_or_matplotlib():
    """The family modules of the port load nothing of JAX or of the JAX
    package, and neither h5py, matplotlib nor sklearn (the card's machine
    has none of them)."""
    import subprocess
    import sys

    mods = [f"vit4hep_tpu_torch.{m}" for m in (
        "models.calogan", "models.lemurs", "models.calohadronic", "data.pipeline",
        "data.calogan.transforms", "data.calogan.datasets", "data.lemurs.transforms",
        "data.lemurs.datasets", "data.calohadronic.transforms", "data.calohadronic.datasets",
        "experiments.families", "experiments.calogan", "experiments.lemurs",
        "experiments.calohadronic", "evaluation.calogan", "evaluation.lemurs",
        "evaluation.calohadronic")]
    code = (f"import importlib, sys; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
            "'vit4hep_tpu', 'h5py', 'matplotlib', 'sklearn')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
