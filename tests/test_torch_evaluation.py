"""The port's evaluation package against the JAX package's, on the CPU:
the binning-XML geometry and the high-level features (bit-identical: the
same numpy operations), FPD/KPD (the same draws; float64 products in torch
against numpy's, 1e-9 relative), the DNN and ResNet3D classifiers against
the flax modules on converted variables (forward 1e-5 of scale; two epochs
of ``train_classifier`` from the same initial variables 1e-4), the
numpy/scipy AUC, isotonic regression and calibration curve against
sklearn, and ``evaluate_classifier``, ``run_from_py`` and ``eval_ui_dists``
against JAX's on a tiny geometry.

Where the JAX package splits data with an unseeded ``default_rng()``
(``ttv_split``), both packages are given the same seeded generator, and
the port's classifiers start from JAX's initial variables
(``flax init`` with ``PRNGKey(cfg.seed)``), so that both train alike.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_shower_hdf5
from vit4hep_tpu.data.xml_handler import XMLHandler as JaxXMLHandler
from vit4hep_tpu.evaluation import classifiers as jcls
from vit4hep_tpu.evaluation import metrics as jmetrics
from vit4hep_tpu.evaluation import ugr_evaluation as jugr
from vit4hep_tpu.evaluation import us_evaluation as jus
from vit4hep_tpu.evaluation.high_level_features import HighLevelFeatures as JaxHLF
from vit4hep_tpu.utils.config import Config as JaxConfig
from vit4hep_tpu_torch.data.xml_handler import XMLHandler
from vit4hep_tpu_torch.evaluation import classifiers as tcls
from vit4hep_tpu_torch.evaluation import metrics as tmetrics
from vit4hep_tpu_torch.evaluation import ugr_evaluation as tugr
from vit4hep_tpu_torch.evaluation import us_evaluation as tus
from vit4hep_tpu_torch.evaluation.high_level_features import HighLevelFeatures
from vit4hep_tpu_torch.utils.config import Config
from vit4hep_tpu_torch.utils.jax_params import convert_classifier_params

ROOT = Path(__file__).resolve().parent.parent


def _xml(path, layers):
    """A binning XML of (r_edges, n_alpha) layers for the electron."""
    rows = [f'    <Layer id="{i}" r_edges="{",".join(map(str, r))}" n_bin_alpha="{a}"/>'
            for i, (r, a) in enumerate(layers)]
    path.write_text("\n".join(["<Bins>", '  <Particle name="electron">', *rows, "  </Particle>",
                               "</Bins>"]))
    return str(path)


def _showers(rng, n, v, e_inc):
    vox = rng.exponential(1.0, (n, v)) * (rng.random((n, v)) > 0.3)
    return (vox / vox.sum(1, keepdims=True) * e_inc * rng.uniform(0.6, 0.9, (n, 1))
            ).astype(np.float32)


@pytest.mark.parametrize("layers", [
    [((0, 4, 8, 13), 4)] * 5,
    [((0, 4, 8), 1), ((0, 2, 5, 9, 20), 6), ((0,), 1), ((0, 3, 7, 12), 6), ((0, 10), 3)],
], ids=["uniform", "irregular"])
def test_xml_and_high_level_features_match_jax(tmp_path, layers):
    """Geometry and every feature bit for bit, on a uniform geometry (depth
    profiles and radial energies too) and an irregular one (a layer with no
    radial bin, layers without alpha binning)."""
    xml = _xml(tmp_path / "binning.xml", layers)
    port, ref = XMLHandler("electron", xml), JaxXMLHandler("electron", xml)
    for attr in ("bin_number", "totalBins", "relevantlayers", "layerWithBinningInAlpha",
                 "r_edges", "a_bins", "r_bins"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    np.testing.assert_array_equal(port.GetBinEdges(), ref.GetBinEdges())
    for a, b in zip(port.GetEtaPhiAllLayers(), ref.GetEtaPhiAllLayers()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for lp, lr in zip(port.layers, ref.layers):
        np.testing.assert_array_equal(lp.r_mid, lr.r_mid)
        np.testing.assert_array_equal(lp.alpha_mid, lr.alpha_mid)

    rng = np.random.default_rng(3)
    e_inc = 10 ** rng.uniform(3, 6, (50, 1))
    data = _showers(rng, 50, port.totalBins, e_inc)
    hp, hr = HighLevelFeatures("electron", xml), JaxHLF("electron", xml)
    hp.CalculateFeatures(data)
    hr.CalculateFeatures(data)
    np.testing.assert_array_equal(hp.GetEtot(), hr.GetEtot())
    for getter in ("GetElayers", "GetECEtas", "GetECPhis", "GetWidthEtas", "GetWidthPhis",
                   "GetSparsity", "GetWeightedDepthA", "GetWeightedDepthR",
                   "GetGroupedWeightedDepthA", "GetGroupedWeightedDepthR", "GetEradial"):
        got, want = getattr(hp, getter)(), getattr(hr, getter)()
        assert got.keys() == want.keys(), getter
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert hp.num_voxel == hr.num_voxel and hp.layersBinnedInAlpha == hr.layersBinnedInAlpha


def test_fpd_and_kpd_match_jax():
    """The same RandomState draws; each draw's moments and kernel sums in
    torch float64 against numpy float64: 1e-9 relative."""
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(300, 9)) * rng.uniform(0.5, 3.0, 9)
    src = ref[::-1] * 1.05 + 0.1
    got = tmetrics.fpd(ref, src, min_samples=200, max_samples=600, num_batches=4, num_points=5,
                        device="cpu")
    want = jmetrics.fpd(ref, src, min_samples=200, max_samples=600, num_batches=4, num_points=5)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    got = tmetrics.kpd(ref, src, num_batches=6, batch_size=250, device="cpu")
    want = jmetrics.kpd(ref, src, num_batches=6, batch_size=250)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(tmetrics.frechet_distance(ref, src),
                               jmetrics.frechet_distance(ref, src), rtol=1e-9)


def _jax_init(model, n_inputs, seed=0):
    init = jax.jit(lambda key, x: model.init(key, x, train=False))
    return init(jax.random.PRNGKey(seed), jnp.zeros((2, n_inputs), jnp.float32))


def _port_from_jax(jmodel, port, n_inputs, seed=0):
    port.load_state_dict(convert_classifier_params(_jax_init(jmodel, n_inputs, seed)))
    return port


@pytest.mark.parametrize("kind", ["dnn", "resnet10", "resnet50"])
def test_classifier_forward_matches_flax(kind):
    """Eval-mode logits on converted variables (running statistics
    perturbed away from 0 / 1): 1e-5 of scale."""
    rng = np.random.default_rng(1)
    if kind == "dnn":
        n_in = 13
        jmodel, port = jcls.DNN(2, 32), tcls.DNN(2, 32, 0.0, n_in)
    else:
        depth, img = int(kind[6:]), (8, 6, 5)
        n_in = 1 + int(np.prod(img))
        jmodel, port = jcls.generate_model(depth, img_shape=img), tcls.generate_model(depth, img)
    variables = _jax_init(jmodel, n_in)
    variables = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape), variables)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5,
                                                variables["batch_stats"])
    port.load_state_dict(convert_classifier_params(variables))
    x = rng.normal(size=(7, n_in)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x))
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("kind", ["dnn", "resnet10"])
def test_train_classifier_matches_jax(kind):
    """Two epochs from the same initial variables on the same batches (40
    events at batch 16: the ragged tail wraps), dropout 0: the logits of
    the best state 1e-4 relative, and the parameters and BatchNorm running
    statistics JAX ends with. The ResNet's gradients agree to ~4e-6 of
    scale, but Adam moves a parameter whose gradient is ~0 by about lr
    whichever sign rounding gives it: at lr 1e-3 the logits part by 2e-3
    relative after 6 steps, at the 1e-4 used here by less than 1e-4."""
    rng = np.random.default_rng(2)
    if kind == "dnn":
        n_in, cfg = 11, jcls.ClassifierConfig(lr=1e-3, batch_size=16, n_epochs=2)
        jmodel, port = jcls.DNN(2, 32), tcls.DNN(2, 32, 0.0, n_in)
    else:
        img = (6, 4, 3)
        n_in = 1 + int(np.prod(img))
        cfg = jcls.ClassifierConfig(lr=1e-4, batch_size=16, n_epochs=2, optimizer="AdamW")
        jmodel, port = jcls.generate_model(10, img_shape=img), tcls.generate_model(10, img)
    data = rng.normal(size=(60, n_in)).astype(np.float32)
    data[:, -1] = 0.0
    labels = (rng.random(60) > 0.5).astype(np.float32)
    data = np.concatenate([data + labels[:, None] * 0.3, labels[:, None]], axis=1)
    train, test = data[:40], data[40:]
    _port_from_jax(jmodel, port, n_in)
    pcfg = tcls.ClassifierConfig(**vars(cfg))
    best_p, apply_p = tcls.train_classifier(port, train, test, pcfg, device="cpu")
    best_j, apply_j = jcls.train_classifier(jmodel, train, test, cfg)
    want = apply_j(data)
    np.testing.assert_allclose(apply_p(data), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert best_p["acc"] == best_j["acc"]
    ref = convert_classifier_params({"params": best_j["params"],
                                     "batch_stats": best_j["batch_stats"]})
    for k, v in ref.items():
        np.testing.assert_allclose(best_p["state"][k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(v.abs().max())), err_msg=k)


def test_auc_isotonic_and_calibration_match_sklearn():
    from sklearn.calibration import calibration_curve
    from sklearn.isotonic import IsotonicRegression
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(4)
    y = (rng.random(500) > 0.4).astype(np.float64)
    for dtype in (np.float32, np.float64):
        p = np.clip(rng.normal(0.5 + 0.15 * (y - 0.5), 0.2), 0, 1).astype(dtype)
        tied = np.round(p, 2)  # ties in the scores and in the isotonic inputs
        for scores in (p, tied):
            assert abs(tcls.roc_auc_score(y, scores) - roc_auc_score(y, scores)) < 1e-12
            iso_p = tcls.IsotonicRegression(y_min=1e-6, y_max=1 - 1e-6).fit(scores, y)
            iso_s = IsotonicRegression(out_of_bounds="clip", y_min=1e-6,
                                       y_max=1 - 1e-6).fit(scores, y)
            # out-of-range points clip to the fitted range
            query = np.concatenate([scores, np.asarray([-0.5, 1.7, 0.0, 1.0], dtype)])
            got, want = iso_p.predict(query), iso_s.predict(query)
            assert got.dtype == want.dtype == dtype
            np.testing.assert_allclose(got, want, atol=4 * np.finfo(dtype).eps, rtol=0)
            fitted = iso_s.predict(scores)
            for a, b in zip(tcls.calibration_curve(y, fitted, n_bins=10),
                            calibration_curve(y, fitted, n_bins=10)):
                np.testing.assert_allclose(a, b, rtol=1e-12)
    with pytest.raises(ValueError):
        tcls.roc_auc_score(np.ones(4), np.arange(4.0))


def test_evaluate_classifier_matches_jax():
    """The same logits through both packages' evaluate_classifier (with
    isotonic calibration): the same accuracy, AUC and JSD."""
    rng = np.random.default_rng(5)
    labels = (rng.random((2, 400)) > 0.5).astype(np.float32)
    val, cal = (np.concatenate([rng.normal(size=(400, 3)), lab[:, None]], axis=1)
                .astype(np.float32) for lab in labels)

    def apply_fn(data):
        return (np.asarray(data)[:, 0] + 0.8 * np.asarray(data)[:, -1] - 0.4).astype(np.float32)

    got = tcls.evaluate_classifier(apply_fn, val, calibration_data=cal, final_eval=True)
    want = jcls.evaluate_classifier(apply_fn, val, calibration_data=cal, final_eval=True)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(tcls.evaluate_classifier(apply_fn, val),
                               jcls.evaluate_classifier(apply_fn, val), rtol=1e-6)


@pytest.fixture
def same_start(monkeypatch):
    """Both packages' ``ttv_split`` get the same seeded generator, and the
    port's classifiers start from the variables JAX initialises."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(1234 if seed is None else seed))

    port_dnn, port_resnet = tcls.DNN, tcls.generate_model

    def dnn(num_layer, num_hidden, dropout_probability=0.0, num_inputs=1, generator=None):
        return _port_from_jax(jcls.DNN(num_layer, num_hidden, dropout_probability),
                              port_dnn(num_layer, num_hidden, dropout_probability, num_inputs),
                              num_inputs)

    def resnet(depth, img_shape, generator=None):
        return _port_from_jax(jcls.generate_model(depth, img_shape=img_shape),
                              port_resnet(depth, img_shape), 1 + int(np.prod(img_shape)))

    monkeypatch.setattr(tugr, "DNN", dnn)
    monkeypatch.setattr(tcls, "DNN", dnn)
    monkeypatch.setattr(tugr, "generate_model", resnet)


def _eval_cfg(cls, tmp_path, xml, ref_file, mode, run):
    ev = {"eval_dataset": "2", "eval_mode": mode, "eval_cut": 0.015, "eval_labels": ["tiny"],
          "eval_hdf5_file": str(ref_file), "eval_cls_n_layer": 1, "eval_cls_n_hidden": 24,
          "eval_cls_dropout": 0.0, "eval_cls_lr": 1e-3, "eval_cls_batch_size": 32,
          "eval_cls_n_epochs": 2, "eval_cls_resnet_layers": 10, "eval_cls_resnet_lr": 1e-3,
          "eval_cls_resnet_n_epochs": 1}
    return cls({"run_dir": str(tmp_path / run), "run_idx": 0,
                "data": {"xml_filename": xml}, "evaluation": ev})


def _classifier_results(out_dir):
    return {f.name: [float(v) for v in f.read_text().split("\n")[1].split(" / ")]
            for f in sorted(Path(out_dir).glob("classifier_*.txt"))}


def test_run_from_py_matches_jax(tmp_path, monkeypatch, same_start):
    """``run_from_py`` on a 1-layer geometry (4 alpha x 3 radial bins)
    against JAX's: ``hist`` (the histograms' chi^2, same text) and
    ``all-cls`` (cls-low, cls-high, cls-resnet: the same files, AUC and JSD
    within 2e-3). FPD/KPD run there with the shipped 10,000-sample draws,
    minutes on a CPU: test_fpd_and_kpd_match_jax holds them."""
    xml = _xml(tmp_path / "binning.xml", [((0, 4, 8, 13), 4)])
    v = 12
    for mod in (tugr, jugr):
        monkeypatch.setitem(mod.DATASET_NUM_FEATURES, "2", v)
        monkeypatch.setitem(mod.RESNET_IMG_SHAPE, "2", (1, 4, 3))
    ref_file = make_shower_hdf5(tmp_path / "reference.hdf5", n_events=120, n_voxels=v, seed=3)
    rng = np.random.default_rng(6)
    energy = (10 ** rng.uniform(3, 6, (100, 1))).astype(np.float32)
    sample = _showers(rng, 100, v, energy)
    sample[0, 0] = np.nan  # cleaned to 0 by both
    for mode in ("hist", "all-cls"):
        tugr.run_from_py(sample, energy, _eval_cfg(Config, tmp_path, xml, ref_file, mode, "port"),
                         device="cpu")
        jugr.run_from_py(sample, energy, _eval_cfg(JaxConfig, tmp_path, xml, ref_file, mode,
                                                   "jax"))
    port, ref = tmp_path / "port" / "eval_0", tmp_path / "jax" / "eval_0"
    chi2 = sorted(f.name for f in ref.glob("histogram_chi2_*.txt"))
    assert chi2 and chi2 == sorted(f.name for f in port.glob("histogram_chi2_*.txt"))
    for name in chi2:
        assert (port / name).read_text() == (ref / name).read_text(), name
    assert sorted(f.name for f in port.glob("*.pdf")) == sorted(f.name for f in ref.glob("*.pdf"))
    got, want = _classifier_results(port), _classifier_results(ref)
    assert got.keys() == want.keys() and len(want) == 3
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-3, err_msg=name)


def test_eval_ui_dists_matches_jax(tmp_path, same_start):
    """The u-space DNN on 45-like u-vectors (6 here) against JAX's: the
    same result file, AUC and JSD within 2e-3."""
    rng = np.random.default_rng(7)
    gen_us, ref_us = rng.random((300, 6)), np.clip(rng.random((300, 6)) * 1.1, 0, 1)
    cfgs = [_eval_cfg(cls, tmp_path, "", "", "all", run)
            for cls, run in ((Config, "port"), (JaxConfig, "jax"))]
    got = tus.eval_ui_dists(gen_us, ref_us, cfgs[0], device="cpu")
    want = jus.eval_ui_dists(gen_us, ref_us, cfgs[1])
    np.testing.assert_allclose(got, want, atol=2e-3)
    port, ref = (_classifier_results(tmp_path / run / "eval_0") for run in ("port", "jax"))
    assert list(port) == list(ref) == ["classifier_all_2.txt"]
    np.testing.assert_allclose(port["classifier_all_2.txt"], ref["classifier_all_2.txt"],
                               atol=2e-3)


def test_evaluation_runs_without_sklearn_matplotlib_h5py(tmp_path):
    """With sklearn, matplotlib and h5py unimportable, the port's classifier,
    metric and array-evaluation path imports and runs (the card's
    machine has none of them)."""
    code = f"""
import sys
for name in ("sklearn", "matplotlib", "h5py"):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np
from vit4hep_tpu_torch.evaluation import classifiers, metrics, ugr_evaluation, us_evaluation
from vit4hep_tpu_torch.experiments import calochallenge
from vit4hep_tpu_torch.utils.config import Config
from pathlib import Path
layers = "\\n".join(f'<Layer id="{{i}}" r_edges="0,4,8,13" n_bin_alpha="4"/>' for i in range(2))
Path(r"{tmp_path}/b.xml").write_text(f'<Bins><Particle name="electron">{{layers}}</Particle></Bins>')
ugr_evaluation.RESNET_IMG_SHAPE["2"] = (2, 4, 3)
rng = np.random.default_rng(0)
e = 10 ** rng.uniform(3, 6, (60, 1))
s = rng.exponential(size=(60, 24)); s = s / s.sum(1, keepdims=True) * e * 0.8
ev = {{"eval_dataset": "2", "eval_mode": "all-cls", "eval_cut": 0.0, "eval_hdf5_file": "",
      "eval_cls_n_layer": 1, "eval_cls_n_hidden": 8, "eval_cls_dropout": 0.0,
      "eval_cls_lr": 1e-3, "eval_cls_batch_size": 32, "eval_cls_n_epochs": 1,
      "eval_cls_resnet_layers": 10, "eval_cls_resnet_n_epochs": 1}}
cfg = Config({{"run_dir": r"{tmp_path}", "run_idx": 0,
              "data": {{"xml_filename": r"{tmp_path}/b.xml"}}, "evaluation": ev}})
res = ugr_evaluation.evaluate_showers(s, e, s[::-1] * 1.1, e[::-1], cfg, device="cpu")
assert set(res) == {{"cls-low", "cls-high", "cls-resnet"}}, res
print(metrics.kpd(s, s * 1.1, num_batches=2, batch_size=30, device="cpu"))
bad = [m for m, mod in sys.modules.items()
       if mod is not None and m.split(".")[0] in ("sklearn", "matplotlib", "h5py", "jax")]
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=300)
