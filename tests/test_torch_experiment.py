"""Port parity of the CaloChallenge training lifecycle against the JAX
package, on the CPU: the config composer, the fitted transforms, the
datasets and batch iterator, checkpoints and warm start, and the launcher
end to end at a tiny ds2-like geometry.

Transforms, datasets and the iterator run the same numpy operations in both
packages, so their results must be bit-identical.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tests.conftest import make_binning_xml, make_shower_hdf5
from vit4hep_tpu.data.calochallenge import datasets as jds
from vit4hep_tpu.data.calochallenge import transforms as jtf
from vit4hep_tpu.utils import config as jcfg
from vit4hep_tpu_torch.data.calochallenge import datasets as tds
from vit4hep_tpu_torch.data.calochallenge import transforms as ttf
from vit4hep_tpu_torch.experiments.main import get_experiment, main
from vit4hep_tpu_torch.utils import config as tcfg

ROOT = Path(__file__).resolve().parent.parent
L, A, R = 6, 4, 3
V = L * A * R


@pytest.mark.parametrize("name,overrides", [
    ("calochallenge/cfm/calochallenge_ds2", ["data_dir=/data/x", "training.lr=3e-4",
                                             "model.net.param.depth=2", "~evaluation.eval_mode",
                                             "+extra.key=[1, 2]"]),
    ("calochallenge/cfm/calochallenge_ds2_energy", ["model=cfm/cfm_ds2_electrons", "seed=5"]),
])
def test_compose_matches_jax(name, overrides):
    port = tcfg.compose(str(ROOT / "configs"), name, overrides)
    ref = jcfg.compose(str(ROOT / "configs"), name, overrides)
    assert port.to_container(resolve=True) == ref.to_container(resolve=True)
    assert port.to_container(resolve=False) == ref.to_container(resolve=False)
    # the port writes YAML without PyYAML; PyYAML reads back the same values
    assert yaml.safe_load(port.to_yaml()) == port.to_container(resolve=False)
    with pytest.raises(tcfg.MissingMandatoryValue):
        tcfg.compose(str(ROOT / "configs"), "default").exp_name


def test_yaml_emitter_round_trips_awkward_values():
    data = {"f": [1e-05, 1.5e16, -0.0, float("inf")], "s": ["1e-4", "yes", "null", "a: b", ""],
            "n": None, "b": [True, False], "e": {}, "l": [], "nest": [{"a": 1, "b": [2, 3]}],
            "i": 7, "u": "ümlaut"}
    assert yaml.safe_load(tcfg.dump_yaml(data)) == data


def test_instantiate_accepts_config_and_dict():
    from vit4hep_tpu_torch.models.cfm import CFM

    spec = {"_target_": "vit4hep_tpu.models.cfm.CFM", "shape": [6],
            "net": {"_target_": "vit4hep_tpu.models.energy_transformer.ParallelTransformer",
                    "param": {"dims_in": 6, "dim_embedding": 16, "nhead": 2,
                              "num_encoder_layers": 1, "num_decoder_layers": 1,
                              "dim_feedforward": 32, "embeds": True, "encode_t_dim": 16}}}
    for node in (spec, tcfg.Config(spec)):
        assert isinstance(tcfg.instantiate(node), CFM)


def _ds2_transforms(xml):
    """The ds2 shape and energy chains of configs/calochallenge/cfm at the tiny geometry."""
    common = {"NormalizeByElayer": {"ptype": str(xml), "xml_file": "electron"},
              "ScaleTotalEnergy": {"n_layers": L, "factor": 0.35}}
    scale = {"LogEnergy": {}, "ScaleEnergy": {"e_min": 6.907755, "e_max": 13.815510}}
    shape = {**common, "CutValues": {"cut": 1.0e-7, "n_layers": L},
             "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
             "GlobalStandardizeFromFile": {"model_dir": None, "eps": 1.0e-6}, **scale,
             "AddFeaturesToCond": {"split_index": V}, "Reshape": {"shape": [1, L, A, R]}}
    energy = {**common, "SelectDims": {"start": -L, "end": 0},
              "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
              "StandardizeUsFromFile": {"n_us": L, "model_dir": None}, **scale,
              "Reshape": {"shape": [L]}}
    return {"shape": (shape, ["means.npy", "stds.npy"]),
            "energy": (energy, ["means_u.npy", "stds_u.npy"])}


@pytest.mark.parametrize("kind", ["shape", "energy"])
@pytest.mark.parametrize("exclude_zeros", [True, False])
def test_transform_fitting_matches_jax(tmp_path, kind, exclude_zeros):
    xml = make_binning_xml(tmp_path / "binning.xml", n_layers=L, n_r=R, n_alpha=A)
    cfg, files = _ds2_transforms(xml)[kind]
    if kind == "shape":
        cfg["GlobalStandardizeFromFile"]["exclude_zeros"] = exclude_zeros
    rng = np.random.default_rng(60)
    e_inc = (10 ** rng.uniform(3, 6, (64, 1))).astype(np.float32)
    showers = (rng.exponential(1.0, (64, V)) * (rng.random((64, V)) > 0.4)).astype(np.float32)
    showers *= 0.8 * e_inc / showers.sum(1, keepdims=True)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    port = ttf.build_pipeline(cfg, str(port_dir))
    x_p, c_p = ttf.apply_pipeline(port, showers, e_inc)
    x_r, c_r = jtf.apply_pipeline(jtf.build_pipeline(cfg, str(jax_dir)), showers, e_inc)
    np.testing.assert_array_equal(x_p, x_r)
    np.testing.assert_array_equal(c_p, c_r)
    for f in files:
        np.testing.assert_array_equal(np.load(port_dir / f), np.load(jax_dir / f))
    # what training wrote loads back to the same transform, forward and
    # reverse (the energy chain reverses as far as its u-features go)
    again = ttf.build_pipeline(cfg, str(port_dir))
    x2, c2 = ttf.apply_pipeline(again, showers, e_inc)
    np.testing.assert_array_equal(x2, x_p)
    start = 3 if kind == "energy" else 0
    np.testing.assert_array_equal(ttf.apply_pipeline(again[start:], x2, c2, rev=True)[0],
                                  jtf.apply_pipeline(jtf.build_pipeline(cfg, str(jax_dir))[start:],
                                                     x_r, c_r, rev=True)[0])


@pytest.mark.parametrize("frac", [(0.7, 0.3), (0.999, 0.0005)], ids=["70-30", "val-floor"])
def test_datasets_and_iterator_match_jax(tmp_path, frac):
    xml = make_binning_xml(tmp_path / "binning.xml")
    h5 = make_shower_hdf5(tmp_path / "showers.hdf5", n_events=203, n_voxels=60)
    for split in ("training", "validation", "full"):
        port = tds.CaloChallengeDataset(str(h5), "electron", str(xml), frac, split=split)
        ref = jds.CaloChallengeDataset(str(h5), "electron", str(xml), frac, split=split)
        np.testing.assert_array_equal(port.layers, ref.layers)
        np.testing.assert_array_equal(port.energy, ref.energy)
        np.testing.assert_array_equal(port.layer_boundaries, ref.layer_boundaries)
        if split == "validation":
            assert len(port) == max(1, int(203 * frac[1]))
    arrays = (port.layers, port.energy)
    it_p, it_r = tds.BatchIterator(arrays, 16, seed=3), jds.BatchIterator(arrays, 16, seed=3)
    assert it_p.batches_per_epoch == it_r.batches_per_epoch == 12
    for _ in range(30):  # crosses two epoch boundaries
        for a, b in zip(next(it_p), next(it_r)):
            np.testing.assert_array_equal(a, b)
    for bp, br in zip(it_p.epoch_batches(), it_r.epoch_batches()):
        np.testing.assert_array_equal(bp[0], br[0])


def _tiny_ds2(work: Path):
    """Overrides of calochallenge_ds2 for a tiny geometry on the CPU: 6
    layers x 4 alpha x 3 radial bins, 6 tokens of 12, depth 2, and
    ``attn_impl: fused`` so that K1's autograd path (plain versions on the
    CPU) trains."""
    make_binning_xml(work / "binning_dataset_2.xml", n_layers=L, n_r=R, n_alpha=A)
    make_shower_hdf5(work / "dataset_2_1.hdf5", n_events=160, n_voxels=V)
    return [f"data_dir={work}", f"base_dir={work}", "exp_name=Tiny", "run_name=run", "seed=3",
            f"model.shape=[{L},{A},{R}]", "model.patch_shape=[3,4,1]",
            "model.net.param.num_patches=[[2,1,3]]", "model.net.param.patch_dim=12",
            f"model.net.param.condition_dim={L + 1}", "model.net.param.hidden_dim=48",
            "model.net.param.depth=2", "model.net.param.num_heads=4",
            "model.net.param.attn_impl=fused",
            f"data.transforms.ScaleTotalEnergy.n_layers={L}",
            f"data.transforms.CutValues.n_layers={L}",
            f"data.transforms.AddFeaturesToCond.split_index={V}",
            f"data.transforms.Reshape.shape=[1,{L},{A},{R}]",
            "data.train_val_frac=[0.8,0.2]", "training.batchsize=16", "evaluate=false",
            "plot=false", "plotting.loss=false", "save_source=false", "ema=true"]


def test_launcher_trains_tiny_ds2_and_warm_starts(tmp_path):
    """``python -m vit4hep_tpu_torch.experiments.main`` trains 6 steps,
    validating every 3; a warm start from ``model_run0`` restores the saved
    state exactly and becomes run 1."""
    args = ["-cn", "calochallenge/cfm/calochallenge_ds2", *_tiny_ds2(tmp_path),
            "training.iterations=6", "training.validate_every_n_steps=3", "device=cpu"]
    subprocess.run([sys.executable, "-m", "vit4hep_tpu_torch.experiments.main", *args],
                   check=True, cwd=ROOT, timeout=300, capture_output=True)
    run = tmp_path / "runs" / "Tiny" / "run"
    for f in ("models/model_run0.pt", "config.yaml", "config_0.yaml", "means.npy", "stds.npy",
              "out_0.log"):
        assert (run / f).exists(), f
    records = [json.loads(line) for line in
               (tmp_path / "runs" / "Tiny" / "tracking" / "metrics_run.jsonl").read_text()
               .splitlines()]
    val = [r["value"] for r in records if r.get("key") == "val.loss"]
    train = [r["value"] for r in records if r.get("key") == "train.loss"]
    assert len(val) == 2 and train and all(math.isfinite(v) for v in val + train)
    assert "val loss" in (run / "out_0.log").read_text()

    saved = torch.load(run / "models" / "model_run0.pt", weights_only=True)
    assert saved["step"] == 6 and saved["ema_updates"] == 6 and saved["lr_scale"] == 1.0
    exp = main(["-cp", str(run), "-cn", "config", "warm_start_idx=0", "train=false"],
               device="cpu")
    assert exp.cfg.run_idx == 1 and exp.state.step == 6 and exp.state.ema_updates == 6
    for k, v in exp.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    for e, s in zip(exp.state.ema, saved["ema"]):
        assert torch.equal(e, s)
    moments = exp.state.optimizer.state_dict()["state"]
    for i, s in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[i][key], s[key])
    assert exp.state.schedule.last_epoch == 6

    # and a warm-started run keeps training, as the next run of the run dir
    # (config.yaml now holds run_idx 1)
    exp = main(["-cp", str(run), "-cn", "config", "warm_start_idx=0", "train=true",
                "training.iterations=2"], device="cpu")
    assert exp.cfg.run_idx == 2 and exp.state.step == 8
    assert (run / "models" / "model_run2.pt").exists()


def test_launcher_evaluates_as_jax_and_trains_the_fused_tier(tmp_path):
    """The default ``evaluate: true`` runs to its end (``evaluate`` does
    nothing, as in JAX), here with ``fused_block: true``: the launcher
    trains through the megakernel tier (K5a/K5b's plain versions on the
    CPU) and validates through K2v's."""
    args = [a for a in _tiny_ds2(tmp_path) if a != "evaluate=false"]
    exp = main(["-cn", "calochallenge/cfm/calochallenge_ds2", *args, "evaluate=true",
                "model.net.param.fused_block=true", "training.iterations=2",
                "training.validate_every_n_steps=2"], device="cpu")
    assert exp.cfg.evaluate is True and exp.model.net.cfg.fused_block is True
    assert exp.state.step == 2 and len(exp.val_loss) == 1
    assert all(math.isfinite(v) for v in exp.train_loss + exp.val_loss)
    assert (tmp_path / "runs" / "Tiny" / "run" / "models" / "model_run0.pt").exists()


def test_launcher_surface():
    assert get_experiment("calogan_ft_cfm").__name__ == "CaloGANFTCFM"
    with pytest.raises(ValueError):
        get_experiment("nope")
    if not torch.cuda.is_available():
        from vit4hep_tpu_torch.experiments.base import resolve_device

        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda")
