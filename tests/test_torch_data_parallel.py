"""Data parallelism of the port (``parallel/mesh.py``, the train step's
all-reduce, the experiment and the launcher's ``distributed: true``)
against the JAX package and the port's own one-rank run, on the CPU.

Two gloo ranks on a (2, 1) grid, spawned once for the module
(``tests/torch_parallel.dp_worker``): two steps of a tiny ViT CFM with the
draws given (each rank its rows of the global x, c, t and x_0) against
JAX's step on a data = 2 mesh and the port's one-rank step (loss and
norms rtol 1e-5, parameters atol 1e-5 as ``tests/test_torch_train.py``
holds the port to optax); two steps with the draws made from a generator
for the global batch (``batch_loss(rows=)``) against the one-rank step on
the same generator; and the tiny ds2 experiment through
``CaloChallenge`` (a batch of 17 rounded to 16) against the same run on
one rank: the losses, the validation loss equal on both ranks, only rank
0's files, and its checkpoint warm-starting a one-rank run. Then the
launcher with ``distributed=true`` over two processes trains the tiny
energy CFM (the counterpart of ``tests/test_distributed_e2e.py``).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests.conftest import make_binning_xml, make_shower_hdf5
from tests.torch_parallel import (A, L, R, dp_worker, explicit_step, launch_env, run_ranks,
                                  state_of, tiny_cfm, tiny_ds2, training_cfg)
from vit4hep_tpu.experiments import train_state as jts
from vit4hep_tpu.models.calochallenge import CaloChallengeCFM as JaxCaloChallengeCFM
from vit4hep_tpu.models.vit import ViT as JaxViT
from vit4hep_tpu.parallel import mesh as jmesh
from vit4hep_tpu.utils.config import Config as JaxConfig
from vit4hep_tpu_torch.experiments import train_state as ts
from vit4hep_tpu_torch.experiments.main import main
from vit4hep_tpu_torch.utils.jax_params import convert_vit_params

ROOT = Path(__file__).resolve().parent.parent
V = L * A * R
SHAPE, PATCH = [L, A, R], [3, 4, 1]
PARAM = dict(dim=3, condition_dim=L + 1, hidden_dim=48, out_channels=1, depth=2, num_heads=4,
             mlp_ratio=2, pos_embedding_coords="cylindrical", num_patches=[[2, 1, 3]],
             patch_dim=12, attn_impl="fused")
TRAINING = dict(lr=1e-3, iterations=10, optimizer="AdamW", betas=[0.9, 0.999], eps=1e-6,
                weight_decay=0.1, scheduler="CosineAnnealingLR", scheduler_scale=1,
                cosanneal_eta_min=0)


def _jax_loss(jmodel):
    def loss_fn(params, x, c, t, x_0, rng):
        del rng
        x_t, x_t_dot = jmodel.trajectory(x_0, x, t)
        return jnp.mean((jmodel.forward(params, x_t, t.reshape(-1, 1), c) - x_t_dot) ** 2)

    return loss_fn


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(7)
    jmodel = JaxCaloChallengeCFM(JaxViT(PARAM), patch_shape=PATCH, shape=SHAPE)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32)
                          + rng.normal(0, 0.05, a.shape).astype(np.float32),
                          jmodel.init_params(jax.random.PRNGKey(5)))
    batches = [(rng.normal(size=(8, 1, *SHAPE)), rng.uniform(size=(8, L + 1)),
                rng.uniform(size=(8, 1, 1, 1, 1)), rng.normal(size=(8, 1, *SHAPE)))
               for _ in range(2)]
    batches = [tuple(np.asarray(a, np.float32) for a in b) for b in batches]
    make_binning_xml(work / "binning_dataset_2.xml", n_layers=L, n_r=R, n_alpha=A)
    make_shower_hdf5(work / "dataset_2_1.hdf5", n_events=160, n_voxels=V)
    case = {"param": PARAM, "shape": SHAPE, "patch_shape": PATCH, "batches": batches,
            "sd": convert_vit_params(params),
            "experiment": tiny_ds2(work, work / "two", 17)}
    ranks = run_ranks(dp_worker, 2, work / "ranks", case)

    # JAX's step on a data = 2 mesh
    mesh = jmesh.create_mesh(num_devices=2)
    tx = jts.make_optimizer(JaxConfig(TRAINING), jts.make_schedule(JaxConfig(TRAINING)))
    jstate = jmesh.replicate(jts.create_train_state(params, tx, use_ema=True), mesh)
    jstep = jax.jit(jts.make_train_step(_jax_loss(jmodel), tx, clip_grad_norm=1.0,
                                        ema_decay=0.999))
    jax_steps = []
    for b in batches:
        jstate, jm = jstep(jstate, jmesh.shard_batch(b, mesh), jax.random.PRNGKey(0))
        jax_steps.append(({k: float(v) for k, v in jm.items()},
                          convert_vit_params(jax.tree.map(np.asarray, jstate.params))))

    # the port on one rank: the same steps, the drawn ones, the experiment
    model = tiny_cfm(PARAM, SHAPE, PATCH)
    state = state_of(model, case["sd"], training_cfg())
    step = explicit_step(model)
    one = []
    for b in batches:
        m = step(state, tuple(map(torch.from_numpy, b)))
        one.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in model.net.state_dict().items()}))
    model = tiny_cfm(PARAM, SHAPE, PATCH)
    state = state_of(model, case["sd"], training_cfg())
    gen = torch.Generator().manual_seed(11)
    step = ts.make_train_step(lambda x, c: model.batch_loss(x, c, generator=gen),
                              clip_grad_norm=1.0, ema_decay=0.999)
    drawn = [float(step(state, tuple(map(torch.from_numpy, b[:2])))["loss"]) for b in batches]
    exp = main(["-cn", "calochallenge/cfm/calochallenge_ds2",
                *tiny_ds2(work, work / "one", 16)], device="cpu")
    return {"work": work, "ranks": ranks, "jax": jax_steps, "one": one, "drawn": drawn,
            "drawn_params": {k: v.clone() for k, v in model.net.state_dict().items()},
            "exp": exp}


def test_two_rank_step_matches_jax_and_one_rank(run):
    for out in run["ranks"]:
        assert out["grid"] == {"data": 2, "model": 1}
        for (m, sd), (jm, jsd), (om, osd) in zip(out["explicit"], run["jax"], run["one"]):
            for k in ("loss", "grad_norm", "grad_norm_net"):
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=k)
                np.testing.assert_allclose(m[k], om[k], rtol=1e-5, err_msg=k)
            assert m["skipped"] == 0
            for k, v in jsd.items():
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
                np.testing.assert_allclose(sd[k].numpy(), osd[k].numpy(), atol=1e-5, err_msg=k)


def test_draws_for_the_global_batch_match_one_rank(run):
    rows = [out["rows"] for out in run["ranks"]]
    assert [(r.start, r.stop, r.total) for r in rows] == [(0, 4, 8), (4, 8, 8)]
    for out in run["ranks"]:
        np.testing.assert_allclose(out["drawn"], run["drawn"], rtol=1e-5)
        for k, v in run["drawn_params"].items():
            np.testing.assert_allclose(out["drawn_params"][k].numpy(), v.numpy(), atol=1e-5)


def test_experiment_losses_match_one_rank_and_ranks_agree(run):
    one = run["exp"]
    r0, r1 = (out["exp"] for out in run["ranks"])
    assert r0["batch_size"] == r1["batch_size"] == one.batch_size == 16  # 17 rounded
    np.testing.assert_allclose(r0["train_loss"], one.train_loss, rtol=1e-5)
    assert r0["train_loss"] == r1["train_loss"]
    assert len(r0["val_loss"]) == 2 and r0["val_loss"] == r1["val_loss"]
    np.testing.assert_allclose(r0["val_loss"], one.val_loss, rtol=1e-5)
    log = (Path(r0["run_dir"]) / "out_0.log").read_text()
    assert "Rounded global batch size to 16 (data axis 2)" in log


def test_only_rank_zero_writes_and_its_checkpoint_loads_on_one_rank(run):
    two, one = run["work"] / "two" / "runs", run["work"] / "one" / "runs"
    r0, r1 = (out["exp"] for out in run["ranks"])
    assert r0["save"] and not r1["save"]
    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*"))  # noqa: E731
    assert files(two) == files(one)
    saved = torch.load(two / "Tiny" / "run" / "models" / "model_run0.pt", weights_only=True)
    exp = main(["-cp", str(two / "Tiny" / "run"), "-cn", "config", "warm_start_idx=0",
                "train=false", "distributed=false"], device="cpu")
    assert exp.state.step == 4 and exp.world_size == 1
    for k, v in exp.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k


N_LAYERS = 4


def _energy_cfg(tmp_path, xml, h5):
    """tests/test_distributed_e2e.py's tiny energy CFM run, for the port."""
    return {
        "exp_type": "calochallenge", "exp_name": "DistE2E", "run_name": "dist",
        "base_dir": str(tmp_path), "seed": 3, "save": True, "use_mlflow": False,
        "save_source": False, "ema": True, "train": True, "evaluate": False, "plot": False,
        "dtype": "float32", "model_type": "energy", "sample_us": False, "distributed": True,
        "n_samples": 32, "plotting": {"loss": False},
        "data": {
            "training_file": str(h5), "test_file": str(h5), "particle_type": "photon",
            "xml_filename": str(xml), "train_val_frac": [0.9, 0.1],
            "transforms": {
                "NormalizeByElayer": {"ptype": str(xml), "xml_file": "photon"},
                "ScaleTotalEnergy": {"n_layers": N_LAYERS, "factor": 0.35},
                "SelectDims": {"start": -N_LAYERS, "end": 0},
                "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
                "StandardizeUsFromFile": {"n_us": N_LAYERS, "model_dir": None},
                "LogEnergy": {}, "ScaleEnergy": {"e_min": 6.9, "e_max": 13.8},
                "Reshape": {"shape": [N_LAYERS]}}},
        "model": {
            "_target_": "models.base_model.CFM", "shape": [N_LAYERS],
            "odeint_kwargs": {"method": "rk4", "options": {"step_size": 0.25}},
            "net": {"_target_": "nn.cfm.transformer_cfm.ParallelTransformer",
                    "param": {"dims_in": N_LAYERS, "dims_c": 1, "dim_embedding": 16,
                              "nhead": 2, "num_encoder_layers": 1, "num_decoder_layers": 1,
                              "dim_feedforward": 32, "embeds": True, "encode_t_dim": 16}}},
        "training": {
            "iterations": 6, "batchsize": 64, "batchsize_sample": 64, "optimizer": "Adam",
            "lr": 1e-3, "scheduler": None, "es_patience": 1000, "es_load_best_model": False,
            "validate_every_n_steps": 3, "log_every_n_steps": 0, "ema_decay": 0.999},
        "evaluation": {"eval_dataset": "2", "batchsize": 64},
    }


def test_launcher_distributed_two_processes(tmp_path):
    xml = make_binning_xml(tmp_path / "binning.xml", particle="photon", n_layers=N_LAYERS)
    h5 = make_shower_hdf5(tmp_path / "showers.hdf5", n_events=512, n_voxels=60)
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    with open(cfg_dir / "dist.yaml", "w") as f:
        yaml.safe_dump(_energy_cfg(tmp_path, xml, h5), f, sort_keys=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # output to files: a full pipe would block a rank inside a collective
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-m", "vit4hep_tpu_torch.experiments.main",
                               "-cp", str(cfg_dir), "-cn", "dist", "device=cpu"],
                              env=launch_env(r, 2, port), cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    assert "Rank 0 of 2: grid {'data': 2, 'model': 1}" in outs[0]
    run_dir = tmp_path / "runs" / "DistE2E" / "dist"
    assert (run_dir / "models" / "model_run0.pt").exists()
    assert (run_dir / "config.yaml").exists()
    assert "no outputs will be saved" in outs[1]
    assert "Finished training" not in outs[1] and "Finished training" in outs[0]
    assert "Run finished" in outs[0]
    saved = torch.load(run_dir / "models" / "model_run0.pt", weights_only=True)
    assert saved["step"] == 6
    assert all(torch.isfinite(v).all() for v in saved["model"].values())
    assert os.path.getsize(run_dir / "out_0.log") > 0


def test_mesh_and_launcher_refusals(tmp_path):
    """What the grid and the launcher refuse, without a process group."""
    from vit4hep_tpu_torch.parallel import mesh as mesh_lib

    grid = mesh_lib.create_mesh()
    assert grid.shape == {"data": 1, "model": 1} and grid.data_group is None
    assert mesh_lib.shard_batch((np.arange(6),), grid)[0].tolist() == list(range(6))
    with pytest.raises(ValueError, match="one process per device"):
        mesh_lib.create_mesh(num_devices=2)
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        mesh_lib.create_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        mesh_lib.init_distributed("nccl", "cpu", rank=0, world_size=1)
    with pytest.raises(NotImplementedError, match="use_float64"):
        main(["-cn", "calochallenge/cfm/calochallenge_ds2", "use_float64=true"], device="cpu")
