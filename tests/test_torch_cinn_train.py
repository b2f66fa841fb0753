"""cINN training in the port against the JAX package, on the CPU.

- The train step: the same converted initial params
  (vit4hep_tpu_torch.utils.jax_params) and the same numpy batches go
  through JAX ``make_train_step`` with optax and the port's
  ``make_train_step`` with torch.optim, the shipped ``training/cinn/ds23``
  recipe (AdamW, lr 1e-4, weight decay 0.1, cosine, ``clip_grad_norm:
  1000``, EMA): the gradients of the first batch, the loss, ``grad_norm``
  and ``grad_norm_net`` after every step, the params and the EMA after the
  last of 3 steps, for a tiny cINN of each coupling type (binned, nflows
  two-sided and one-sided, the energy cINN) and one on ds1 photons' (53,
  1, 10) grid (53 tokens a half). ``remat_spline`` and the ViT1D twins'
  training reduce to these: ``remat_spline`` gives the same gradients, bit
  for bit, as without it (below), and the twins the composed subnets'
  (tests/test_torch_cinn_rest.py).
- The launcher trains a tiny ds2 cINN (EMA, validation loss, checkpoint,
  warm start; a flow rebuilt from the config has the checkpoint's seed-
  derived permutations), and an energy cINN run with a shape cINN run
  behind it samples through ``sample_n``, staged and fused, and through
  ``Generator``.

Tolerances (f32 forward and backward on both sides, summation order only;
the fused tier's products take bf16 multiplicands on both sides): losses
rtol 1e-5; each gradient within 1e-4 of its tensor's max |g|, the norms
rtol 1e-4; params and EMA atol 1e-5 after the 3 steps, a tenth of one
step's lr, with Adam's eps at 1e-6 for the reason tests/test_torch_train.py
gives (an entry whose true gradient is ~0 carries rounding noise that
Adam's division by its own RMS turns into an update of up to lr, in either
direction; a wrong update rule is off by ~lr).
"""

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_binning_xml, make_shower_hdf5
from vit4hep_tpu.experiments import train_state as jts
from vit4hep_tpu.models.calochallenge import CaloChallengeCINN as JaxCaloChallengeCINN
from vit4hep_tpu.models.calochallenge import CaloChallengeEnergyCINN as JaxEnergyCINN
from vit4hep_tpu.utils.config import Config as JaxConfig
from vit4hep_tpu_torch.experiments import train_state as ts
from vit4hep_tpu_torch.experiments.main import main
from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCINN, CaloChallengeEnergyCINN
from vit4hep_tpu_torch.utils.config import Config
from vit4hep_tpu_torch.utils.jax_params import convert_cinn_params

ROOT = Path(__file__).resolve().parent.parent
L, A, R = 6, 4, 3
V = L * A * R
B = 4
# training/default.yaml with training/cinn/ds23.yaml on top, eps 1e-6
TRAINING = dict(lr=1e-4, iterations=10, optimizer="AdamW", betas=[0.9, 0.999], eps=1e-6,
                weight_decay=0.1, scheduler="CosineAnnealingLR", scheduler_scale=1,
                cosanneal_eta_min=0, clip_grad_norm=1000, ema_decay=0.9999)


def _binned(**kw):
    return {"fused_spline": True, "bins": 10, "min_bin_sizes": [0.001, 0.001],
            "default_domain": [-8.0, 8.0, -8.0, 8.0], "identity_tails": False,
            "domain_clamping": None, **kw}


def _cinn_kwargs(coupling="CaloRQSplineFrEIA", cinn=None, shape=(L, A, R), patch=(3, 2, 1),
                 spatial=(False, True), **vit):
    return dict(shape=list(shape), patch_shape=[list(patch)], in_channels=1,
                coupling_block=coupling, nblocks=len(spatial), is_spatial=list(spatial),
                cinn_kwargs=_binned() if cinn is None else cinn,
                vit_kwargs={"dim": 1, "condition_dim": 5, "hidden_dim": 32, "out_channels": 1,
                            "depth": 1, "num_heads": 2, "mlp_ratio": 2.0,
                            "learn_pos_embed": True, "causal_attn": False,
                            "checkpoint_grads": False, **vit})


NFLOWS = {"num_bins": 8, "bounds_init": 4}
CASES = {
    "binned": _cinn_kwargs(),
    "nflows": _cinn_kwargs("CaloRQSplineNFlows", NFLOWS),
    "nflows-onesided": _cinn_kwargs("OneSidedCaloRQSplineNFlows", NFLOWS),
    # ds1 photons' grid: 106 tokens of 5, 53 a half; one coupling
    "ds1-photons": _cinn_kwargs(shape=(53, 1, 10), patch=(1, 1, 5), spatial=(False,),
                                hidden_dim=16),
    "energy": dict(shape=[L], coupling_block="RQSplineNFlows", nblocks=3,
                   cinn_kwargs={"num_bins": 14, "bounds_init": 25},
                   subnet_kwargs={"n_layers": 3, "hidden_channels": [32] * 3, "dropout": 0.0}),
}


def _pair(name, rng):
    kw = CASES[name]
    jcls, cls = ((JaxEnergyCINN, CaloChallengeEnergyCINN) if name == "energy"
                 else (JaxCaloChallengeCINN, CaloChallengeCINN))
    jmodel = jcls(**kw)
    params = jax.tree.map(  # non-zero output layers, so that every coupling acts
        lambda a: np.asarray(a, np.float32) + rng.normal(0, 0.02, a.shape).astype(np.float32),
        jmodel.init_params(jax.random.PRNGKey(5)))
    model = cls(**kw)
    model.net.load_state_dict(convert_cinn_params(params))
    return jmodel, params, model


def _assert_params(sd_port, jparams, atol=1e-5):
    want = convert_cinn_params(jparams)
    assert set(want) == set(sd_port)
    for k, v in want.items():
        np.testing.assert_allclose(sd_port[k].detach().numpy(), v.numpy(), atol=atol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_cinn_train_step_matches_jax(name):
    rng = np.random.default_rng(60)
    jmodel, params, model = _pair(name, rng)
    tx = jts.make_optimizer(JaxConfig(TRAINING), jts.make_schedule(JaxConfig(TRAINING)))
    jstate = jts.create_train_state(params, tx, use_ema=True)
    jstep = jax.jit(jts.make_train_step(
        lambda p, x, c, key: jmodel.batch_loss(p, x, c, key), tx, clip_grad_norm=1000,
        ema_decay=0.999))
    state = ts.create_train_state(model, Config(TRAINING), use_ema=True)
    step = ts.make_train_step(lambda x, c: model.batch_loss(x, c), clip_grad_norm=1000,
                              ema_decay=0.999)
    batches = [((rng.normal(size=jmodel.x_shape(B)) * 0.7).astype(np.float32),
                rng.uniform(size=(B, model.condition_dim)).astype(np.float32)) for _ in range(3)]
    x, c = batches[0]
    want = convert_cinn_params(jax.jit(jax.grad(
        lambda p, x, c: jmodel.batch_loss(p, x, c, None)))(params, x, c))
    got = dict(zip([n for n, _ in model.net.named_parameters()], torch.autograd.grad(
        model.batch_loss(torch.from_numpy(x), torch.from_numpy(c)), list(model.net.parameters()))))
    for k, v in want.items():
        assert (got[k] - v).abs().max() <= 1e-4 * v.abs().max(), k
    for x, c in batches:
        jstate, jm = jstep(jstate, (x, c), jax.random.PRNGKey(0))
        m = step(state, (torch.from_numpy(x), torch.from_numpy(c)))
        for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-4), ("grad_norm_net", 1e-4)):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=rtol, err_msg=key)
        assert m["skipped"] == int(jm["skipped"]) == 0
    _assert_params(model.net.state_dict(), jstate.params)
    names = [n.removeprefix("net.") for n, p in model.named_parameters() if p.requires_grad]
    _assert_params(dict(zip(names, state.ema)), jstate.ema_params)
    assert state.step == int(jstate.step) == 3 == state.ema_updates


def test_remat_spline_gives_the_same_gradients():
    """The likelihood spline under torch.utils.checkpoint: the same loss and
    gradients, bit for bit, as the plain spline (the recomputed forward is
    the same arithmetic); the inverse is unchanged."""
    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.normal(size=(3, 1, L, A, R)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(size=(3, 5)).astype(np.float32))
    grads, losses, samples = [], [], []
    for remat in (False, True):
        torch.manual_seed(0)
        model = CaloChallengeCINN(**_cinn_kwargs(cinn=_binned(remat_spline=remat)))
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.02 * torch.randn_like(p))
        assert model.net.blocks[0].remat_spline is remat
        loss = model.batch_loss(x, c)
        loss.backward()
        losses.append(loss.detach())
        grads.append([p.grad for p in model.parameters()])
        samples.append(model.sample_batch(c, z=x))
    assert torch.equal(*losses) and torch.equal(*samples)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# through the launcher
# ---------------------------------------------------------------------------
def _common(work, name, run, seed):
    return [f"data_dir={work}", f"base_dir={work}", f"exp_name={name}", f"run_name={run}",
            f"seed={seed}", "data.train_val_frac=[0.8,0.2]", "training.batchsize=16",
            "evaluate=false", "plot=false", "plotting.loss=false", "save_source=false",
            "device=cpu"]


def _shape_args(work, run="shape", energy_run=None):
    """calochallenge/cinn/calochallenge_ds2_noise at the tiny geometry: 2
    couplings (the second spatial), ViT1D subnets of hidden 32."""
    return ["-cn", "calochallenge/cinn/calochallenge_ds2_noise", *_common(work, "TinyC", run, 3),
            f"model.shape=[{L},{A},{R}]", "model.patch_shape=[[3,2,1]]", "model.nblocks=2",
            "model.is_spatial=[false,true]", f"model.vit_kwargs.condition_dim={L + 1}",
            "model.vit_kwargs.hidden_dim=32", "model.vit_kwargs.depth=1",
            "model.vit_kwargs.num_heads=2", f"data.transforms.ScaleTotalEnergy.n_layers={L}",
            "data.transforms.SelectiveUniformNoise.exclusions="
            f"[{','.join(str(-i) for i in range(L, 0, -1))}]",
            f"data.transforms.AddFeaturesToCond.split_index={V}",
            f"data.transforms.Reshape.shape=[1,{L},{A},{R}]", "n_samples=10",
            "training.batchsize_sample=4", f"energy_model={energy_run or work}"]


def _energy_args(work, run="energy"):
    """calochallenge/cfm/calochallenge_ds2_energy with model=cinn/cinn_energy
    (14 bins, bound 25) at L u's: 2 couplings of MLPs 3 x 16."""
    return ["-cn", "calochallenge/cfm/calochallenge_ds2_energy", "model=cinn/cinn_energy",
            *_common(work, "TinyEC", run, 4), f"model.shape=[{L}]", "model.nblocks=2",
            "model.subnet_kwargs.hidden_channels=[16,16,16]",
            f"data.transforms.ScaleTotalEnergy.n_layers={L}",
            f"data.transforms.SelectDims.start=-{L}",
            f"data.transforms.StandardizeUsFromFile.n_us={L}",
            f"data.transforms.Reshape.shape=[{L}]", "training.iterations=4",
            "training.validate_every_n_steps=2"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    work = tmp_path_factory.mktemp("cinn_train")
    make_binning_xml(work / "binning_dataset_2.xml", n_layers=L, n_r=R, n_alpha=A)
    make_shower_hdf5(work / "dataset_2_1.hdf5", n_events=160, n_voxels=V)
    make_shower_hdf5(work / "dataset_2_2.hdf5", n_events=64, n_voxels=V, seed=1)
    return work


def test_launcher_trains_tiny_ds2_cinn_and_warm_starts(work):
    """``python -m vit4hep_tpu_torch.experiments.main`` on
    calochallenge_ds2_noise trains the cINN 6 steps with EMA, validating
    every 3 (finite train and validation losses, no skipped step); a warm
    start restores the saved state exactly, and a cINN rebuilt from the
    run's config with the checkpoint's weights gives the trained model's
    log-likelihood bit for bit (its Permutes are the seed-derived ones)."""
    args = [*_shape_args(work, "train"), "training.iterations=6",
            "training.validate_every_n_steps=3", "ema=true"]
    proc = subprocess.run([sys.executable, "-m", "vit4hep_tpu_torch.experiments.main", *args],
                          cwd=ROOT, timeout=300, capture_output=True)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    run = work / "runs" / "TinyC" / "train"
    for f in ("models/model_run0.pt", "config.yaml", "means.npy", "stds.npy", "out_0.log"):
        assert (run / f).exists(), f
    assert "val loss" in (run / "out_0.log").read_text()
    saved = torch.load(run / "models" / "model_run0.pt", weights_only=True)
    assert saved["step"] == 6 == saved["ema_updates"]
    assert all(not k.endswith(("perm", "perm_inv")) for k in saved["model"])

    exp = main(["-cp", str(run), "-cn", "config", "warm_start_idx=0", "train=true",
                "training.iterations=2", "training.validate_every_n_steps=1"], device="cpu")
    assert isinstance(exp.model, CaloChallengeCINN)
    assert exp.cfg.run_idx == 1 and exp.state.step == 8 and len(exp.val_loss) == 2
    assert all(math.isfinite(v) for v in exp.train_loss + exp.val_loss + exp.grad_norm_train)
    assert not any(exp.skipped)
    rebuilt = main(["-cp", str(run), "-cn", "config", "warm_start_idx=1", "train=false",
                    "save=false"], device="cpu")
    for k, v in exp.model.state_dict().items():
        assert torch.equal(v, rebuilt.model.state_dict()[k]), k
    x, c = (torch.as_tensor(a[:8]) for a in (exp.val_dataset.layers, exp.val_dataset.energy))
    with torch.no_grad():
        assert torch.equal(exp.model.log_prob(x, c), rebuilt.model.log_prob(x, c))


def test_energy_cinn_runs_behind_the_shape_cinn(work):
    """An energy-cINN run (model_type energy, calochallenge_ds2_energy with
    model=cinn/cinn_energy) and a shape-cINN run naming it: the shape
    experiment's ``load_energy_model`` builds the energy cINN from the run;
    ``sample_n`` staged (``sample_us``) and fused (``fused_generation``) on
    the same per-batch noise give finite showers of the x shape, the fused
    chain within 1e-5 of the staged path (the u map on the device in f32
    against the host transforms); ``Generator`` serves MeV showers."""
    from vit4hep_tpu_torch.utils.serving import Generator

    energy_run = work / "runs" / "TinyEC" / "energy"
    launcher = [sys.executable, "-m", "vit4hep_tpu_torch.experiments.main"]
    procs = [subprocess.Popen([*launcher, *args], cwd=ROOT, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
             for args in (_energy_args(work), [*_shape_args(work, "shape", energy_run),
                                               "training.iterations=2",
                                               "training.validate_every_n_steps=2"])]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    shape_run = work / "runs" / "TinyC" / "shape"
    exp = main(["-cp", str(shape_run), "-cn", "config", "warm_start_idx=0", "train=false",
                "save=false"], device="cpu")
    exp.model.eval()
    exp.load_energy_model()
    assert isinstance(exp.energy_model, CaloChallengeEnergyCINN)
    want = torch.load(energy_run / "models" / "model_run0.pt", weights_only=True)["model"]
    for k, v in exp.energy_model.state_dict().items():
        assert torch.equal(v, want[k]), k

    gen = torch.Generator().manual_seed(7)
    n_batches = 3  # 10 samples at batch 4, the last padded
    noise = tuple([torch.randn(shape, generator=gen).numpy() for _ in range(n_batches)]
                  for shape in ((4, L), (4, 1, L, A, R)))
    out = {}
    for fused in (False, True):
        exp.cfg.fused_generation = fused
        np.random.seed(5)
        out[fused] = exp.sample_n(noise=noise)
        assert exp.last_sampling_fused is fused
    (staged, c_staged), (fused, c_fused) = out[False], out[True]
    assert staged.shape == (10, 1, L, A, R) and c_staged.shape == (10, L + 1)
    assert np.isfinite(staged).all() and np.isfinite(c_staged).all()
    np.testing.assert_allclose(c_fused, c_staged, atol=1e-5 * np.abs(c_staged).max(), rtol=0)
    np.testing.assert_allclose(fused, staged, atol=1e-5 * np.abs(staged).max(), rtol=0)

    server = Generator(exp.model, exp.energy_model, exp.energy_model_transforms,
                       exp.transforms, batch=4)
    mev = server.sample_showers(10 ** np.random.default_rng(2).uniform(3, 6, 4), seed=1)
    assert mev.shape == (4, V) and np.isfinite(mev).all() and (mev >= 0).all()
