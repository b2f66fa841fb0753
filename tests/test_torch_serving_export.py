"""The port's serving artifact (``vit4hep_tpu_torch/utils/serving.py``:
``torch.export`` programs with the kernels as registered custom ops,
``ops/library.py``) and its CLI (``vit4hep_tpu_torch/tools/export_sampler.py``),
on the CPU:

- a tiny CFM chain (ds2-like geometry, ``fused_block: sample``: K3 and K2v's
  launches) and a tiny cINN chain (binned couplings with ``fused_spline``
  and ``attn_impl: fused`` subnets: K4 and K1's forward) behind a tiny energy
  CFM, RK4 step 0.25: after a round trip through a file, the artifact's
  showers equal the live ``Generator``'s on the same seed, bit for bit (the
  ops' CPU implementations are the plain versions the live CPU path runs,
  in the same order); the program holds each op once for each launch the
  live path makes on the card, and no ``set_grad_enabled`` switch;
- one model's ``sample_batch`` as a sampler artifact, equal to it;
- JAX's ``read_header`` reads the port's header; the cond-shape and magic
  guards (as ``tests/test_serving.py``); a JAX artifact and a CUDA artifact
  on a host without a card are refused;
- the CLI from run dirs trained through the launcher: CaloChallenge (the
  generator equals the live ``Generator`` of the same run, bit for bit) and
  LEMURS and CaloGAN, whose generators take the conditions of their staged
  ``sample_n`` (``energy_cond_width`` 3, the u's last) and equal its
  showers on the same noise within 1e-5 of scale (staged numpy transforms
  against the chain's device twins).
"""

import json
import struct
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_chain import A, L, R, _energy_param, _pipelines, _shape_param
from vit4hep_tpu.utils import serving as jserving
from vit4hep_tpu_torch.experiments.main import main
from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCFM, CaloChallengeCINN
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import ViT
from vit4hep_tpu_torch.tools import export_sampler
from vit4hep_tpu_torch.utils import serving

ROOT = Path(__file__).resolve().parent.parent
ODE = {"method": "rk4", "options": {"step_size": 0.25}}
B = 4
EVALS = 16  # 4 RK4 steps of 4 evals


def _perturbed(*models, seed=0):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in models:
            for p in m.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return models


def _energy(ode=ODE):
    return CFM(ParallelTransformer(_energy_param()), shape=[L], odeint_kwargs=ode)


# one Euler step: the sampler tests need no depth
ONE_STEP = {"method": "euler", "options": {"step_size": 1.0}}


def _cinn():
    vit = {"dim": 1, "condition_dim": L + 1, "hidden_dim": 32, "out_channels": 1, "depth": 2,
           "num_heads": 2, "mlp_ratio": 2.0, "learn_pos_embed": True, "attn_impl": "fused"}
    return CaloChallengeCINN(
        shape=[L, A, R], patch_shape=[[3, 2, 1]], in_channels=1,
        coupling_block="CaloRQSplineFrEIA", nblocks=2, is_spatial=[False, True],
        cinn_kwargs={"fused_spline": True, "bins": 10, "min_bin_sizes": [0.001, 0.001],
                     "default_domain": [-8.0, 8.0, -8.0, 8.0]}, vit_kwargs=vit)


def _ops(program):
    return Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("vit4hep."))


# launches a request of each chain's kernels on the card: the CFM's ViT at
# depth 2 (GEMM 2 + 4 x 2, modln 2 x 2 + 1, attention 2 an eval) and K3 an
# energy eval; the cINN's K4 on each coupling side (2 couplings, two-sided),
# K1's forward in each subnet block (4 subnets of depth 2)
CHAINS = {
    "cfm": (lambda: CaloChallengeCFM(ViT(_shape_param()), patch_shape=[3, 4, 1],
                                     shape=[L, A, R], odeint_kwargs=ODE),
            {"vit_gemm": 10 * EVALS, "vit_modln": 5 * EVALS, "vit_attention": 2 * EVALS,
             "energy_decoder": EVALS}),
    "cinn": (_cinn, {"binned_rqs_inverse": 4, "qkv_attention_fwd": 8,
                     "energy_decoder": EVALS}),
}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_artifact_equals_the_live_generator(tmp_path, chain):
    build, ops = CHAINS[chain]
    (shape_tf, energy_tf), _ = _pipelines(tmp_path)
    torch.manual_seed(0)
    shape, energy = _perturbed(build(), _energy())
    gen = serving.Generator(shape, energy, energy_tf, shape_tf, batch=B)
    program, header = serving.trace_generator(shape, energy, energy_tf, shape_tf, B,
                                              meta={"chain": chain})
    assert dict(_ops(program)) == ops
    assert not any("set_grad" in str(n.target) for n in program.graph.nodes)
    path = tmp_path / "generator.v4h"
    path.write_bytes(serving.artifact_bytes(program, header))
    art = serving.load_sampler(path)
    assert art.header["noise_shapes"] == [[B, L], list(serving.noise_shape(shape, B))]
    assert art.header["cond_dim"] == gen.cond_dim == 1
    for seed in (0, 7):
        cond = gen.condition(10 ** np.random.default_rng(seed).uniform(3, 6, B))
        live = gen(cond, seed=seed)
        out = art(cond, seed=seed)
        assert out.shape == live.shape == (B, 1, L, A, R) and torch.isfinite(out).all()
        assert torch.equal(out, live)


def test_sampler_artifact_equals_sample_batch(tmp_path):
    torch.manual_seed(1)
    (energy,) = _perturbed(_energy(ONE_STEP), seed=1)
    header = serving.save_sampler(tmp_path / "s.v4h", energy, B, meta={"run": "x"})
    assert header["kind"] == "sampler" and header["out_shape"] == [B, L]
    art = serving.load_sampler(tmp_path / "s.v4h")
    cond = torch.rand(B, 1)
    (noise,) = art.noise(3)
    assert torch.equal(art(cond, seed=3), energy.sample_batch(cond, x_T=noise))


def test_headers_guards_and_refusals(tmp_path):
    torch.manual_seed(2)
    (energy,) = _perturbed(_energy(ONE_STEP), seed=2)
    path = tmp_path / "s.v4h"
    header = serving.save_sampler(path, energy, B)
    # JAX's reader takes the port's header: the same layout and fields
    jheader = jserving.read_header(path)
    assert jheader == header and jheader["format"] == "torch.export"
    for key in ("version", "kind", "batch", "cond_dim", "out_shape", "platforms", "model",
                "meta"):
        assert key in jheader
    assert jheader["platforms"] == ["cpu"]

    art = serving.load_sampler(path)
    with pytest.raises(ValueError, match="cond shape"):
        art(np.zeros((B + 1, 1), np.float32))
    bad = tmp_path / "bad.v4h"
    bad.write_bytes(b"NOTMAGIC" + path.read_bytes()[8:])
    for fn in (serving.load_sampler, serving.read_header):
        with pytest.raises(ValueError, match="not a vit4hep"):
            fn(bad)

    def rewritten(name, **fields):
        blob = path.read_bytes()
        (n,) = struct.unpack("<I", blob[8:12])
        hdr = json.loads(blob[12:12 + n])
        hdr.update(fields)
        hdr = {k: v for k, v in hdr.items() if v is not None}
        raw = json.dumps(hdr).encode()
        out = tmp_path / name
        out.write_bytes(blob[:8] + struct.pack("<I", len(raw)) + raw + blob[12 + n:])
        return out

    # a JAX artifact (jax.export, no format in its header)
    import jax

    from vit4hep_tpu.models.cfm import CFM as JaxCFM
    from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer

    jmodel = JaxCFM(JaxParallelTransformer(_energy_param()), shape=[L], odeint_kwargs=ONE_STEP)
    jpath = tmp_path / "jax.v4h"
    jserving.save_sampler(jpath, jmodel, jmodel.init_params(jax.random.PRNGKey(0)), B)
    with pytest.raises(ValueError, match="jax.export artifact"):
        serving.load_sampler(jpath)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            serving.load_sampler(rewritten("cuda.v4h", platforms=["cuda"]))


def test_this_slices_modules_import_no_jax():
    """Loading an artifact, the CLI, the record cache, the converters and
    the AR net need nothing of JAX or of the JAX package."""
    code = ("import sys, vit4hep_tpu_torch.utils.serving, vit4hep_tpu_torch.ops.library, "
            "vit4hep_tpu_torch.tools.export_sampler, vit4hep_tpu_torch.data.native_cache, "
            "vit4hep_tpu_torch.utils.torch_migration, vit4hep_tpu_torch.models.ar_transformer; "
            "bad = [m for m in sys.modules "
            "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'vit4hep_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


# ---------------------------------------------------------------------------
# the CLI from run dirs trained through the launcher
# ---------------------------------------------------------------------------
def _calochallenge_runs(work):
    from tests.test_torch_sampling import _energy_args, _shape_args
    from tests.conftest import make_binning_xml, make_shower_hdf5

    make_binning_xml(work / "binning_dataset_2.xml", n_layers=L, n_r=R, n_alpha=A)
    make_shower_hdf5(work / "dataset_2_1.hdf5", n_events=160, n_voxels=L * A * R)
    make_shower_hdf5(work / "dataset_2_2.hdf5", n_events=64, n_voxels=L * A * R, seed=1)
    energy_run = work / "runs" / "TinyE" / "energy"
    main([*_energy_args(work, iterations=2), "ema=true", "device=cpu"])
    main([*_shape_args(work, energy_run, iterations=2), "plot=false",
          "model.net.param.fused_block=sample", "device=cpu"])
    return work / "runs" / "TinyS" / "shape"


def test_cli_exports_a_calochallenge_run(tmp_path):
    run = _calochallenge_runs(tmp_path)
    out = tmp_path / "g.v4h"
    header = export_sampler.main(["-cp", str(run), "--batch", str(B), "--out", str(out),
                                  "--device", "cpu"])
    assert header["kind"] == "generator" and header["meta"]["checkpoint"] == "model_run0"
    assert header["u_position"] == "first" and header["energy_cond_width"] is None
    art = serving.load_sampler(out)
    exp, _ = export_sampler.load_run(run, device="cpu")
    exp.load_energy_model()
    gen = serving.Generator(exp.model, exp.energy_model, exp.energy_model_transforms,
                            exp.transforms, batch=B)
    cond = gen.condition(10 ** np.random.default_rng(1).uniform(3, 6, B))
    assert torch.equal(art(cond, seed=2), gen(cond, seed=2))
    # a run without an energy model exports its sampler (EMA weights: ema=true)
    energy_run = tmp_path / "runs" / "TinyE" / "energy"
    header = export_sampler.main(["-cp", str(energy_run), "--batch", str(B), "--device", "cpu"])
    assert header["kind"] == "sampler" and header["meta"]["ema"] is True
    assert (energy_run / "sampler.v4h").exists()


def _lemurs_runs(work):
    from tests.test_torch_lemurs import _common, _write_config_files

    _write_config_files(work, "lemurs/lemurs_energy_ODD")
    _write_config_files(work, "lemurs/lemurs")
    main(["-cn", "lemurs/lemurs_energy_ODD", *_common(work, "E", 4), "plot=false",
          "model.net.param.nhead=2", "model.net.param.num_encoder_layers=1",
          "model.net.param.num_decoder_layers=1", "model.net.param.dim_feedforward=32",
          "model.net.param.encode_t_dim=16"], device="cpu")
    return main(["-cn", "lemurs/lemurs", *_common(work, "S", 5), "plot=false",
                 "model.net.param.hidden_dim=24", "model.net.param.depth=1",
                 "model.net.param.num_heads=2", f"energy_model={work / 'runs' / 'E' / 'run'}"],
                device="cpu")


def _calogan_runs(work):
    from tests.test_torch_calogan import _common, _events, _write

    for name, n, seed in (("train_eplus", 40, 1), ("test_eplus", 12, 2)):
        _write(work / f"{name}.hdf5", _events(n, seed))
    main(["-cn", "calogan/calogan_eplus_energy", *_common(work, "E", 4), "plot=false",
          "model.net.param.dim_embedding=16", "+model.net.param.encode_t_dim=16",
          "model.net.param.nhead=2", "model.net.param.num_encoder_layers=1",
          "model.net.param.num_decoder_layers=1", "model.net.param.dim_feedforward=32"],
         device="cpu")
    return main(["-cn", "calogan/calogan", *_common(work, "S", 5), "plot=false",
                 "model.net.param.hidden_dim=24", "model.net.param.depth=1",
                 "model.net.param.num_heads=2", f"energy_model={work / 'runs' / 'E' / 'run'}"],
                device="cpu")


@pytest.mark.parametrize("family,layout", [("lemurs", ("first", 3)), ("calogan", ("last", None))])
def test_cli_family_generator_takes_the_staged_conditions(tmp_path, family, layout):
    shape = (_lemurs_runs if family == "lemurs" else _calogan_runs)(tmp_path)
    run = tmp_path / "runs" / "S" / "run"
    out = tmp_path / "g.v4h"
    header = export_sampler.main(["-cp", str(run), "--batch", "8", "--out", str(out),
                                  "--device", "cpu"])
    assert (header["u_position"], header["energy_cond_width"]) == layout
    art = serving.load_sampler(out)
    shape.cfg.sample_us = True
    shape.cfg.n_samples = 8
    shape.cfg.training.batchsize_sample = 8
    conds = shape.draw_conditions(8, np.random.default_rng(0))
    cond = shape.sampling_conditions(conds)
    energy_noise, shape_noise = art.noise(seed=5)
    staged, full_cond = shape.sample_n(noise=([energy_noise], [shape_noise]), conditions=conds)
    assert cond.shape == (8, header["cond_dim"])
    got = art(cond, seed=5).numpy()
    assert got.shape == staged.shape
    np.testing.assert_allclose(got, staged, atol=1e-5 * np.abs(staged).max())
