#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the ds2 two-stage shower
generator at full width, through the hand-written CUDA kernels.

    python3 chip_smoke.py        # from the repository root, on a machine with a GPU

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: requires CUDA (no CPU path); prints the card's name and power limit;
2. build: compiles every kernel of the path from ``vit4hep_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and prints the seconds;
3. kernels: calls each kernel's wrapper at the ds2 shapes of the main path
   (batch 256) and holds it against its plain PyTorch version on the same
   inputs, with the tolerance stated beside it; times both with CUDA events;
4. slice: builds the ds2 energy model (cfm_ds2_energy) and shape model
   (cfm_ds2_electrons) at full width with random weights from a seed
   (non-zero adaLN and final-layer weights), and answers REQUESTS requests
   of BATCH incident energies through ``Generator.sample_showers``. The
   launch counters are set to 0 just before and read just after: every
   kernel must have run on every net eval. The MeV showers must be finite,
   non-negative and of shape (BATCH, 6480); a small batch is held against
   the same generator on the composed plain-PyTorch nets with the same noise;
5. profile: one more request timed by layer (energy stage, shape stage, host
   transforms) and under ``torch.profiler`` (device time per kernel, the
   device's idle share).

The line before the last is the ``{"kernels": [...]}`` summary; the last line
is ``{"ok": true, "device": {...}}``. Needs no network, no PyYAML and
nothing of JAX or of the JAX package: the ds2 configs are written out below
(tests/test_torch_chain.py holds them equal to the YAML files).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from vit4hep_tpu_torch.data.calochallenge.transforms import build_pipeline
from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops import fused_dit_block as fdb
from vit4hep_tpu_torch.ops import fused_energy_decoder as fed
from vit4hep_tpu_torch.utils.config import instantiate
from vit4hep_tpu_torch.utils.serving import Generator

SEED = 0
BATCH = 256
REQUESTS = 3
REFERENCE_BATCH = 8

# configs/model/cfm/cfm_ds2_electrons.yaml
DS2_SHAPE_MODEL = {
    "_target_": "vit4hep_tpu.models.calochallenge.CaloChallengeCFM",
    "in_channels": 1,
    "shape": [45, 16, 9],
    "patch_shape": [3, 16, 1],
    "time_distribution": "uniform",
    "trajectory": "linear",
    "odeint_kwargs": {"method": "rk4", "options": {"step_size": 0.05}},
    "net": {
        "_target_": "vit4hep_tpu.models.vit.ViT",
        "param": {
            "dim": 3, "condition_dim": 46, "hidden_dim": 480, "out_channels": 1,
            "depth": 6, "num_heads": 6, "mlp_ratio": 4, "attn_drop": 0.0,
            "proj_drop": 0.0, "pos_embedding_coords": "cylindrical",
            "temperature": 10000, "learn_pos_embed": True, "causal_attn": False,
            "checkpoint_grads": False, "num_patches": [[15, 1, 9]], "patch_dim": 48,
            "attn_impl": "auto", "fused_block": "sample", "compute_dtype": "float32",
        },
    },
}

# configs/model/cfm/cfm_ds2_energy.yaml
DS2_ENERGY_MODEL = {
    "_target_": "vit4hep_tpu.models.cfm.CFM",
    "shape": [45],
    "time_distribution": "uniform",
    "trajectory": "linear",
    "odeint_kwargs": {"method": "rk4", "options": {"step_size": 0.05}},
    "net": {
        "_target_": "vit4hep_tpu.models.energy_transformer.ParallelTransformer",
        "param": {
            "dims_in": 45, "dims_c": 1, "dim_embedding": 64, "nhead": 4,
            "num_encoder_layers": 4, "num_decoder_layers": 4, "dim_feedforward": 512,
            "dropout": 0.0, "activation": "relu", "embeds": True, "encode_t_scale": 30,
            "fused_block": "sample", "fused_group": 8,
        },
    },
}

# data.transforms of configs/calochallenge/cfm/calochallenge_ds2.yaml
DS2_SHAPE_TRANSFORMS = {
    "NormalizeByElayer": {"ptype": "${data_dir}/binning_dataset_2.xml", "xml_file": "electron"},
    "ScaleTotalEnergy": {"n_layers": 45, "factor": 0.35},
    "CutValues": {"cut": 1.0e-7, "n_layers": 45},
    "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
    "GlobalStandardizeFromFile": {"model_dir": None, "eps": 1.0e-6},
    "LogEnergy": {},
    "ScaleEnergy": {"e_min": 6.907755, "e_max": 13.815510},
    "AddFeaturesToCond": {"split_index": 6480},
    "Reshape": {"shape": [1, 45, 16, 9]},
}

# data.transforms of configs/calochallenge/cfm/calochallenge_ds2_energy.yaml
DS2_ENERGY_TRANSFORMS = {
    "NormalizeByElayer": {"ptype": "${data_dir}/binning_dataset_2.xml", "xml_file": "electron"},
    "ScaleTotalEnergy": {"factor": 0.35, "n_layers": 45},
    "SelectDims": {"start": -45, "end": 0},
    "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
    "StandardizeUsFromFile": {"n_us": 45, "model_dir": None},
    "LogEnergy": {},
    "ScaleEnergy": {"e_min": 6.907755, "e_max": 13.815510},
    "Reshape": {"shape": [45]},
}

# tolerances of the kernel phases, relative to max(1, max |plain|):
# energy_decoder computes in f32 like its plain version (summation order
# only); the ViT kernels round their outputs (modln, GELU hidden, attention
# context) to bf16, whose ulp is 2^-8 = 3.9e-3 relative, so one rounding
# flip is within 8e-3; the whole forward takes bf16 multiplicands through 6
# blocks against an f32 plain version (the TPU kernel's precision contract).
TOL = {"energy_decoder": 1e-3, "vit_gemm": 8e-3, "vit_modln": 8e-3,
       "vit_attention": 8e-3, "fused_vit_forward": 2e-2}
REPLACES = {
    "energy_decoder": ("vit4hep_tpu_torch/csrc/energy_decoder.cu",
                       "vit4hep_tpu/ops/fused_energy_decoder.py:124"),
    "vit_gemm": ("vit4hep_tpu_torch/csrc/vit_forward.cu", "vit4hep_tpu/ops/fused_dit_block.py:1315"),
    "vit_modln": ("vit4hep_tpu_torch/csrc/vit_forward.cu", "vit4hep_tpu/ops/fused_dit_block.py:1315"),
    "vit_attention": ("vit4hep_tpu_torch/csrc/vit_forward.cu",
                      "vit4hep_tpu/ops/fused_dit_block.py:1315"),
}
COUNTERS = {"energy_decoder": fed.ENERGY_DECODER, "vit_gemm": fdb.GEMM,
            "vit_modln": fdb.MODLN, "vit_attention": fdb.ATTENTION}


class PhaseError(RuntimeError):
    pass


def _time_ms(fn, reps=10, warmup=2):
    """Median device time of one call, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _rel_err(out, ref):
    """(max abs error, the bound's scale max(1, max |ref|))."""
    err = (out.float() - ref.float()).abs().max().item()
    return err, max(1.0, ref.float().abs().max().item())


def _check(name, out, ref, results, kernel_fn, plain_fn):
    torch.cuda.synchronize()
    err, scale = _rel_err(out, ref)
    ok = math.isfinite(err) and err <= TOL[name] * scale
    prev = results.get(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ok": True})
    res = {"max_abs_err": max(prev["max_abs_err"], err),
           "ms": prev["ms"] + _time_ms(kernel_fn), "plain_ms": prev["plain_ms"] + _time_ms(plain_fn),
           "ok": prev["ok"] and ok}
    results[name] = res
    print(f"  {name}: max_abs_err {err:.3e} (bound {TOL[name]:g} x {scale:.3g}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)


def _rand(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * std


def kernel_phases(results):
    """Each kernel against its plain version at the ds2 shapes, batch BATCH.
    ms/plain_ms of vit_gemm add up one call at each of the six product
    shapes of a forward (embed, qkv, out-proj, fc1, fc2, final)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # K3: tgt (B, 45, 128), 4 layers, 4 heads, F 512, TE 64, head 512
    b, n, dm, te, fdim, hn, depth = BATCH, 45, 128, 64, 512, 512, 4
    ea = [_rand(gen, b, n, dm), _rand(gen, b, te), _rand(gen, b, depth, dm, std=0.1),
          1 + _rand(gen, depth, 3, dm, std=0.05), _rand(gen, depth, 3, dm, std=0.05),
          _rand(gen, depth, dm, 3 * dm, std=0.05), _rand(gen, depth, 3 * dm, std=0.05),
          _rand(gen, depth, dm, dm, std=0.05), _rand(gen, depth, dm, std=0.05),
          _rand(gen, depth, dm, fdim, std=0.05), _rand(gen, depth, fdim, std=0.05),
          _rand(gen, depth, fdim, dm, std=0.05), _rand(gen, depth, dm, std=0.05),
          1 + _rand(gen, dm, std=0.05), _rand(gen, dm, std=0.05),
          _rand(gen, te + dm, hn, std=0.05), _rand(gen, hn, std=0.05),
          _rand(gen, hn, 1, std=0.05), _rand(gen, 1, std=0.05)]
    k3 = lambda: fed.fused_energy_decoder(*ea, 4, "relu", 8)  # noqa: E731
    k3_plain = lambda: fed._reference(*ea, num_heads=4, activation="relu")  # noqa: E731
    _check("energy_decoder", k3(), k3_plain(), results, k3, k3_plain)

    # K2v: tokens (B, 135, 48), H 480, 6 heads x 80, F 1920, L 6, OUT 48
    n, pdim, h, heads, fdim, depth, out_dim = 135, 48, 480, 6, 1920, 6, 48
    m = b * n
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    tokens = _rand(gen, b, n, pdim)
    pos = _rand(gen, n, h)
    mods = _rand(gen, b, depth, 6, h, std=0.1)
    fmod = _rand(gen, b, 2, h, std=0.1)
    x = _rand(gen, m, h)
    xs = x.clone()
    ws = {"embed": (pdim, h), "qkv": (h, 3 * h), "out": (h, h), "fc1": (h, fdim),
          "fc2": (fdim, h), "final": (h, out_dim)}
    w = {k: _rand(gen, *s, std=0.05) for k, s in ws.items()}
    bias = {k: _rand(gen, s[1], std=0.05) for k, s in ws.items()}
    h_bf = bf(_rand(gen, m, h))
    hid_bf = bf(_rand(gen, m, fdim))
    gate = mods[:, 0, 2]
    gemms = [
        ("embed", tokens.reshape(m, pdim), fdb.EPI_BIAS_POS, dict(pos=pos)),
        ("qkv", h_bf, fdb.EPI_BIAS, {}),
        ("out", h_bf, fdb.EPI_GATED_RESID, dict(gate=gate)),
        ("fc1", h_bf, fdb.EPI_BIAS_GELU, {}),
        ("fc2", hid_bf, fdb.EPI_GATED_RESID, dict(gate=gate)),
        ("final", h_bf, fdb.EPI_BIAS, {}),
    ]
    for key, a, epi, kw in gemms:
        wk = bf(w[key])
        resid = epi == fdb.EPI_GATED_RESID
        ker = lambda: fdb.linear(a, wk, bias[key], epi, out=x if resid else None,  # noqa: E731
                                 n_tok=n, **kw)
        pla = lambda: fdb.linear_plain(a, wk, bias[key], epi, out=x if resid else None,  # noqa: E731
                                       n_tok=n, **kw)
        if resid:  # in place: compare one update of the same starting residual
            x.copy_(xs)
            out = ker().clone()
            x.copy_(xs)
            ref = pla().clone()
        else:
            out, ref = ker(), pla()
        _check("vit_gemm", out, ref, results, ker, pla)

    shift, scl = mods[:, 0, 0], mods[:, 0, 1]
    ker = lambda: fdb.modln(x, shift, scl, n)  # noqa: E731
    pla = lambda: fdb.modln_plain(x, shift, scl, n)  # noqa: E731
    _check("vit_modln", ker(), pla(), results, ker, pla)

    qkv = _rand(gen, b, n, 3 * h)
    ker = lambda: fdb.attention(qkv, heads, 80 ** -0.5)  # noqa: E731
    pla = lambda: fdb.attention_plain(qkv, heads, 80 ** -0.5)  # noqa: E731
    _check("vit_attention", ker(), pla(), results, ker, pla)

    wl = lambda s: _rand(gen, depth, *s, std=0.05)  # noqa: E731
    va = [tokens, pos, mods, fmod, w["embed"], bias["embed"],
          wl((h, 3 * h)), wl((3 * h,)), wl((h, h)), wl((h,)), wl((h, fdim)), wl((fdim,)),
          wl((fdim, h)), wl((h,)), w["final"], bias["final"]]
    ker = lambda: fdb.fused_vit_forward(*va, None, heads, None)  # noqa: E731
    pla = lambda: fdb.vit_forward_reference(*va, None, heads, 80 ** -0.5)  # noqa: E731
    _check("fused_vit_forward", ker(), pla(), results, ker, pla)


def _binning_xml(path: Path):
    """ds2 geometry: 45 layers of 16 alpha x 9 radial bins (6480 voxels)."""
    r_edges = ",".join(str(v) for v in (0, 4, 8, 13, 19, 27, 38, 54, 80, 150))
    layers = [f'    <Layer id="{i}" r_edges="{r_edges}" n_bin_alpha="16"/>' for i in range(45)]
    path.write_text("\n".join(['<Bins>', '  <Particle name="electron">', *layers,
                               '  </Particle>', '</Bins>']))


def _transforms(cfg: dict, data_dir: Path, run_dir: Path):
    resolved = {name: {k: v.replace("${data_dir}", str(data_dir)) if isinstance(v, str) else v
                       for k, v in kw.items()} for name, kw in cfg.items()}
    return build_pipeline(resolved, str(run_dir))


def _with_net_param(cfg: dict, **param):
    return dict(cfg, net=dict(cfg["net"], param=dict(cfg["net"]["param"], **param)))


def _randomize(model, gen, std=0.02):
    """N(0, std) weights everywhere (LayerNorm gains 1 + N(0, std); the
    learnable positional frequencies N(0, 1) as the JAX init draws them)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen, device=p.device)
            if name.endswith("pos_embed_freqs"):
                p.copy_(noise)
            elif ".norm" in name and name.endswith("weight"):
                p.copy_(1 + std * noise)
            else:
                p.copy_(std * noise)


def slice_phase(tmp: Path):
    data_dir, shape_dir, energy_dir = tmp / "data", tmp / "shape_run", tmp / "energy_run"
    for d in (data_dir, shape_dir, energy_dir):
        d.mkdir()
    _binning_xml(data_dir / "binning_dataset_2.xml")
    rng = np.random.default_rng(SEED)
    np.save(shape_dir / "means.npy", np.float32(-9.0))
    np.save(shape_dir / "stds.npy", np.float32(4.0))
    np.save(energy_dir / "means_u.npy", rng.normal(0.0, 0.3, 45).astype(np.float32))
    np.save(energy_dir / "stds_u.npy", rng.uniform(0.8, 1.5, 45).astype(np.float32))
    shape_tf = _transforms(DS2_SHAPE_TRANSFORMS, data_dir, shape_dir)
    energy_tf = _transforms(DS2_ENERGY_TRANSFORMS, data_dir, energy_dir)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shape_model = instantiate(DS2_SHAPE_MODEL).cuda().eval()
    energy_model = instantiate(DS2_ENERGY_MODEL).cuda().eval()
    _randomize(shape_model, gen)
    _randomize(energy_model, gen)
    evals = shape_model.net_evals_per_sample()
    print(f"  shape model {shape_model.param_count()} params, energy model "
          f"{energy_model.param_count()} params, {evals} net evals per model per request",
          flush=True)
    generator = Generator(shape_model, energy_model, energy_tf, shape_tf, batch=BATCH)

    for c in COUNTERS.values():
        c.reset()
    times, showers = [], None
    for i in range(REQUESTS):
        e_inc = 10 ** np.random.default_rng(SEED + 1 + i).uniform(3, 6, BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        showers = generator.sample_showers(e_inc, seed=SEED + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = []
        if showers.shape != (BATCH, 6480):
            bad.append(f"shape {showers.shape}")
        if not np.isfinite(showers).all():
            bad.append("non-finite values")
        if (showers < 0).any():
            bad.append(f"negative values (min {showers.min()})")
        if bad:
            raise PhaseError(f"request {i}: " + ", ".join(bad))
        print(f"  request {i}: {BATCH} showers in {times[-1]:.3f} s, total energy "
              f"{showers.sum(1).mean():.1f} MeV mean", flush=True)
    launches = {k: c.launches for k, c in COUNTERS.items()}
    per_eval = {"energy_decoder": 1, "vit_gemm": 2 + 4 * 6, "vit_modln": 2 * 6 + 1,
                "vit_attention": 6}
    for k, per in per_eval.items():
        want = REQUESTS * evals * per
        if launches[k] != want:
            raise PhaseError(f"{k}: {launches[k]} launches on the main path, expected {want} "
                             f"({per} per net eval, {evals} evals, {REQUESTS} requests)")
    print(f"  launches on the main path: {launches}", flush=True)

    # the same generator on the composed plain-PyTorch nets, same noise
    plain_shape = instantiate(_with_net_param(DS2_SHAPE_MODEL, fused_block=False)).cuda().eval()
    plain_energy = instantiate(_with_net_param(DS2_ENERGY_MODEL, fused_block=False)).cuda().eval()
    plain_shape.load_state_dict(shape_model.state_dict())
    plain_energy.load_state_dict(energy_model.state_dict())
    nb = REFERENCE_BATCH
    noise = (torch.randn(nb, 45, generator=gen, device="cuda"),
             torch.randn(nb, 135, 48, generator=gen, device="cuda"))
    e_inc = 10 ** np.random.default_rng(SEED).uniform(3, 6, nb)
    kern = Generator(shape_model, energy_model, energy_tf, shape_tf, batch=nb)
    plain = Generator(plain_shape, plain_energy, energy_tf, shape_tf, batch=nb)
    cond = kern.condition(e_inc)
    basis_k, full_k = kern.generate(cond, noise=noise)
    basis_p, full_p = plain.generate(cond, noise=noise)
    u_err = (full_k - full_p).abs().max().item()
    s_err, s_scale = _rel_err(basis_k, basis_p)
    mev_k = kern.sample_showers(e_inc, noise=noise)
    mev_p = plain.sample_showers(e_inc, noise=noise)
    layer_k, layer_p = (m.reshape(nb, 45, -1).sum(-1) for m in (mev_k, mev_p))
    layer_rel = float(np.abs(layer_k - layer_p).max() / max(1e-30, np.abs(layer_p).max()))
    # energy stage: f32 kernel vs f32 composed -> u and layer energies agree
    # to ~1e-4; shape stage: bf16 multiplicands over 80 evals -> 5e-2 of scale
    print(f"  reference (batch {nb}, composed plain nets, same noise): u max_abs_err "
          f"{u_err:.3e}, shower max_abs_err {s_err:.3e} (scale {s_scale:.3g}), layer-energy "
          f"max rel err {layer_rel:.3e}", flush=True)
    if not (u_err <= 1e-3 and s_err <= 5e-2 * s_scale and layer_rel <= 1e-3):
        raise PhaseError("kernel generator disagrees with the composed plain generator")
    return launches, times, generator


def profile_phase(generator, card, top=15):
    """One more request of BATCH showers, measured by layer: the energy
    stage (energy ODE), the chain (+ u map + shape ODE) and the whole
    request (+ host transforms) on the host clock; then the request under
    torch.profiler: device time per kernel and the device's idle share of
    the request's wall time (one stream, so idle = 1 - kernel time / wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    e_inc = 10 ** np.random.default_rng(SEED + REQUESTS + 1).uniform(3, 6, BATCH)
    cond = torch.as_tensor(generator.condition(e_inc), device="cuda")

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    energy_s = clock(lambda: generator.energy_model.sample_batch(cond, generator=gen))
    chain_s = clock(lambda: generator.generate(cond, seed=SEED))
    request_s = clock(lambda: generator.sample_showers(e_inc, seed=SEED))
    print(f"  host clock ({card}): request {request_s:.4f} s = energy stage {energy_s:.4f} s "
          f"+ u map and shape stage {chain_s - energy_s:.4f} s + host transforms "
          f"{request_s - chain_s:.4f} s", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = clock(lambda: generator.sample_showers(e_inc, seed=SEED))
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages() if e.device_type != DeviceType.CPU),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    wall_ms = wall_s * 1e3
    print(f"  torch.profiler ({card}): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}", flush=True)
    for ms, count, key in rows[:top]:
        print(f"  {ms:10.2f} ms {count:6d}x  {key[:100]}", flush=True)
    rest = rows[top:]
    print(f"  {sum(r[0] for r in rest):10.2f} ms {sum(r[1] for r in rest):6d}x  "
          f"({len(rest)} other device entries)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    t0 = time.perf_counter()
    compiled = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({compiled or 'all current'})", flush=True)

    results: dict = {}
    print("kernels vs plain versions (ds2 shapes, batch 256):", flush=True)
    kernel_phases(results)
    failed = [k for k, r in results.items() if not r["ok"]]
    if failed:
        raise PhaseError(f"kernels disagree with their plain versions: {failed}")
    for k, r in results.items():
        print(f"  {k}: {r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms ({card})", flush=True)

    print("slice: ds2 two-stage generator at full width", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        launches, times, generator = slice_phase(Path(tmp))
        print(f"slice: {BATCH * len(times) / sum(times):.2f} showers/s over all {len(times)} "
              f"requests, {BATCH * (len(times) - 1) / sum(times[1:]):.2f} steady (first "
              f"request excluded); batch {BATCH}, requests {[round(t, 4) for t in times]} s; "
              f"on {card}", flush=True)
        print("profile: one more request, by layer", flush=True)
        profile_phase(generator, card)

    summary = [{"name": k, "route": "cuda", "source": REPLACES[k][0], "replaces": REPLACES[k][1],
                "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
                "tolerance": TOL[k], "ok": results[k]["ok"], "ms": results[k]["ms"],
                "plain_ms": results[k]["plain_ms"]} for k in COUNTERS]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
