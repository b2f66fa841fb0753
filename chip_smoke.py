#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the ds2 two-stage shower
generator and the ds2 training slice at full width, through the
hand-written CUDA kernels.

    python3 chip_smoke.py        # from the repository root, on a machine with a GPU

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: requires CUDA (no CPU path); prints the card's name and power limit;
2. build: compiles every kernel of the port from ``vit4hep_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and prints the seconds;
3. kernels: calls each kernel's wrapper at the shapes of its main path and
   holds it against its plain PyTorch version on the same inputs, with the
   tolerance stated in ``TOL``; times the kernel, the plain version and,
   where one PyTorch call computes the same function, that call (CUDA
   events, median). The serving kernels (K3, K2v) run at the ds2 sampling
   shapes (batch 256); K1 (``fused_qkv_attention``, forward and backward)
   at the ds2 training shape (qkv (64, 135, 1440), 6 heads) and at ds3's
   token count (16, 450, 1440);
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
   device's idle share);
6. train: the ds2 shape model at full width (hidden 480, depth 6, 6 heads x
   80, 135 tokens x 48, batch 64, AdamW lr 1e-4 wd 0.1, cosine,
   clip_grad_norm 1000) through the port's ``CaloChallenge`` experiment and
   its ``train()``: TRAIN_STEPS steps validating every VALIDATE_EVERY, then
   ``model_run0.pt``. The card's machine has no h5py and no dataset, so a
   smoke-local subclass hands in synthetic MeV showers on the ds2 geometry
   (``load_showers``); they go through the ds2 transform chain, which fits
   ``means.npy``/``stds.npy`` into the run dir. K1's counters are set to 0
   just before and read just after: the forward must have run 6 x (train
   steps + validation batches) times and each backward kernel 6 x train
   steps. Every loss and grad norm must be finite and no step skipped. A
   warm start from ``model_run0.pt`` must restore the saved state exactly
   and train on as run 1;
7. train parity: from one initial state, with the same batches and the same
   (t, x_0), TRAIN_PARITY_STEPS steps with ``attn_impl: auto`` (K1) and with
   ``attn_impl: xla`` (plain) must agree (``TRAIN_TOL``);
8. energy: a few steps of the ds2 energy experiment at full width (batch
   256; no kernel on its path), which fits ``means_u.npy``/``stds_u.npy``;
9. train profile: one train step under ``torch.profiler``: device ms of K1's
   forward and backward kernels, the cuBLAS products and the rest, and the
   step's idle share.

The line before the last is the ``{"kernels": [...]}`` summary; the last line
is ``{"ok": true, "device": {...}}``. Needs no network, no PyYAML, no h5py
and nothing of JAX or of the JAX package: the ds2 configs are written out
below (tests/test_torch_chain.py holds them equal to the YAML files).
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
import torch.nn.functional as F

from vit4hep_tpu_torch.data.calochallenge.transforms import build_pipeline
from vit4hep_tpu_torch.experiments import train_state as ts
from vit4hep_tpu_torch.experiments.calochallenge import CaloChallenge
from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops import fused_dit_block as fdb
from vit4hep_tpu_torch.ops import fused_energy_decoder as fed
from vit4hep_tpu_torch.ops import fused_qkv_attention as fqa
from vit4hep_tpu_torch.utils.config import Config, instantiate
from vit4hep_tpu_torch.utils.serving import Generator

SEED = 0
BATCH = 256
REQUESTS = 3
REFERENCE_BATCH = 8
TRAIN_STEPS = 30
VALIDATE_EVERY = 10
WARM_START_STEPS = 5
TRAIN_PARITY_STEPS = 3
ENERGY_STEPS = 10
N_EVENTS = 2560  # synthetic showers: 39 training batches of 64, 25 validation events

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

# configs/training/default.yaml with configs/training/cfm/shape.yaml and
# cfm/energy.yaml on top (iterations are cut to the smoke's step counts)
DS2_TRAINING = {
    "iterations": 50000, "batchsize": 128, "batchsize_sample": 256, "optimizer": "AdamW",
    "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.1, "lr": 1e-4,
    "scheduler": "CosineAnnealingLR", "scheduler_scale": 1, "cosanneal_eta_min": 0,
    "onecycle_max_lr": 10, "onecycle_pct_start": 0.2, "es_patience": 1000,
    "es_load_best_model": False, "log_every_n_steps": 500, "validate_every_n_steps": 4000,
    "validate_every_n_epochs_min": None, "clip_grad_norm": 1000, "clip_grad_value": None,
    "max_grad_norm": None, "ema_decay": 0.9999,
}
DS2_SHAPE_TRAINING = dict(DS2_TRAINING, iterations=800000, batchsize=64)
DS2_ENERGY_TRAINING = dict(DS2_TRAINING, iterations=250000, batchsize=256)

# tolerances of the kernel phases, relative to max(1, max |plain|):
# energy_decoder and K1 compute in f32 like their plain versions (summation
# order only; K1's online softmax rescales partial sums); the ViT kernels
# round their outputs (modln, GELU hidden, attention context) to bf16, whose
# ulp is 2^-8 = 3.9e-3 relative, so one rounding flip is within 8e-3; the
# whole forward takes bf16 multiplicands through 6 blocks against an f32
# plain version (the TPU kernel's precision contract).
TOL = {"energy_decoder": 1e-3, "vit_gemm": 8e-3, "vit_modln": 8e-3,
       "vit_attention": 8e-3, "fused_vit_forward": 2e-2, "qkv_attn_fwd": 1e-4,
       "qkv_attn_bwd_delta": 1e-4, "qkv_attn_bwd_dkv": 1e-4, "qkv_attn_bwd_dq": 1e-4}
# train parity, K1 against the plain attention from one state: per-step
# loss relative 1e-4 (f32 both, summation order only); each parameter within
# half of one step's lr (5e-5 at lr 1e-4) -- Adam divides every gradient
# entry by its own RMS, so the rounding noise of an entry whose true gradient
# is zero (the key biases: softmax ignores them) can move it by a fraction of
# lr -- and the whole update vector within 1e-2 relative, which a wrong
# gradient would miss by O(1)
TRAIN_TOL = {"loss": 1e-4, "param_abs": 5e-5, "update_rel": 1e-2}
K1 = "vit4hep_tpu_torch/csrc/qkv_attention.cu"
K2V = "vit4hep_tpu_torch/csrc/vit_forward.cu"
REPLACES = {
    "energy_decoder": ("vit4hep_tpu_torch/csrc/energy_decoder.cu",
                       "vit4hep_tpu/ops/fused_energy_decoder.py:124"),
    "vit_gemm": (K2V, "vit4hep_tpu/ops/fused_dit_block.py:1315"),
    "vit_modln": (K2V, "vit4hep_tpu/ops/fused_dit_block.py:1315"),
    "vit_attention": (K2V, "vit4hep_tpu/ops/fused_dit_block.py:1315"),
    "qkv_attn_fwd": (K1, "vit4hep_tpu/ops/fused_qkv_attention.py:58"),
    "qkv_attn_bwd_delta": (K1, "vit4hep_tpu/ops/fused_qkv_attention.py:252"),
    "qkv_attn_bwd_dkv": (K1, "vit4hep_tpu/ops/fused_qkv_attention.py:252"),
    "qkv_attn_bwd_dq": (K1, "vit4hep_tpu/ops/fused_qkv_attention.py:252"),
}
SERVING = {"energy_decoder": fed.ENERGY_DECODER, "vit_gemm": fdb.GEMM,
           "vit_modln": fdb.MODLN, "vit_attention": fdb.ATTENTION}
TRAINING = {"qkv_attn_fwd": fqa.FWD, "qkv_attn_bwd_delta": fqa.BWD_DELTA,
            "qkv_attn_bwd_dkv": fqa.BWD_DKV, "qkv_attn_bwd_dq": fqa.BWD_DQ}

# NVIDIA H100 SXM peaks (data sheet, dense, at 700 W): HBM bytes/s, f32 on
# the CUDA cores, bf16 on the tensor cores. The attention products (K1, K2v)
# are bounded at the bf16 rate: the TPU kernels they replace take bf16
# multiplicands with f32 accumulation, whatever arithmetic a port uses
HBM_BYTES_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


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


def _bound(nbytes, flops, rate):
    """(least ms for the work, what bounds it): the larger of the bytes over
    the HBM rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, out, ref, results, kernel_fn, plain_fn, bound, library_fn=None):
    """Hold a kernel's output against its plain version and time both (and
    the library call); repeated calls under one name add up (vit_gemm's six
    product shapes)."""
    torch.cuda.synchronize()
    err, scale = _rel_err(out, ref)
    ok = math.isfinite(err) and err <= TOL[name] * scale
    prev = results.get(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ok": True,
                              "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                              "library_ms": 0.0 if library_fn else None})
    b_ms, _ = bound
    res = {"max_abs_err": max(prev["max_abs_err"], err), "ms": prev["ms"] + _time_ms(kernel_fn),
           "plain_ms": prev["plain_ms"] + _time_ms(plain_fn),
           "ok": prev["ok"] and ok, "bound_ms": prev["bound_ms"] + b_ms,
           "bytes_ms": prev["bytes_ms"] + (b_ms if bound[1] == "bytes" else 0.0),
           "ops_ms": prev["ops_ms"] + (b_ms if bound[1] == "operations" else 0.0),
           "library_ms": None if library_fn is None else prev["library_ms"] + _time_ms(library_fn)}
    res["bound_by"] = "bytes" if res["bytes_ms"] >= res["ops_ms"] else "operations"
    results[name] = res
    print(f"  {name}: max_abs_err {err:.3e} (bound {TOL[name]:g} x {scale:.3g}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)


def _rand(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * std


def serving_kernel_phases(results):
    """K3 and K2v against their plain versions at the ds2 sampling shapes,
    batch BATCH. ms/plain_ms/bound_ms of vit_gemm add up one call at each
    of the six product shapes of a forward (embed, qkv, out-proj, fc1, fc2,
    final)."""
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
    k3_flops = b * (depth * (2 * n * dm * 3 * dm + 4 * n * n * dm + 2 * n * dm * dm
                             + 4 * n * dm * fdim) + 2 * n * (te + dm) * hn + 2 * n * hn)
    k3_bytes = 4 * (sum(a.numel() for a in ea) + b * n)
    _check("energy_decoder", k3(), k3_plain(), results, k3, k3_plain,
           _bound(k3_bytes, k3_flops, F32_FLOPS))

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
        a_bf = bf(a)
        resid = epi == fdb.EPI_GATED_RESID
        ker = lambda: fdb.linear(a, wk, bias[key], epi, out=x if resid else None,  # noqa: E731
                                 n_tok=n, **kw)
        pla = lambda: fdb.linear_plain(a, wk, bias[key], epi, out=x if resid else None,  # noqa: E731
                                       n_tok=n, **kw)
        lib = lambda: torch.matmul(a_bf, wk)  # noqa: E731  (the product only)
        kk, nn_ = wk.shape
        out_bytes = 2 if epi == fdb.EPI_BIAS_GELU else (8 if resid else 4)  # resid: read + write
        g_bytes = (a.numel() * a.element_size() + wk.numel() * 2 + nn_ * 4 + m * nn_ * out_bytes
                   + (pos.numel() * 4 if epi == fdb.EPI_BIAS_POS else 0)
                   + (b * nn_ * 4 if resid else 0))
        bound = _bound(g_bytes, 2 * m * nn_ * kk, BF16_FLOPS)
        if resid:  # in place: compare one update of the same starting residual
            x.copy_(xs)
            out = ker().clone()
            x.copy_(xs)
            ref = pla().clone()
        else:
            out, ref = ker(), pla()
        _check("vit_gemm", out, ref, results, ker, pla, bound, lib)

    shift, scl = mods[:, 0, 0], mods[:, 0, 1]
    ker = lambda: fdb.modln(x, shift, scl, n)  # noqa: E731
    pla = lambda: fdb.modln_plain(x, shift, scl, n)  # noqa: E731
    _check("vit_modln", ker(), pla(), results, ker, pla,
           _bound(m * h * 4 + 2 * b * h * 4 + m * h * 2, 8 * m * h, F32_FLOPS))

    qkv = _rand(gen, b, n, 3 * h)
    q, k, v = (t.contiguous() for t in qkv.reshape(b, n, 3, heads, 80).permute(2, 0, 3, 1, 4))
    ker = lambda: fdb.attention(qkv, heads, 80 ** -0.5)  # noqa: E731
    pla = lambda: fdb.attention_plain(qkv, heads, 80 ** -0.5)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    _check("vit_attention", ker(), pla(), results, ker, pla,
           _bound(qkv.numel() * 4 + b * n * h * 2, 4 * b * heads * n * n * 80, BF16_FLOPS), lib)

    wl = lambda s: _rand(gen, depth, *s, std=0.05)  # noqa: E731
    va = [tokens, pos, mods, fmod, w["embed"], bias["embed"],
          wl((h, 3 * h)), wl((3 * h,)), wl((h, h)), wl((h,)), wl((h, fdim)), wl((fdim,)),
          wl((fdim, h)), wl((h,)), w["final"], bias["final"]]
    ker = lambda: fdb.fused_vit_forward(*va, None, heads, None)  # noqa: E731
    pla = lambda: fdb.vit_forward_reference(*va, None, heads, 80 ** -0.5)  # noqa: E731
    _check("fused_vit_forward", ker(), pla(), results, ker, pla, (0.0, "operations"))


def k1_kernel_phase(results, b, n, heads=6, d=80):
    """K1's forward and backward kernels against their plain versions at
    qkv (b, n, 3 * heads * d) f32; prints the kernel, plain and SDPA times of
    the forward and of forward + backward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    qkv = _rand(gen, b, n, 3 * heads * d)
    g = _rand(gen, b, n, heads * d)
    scale = d ** -0.5
    hd = heads * d
    out, lse = fqa.attention_fwd_kernel(qkv, heads, scale)
    out_p, lse_p = fqa.attention_fwd_plain(qkv, heads, scale)
    q, k, v = (t.contiguous() for t in qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    fwd_flops = 4 * b * heads * n * n * d
    _check("qkv_attn_fwd", torch.cat([out.flatten(), lse.flatten()]),
           torch.cat([out_p.flatten(), lse_p.flatten()]), results,
           lambda: fqa.attention_fwd_kernel(qkv, heads, scale),
           lambda: fqa.attention_fwd_plain(qkv, heads, scale),
           _bound(4 * (qkv.numel() + out.numel() + lse.numel()), fwd_flops, BF16_FLOPS),
           lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))

    delta = fqa.attention_bwd_delta_kernel(g, out, heads)
    _check("qkv_attn_bwd_delta", delta, fqa.delta_plain(g, out, heads), results,
           lambda: fqa.attention_bwd_delta_kernel(g, out, heads),
           lambda: fqa.delta_plain(g, out, heads),
           _bound(4 * (2 * g.numel() + delta.numel()), 2 * g.numel(), F32_FLOPS))
    want = fqa.attention_bwd_plain(qkv, g, lse, heads, scale)
    dqkv = torch.zeros_like(qkv)
    fqa.attention_bwd_dkv_kernel(qkv, g, lse, delta, heads, scale, dqkv)
    fqa.attention_bwd_dq_kernel(qkv, g, lse, delta, heads, scale, dqkv)
    small = 4 * (qkv.numel() + g.numel() + 2 * lse.numel())  # what both kernels read
    for name, cols, flops, kernel, writes in (
            ("qkv_attn_bwd_dkv", slice(hd, 3 * hd), 8 * b * heads * n * n * d,
             fqa.attention_bwd_dkv_kernel, 2 * b * n * hd),
            ("qkv_attn_bwd_dq", slice(0, hd), 6 * b * heads * n * n * d,
             fqa.attention_bwd_dq_kernel, b * n * hd)):
        _check(name, dqkv[..., cols], want[..., cols], results,
               lambda kernel=kernel: kernel(qkv, g, lse, delta, heads, scale, dqkv),
               lambda: fqa.attention_bwd_plain(qkv, g, lse, heads, scale),
               _bound(small + 4 * writes, flops, BF16_FLOPS))
    # the products' own ceiling in this kernel's f32 CUDA-core arithmetic
    simt = {"fwd": fwd_flops, "dkv": 8 * b * heads * n * n * d, "dq": 6 * b * heads * n * n * d}
    print("  f32 CUDA-core ceiling of K1's products: " + ", ".join(
        f"{k} {f / F32_FLOPS * 1e3:.4f} ms" for k, f in simt.items()), flush=True)

    # forward + backward of the same upstream gradient g: K1 through its
    # autograd.Function, the plain forward + plain backward, SDPA through autograd
    xk = qkv.clone().requires_grad_()
    xs = q.clone().requires_grad_(), k.clone().requires_grad_(), v.clone().requires_grad_()
    g_heads = g.reshape(b, n, heads, d).permute(0, 2, 1, 3).contiguous()

    def k1_run():
        xk.grad = None
        fqa.fused_qkv_attention(xk, heads).backward(g)

    def plain_run():
        _, lse_run = fqa.attention_fwd_plain(qkv, heads, scale)
        fqa.attention_bwd_plain(qkv, g, lse_run, heads, scale)

    def sdpa_run():
        for t in xs:
            t.grad = None
        F.scaled_dot_product_attention(*xs, scale=scale).backward(g_heads)

    return {"K1": _time_ms(k1_run), "plain": _time_ms(plain_run), "sdpa": _time_ms(sdpa_run)}


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

    for c in SERVING.values():
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
    launches = {k: c.launches for k, c in SERVING.items()}
    per_eval = {"energy_decoder": 1, "vit_gemm": 2 + 4 * 6, "vit_modln": 2 * 6 + 1,
                "vit_attention": 6}
    for k, per in per_eval.items():
        want = REQUESTS * evals * per
        if launches[k] != want:
            raise PhaseError(f"{k}: {launches[k]} launches on the main path, expected {want} "
                             f"({per} per net eval, {evals} evals, {REQUESTS} requests)")
    print(f"  launches on the main path: {launches}", flush=True)

    # the same generator on the composed plain-PyTorch nets (plain attention
    # too: `auto` would launch K1 at 135 tokens), same noise
    plain_shape = instantiate(_with_net_param(DS2_SHAPE_MODEL, fused_block=False,
                                              attn_impl="xla")).cuda().eval()
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
    k1_before = fqa.FWD.launches
    basis_k, full_k = kern.generate(cond, noise=noise)
    basis_p, full_p = plain.generate(cond, noise=noise)
    if fqa.FWD.launches != k1_before:
        raise PhaseError("the plain reference generator launched K1")
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


def _device_rows(prof):
    """(ms, count, name) of device-side events only (kernels, copies): a CPU
    op's device time repeats that of the kernels it launched."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages() if e.device_type != DeviceType.CPU),
                  reverse=True)


def _clock(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_phase(generator, card, top=15):
    """One more request of BATCH showers, measured by layer: the energy
    stage (energy ODE), the chain (+ u map + shape ODE) and the whole
    request (+ host transforms) on the host clock; then the request under
    torch.profiler: device time per kernel and the device's idle share of
    the request's wall time (one stream, so idle = 1 - kernel time / wall)."""
    from torch.profiler import ProfilerActivity, profile

    e_inc = 10 ** np.random.default_rng(SEED + REQUESTS + 1).uniform(3, 6, BATCH)
    cond = torch.as_tensor(generator.condition(e_inc), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    energy_s = _clock(lambda: generator.energy_model.sample_batch(cond, generator=gen))
    chain_s = _clock(lambda: generator.generate(cond, seed=SEED))
    request_s = _clock(lambda: generator.sample_showers(e_inc, seed=SEED))
    print(f"  host clock ({card}): request {request_s:.4f} s = energy stage {energy_s:.4f} s "
          f"+ u map and shape stage {chain_s - energy_s:.4f} s + host transforms "
          f"{request_s - chain_s:.4f} s", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = _clock(lambda: generator.sample_showers(e_inc, seed=SEED))
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    wall_ms = wall_s * 1e3
    print(f"  torch.profiler ({card}): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}", flush=True)
    for ms, count, key in rows[:top]:
        print(f"  {ms:10.2f} ms {count:6d}x  {key[:100]}", flush=True)
    rest = rows[top:]
    print(f"  {sum(r[0] for r in rest):10.2f} ms {sum(r[1] for r in rest):6d}x  "
          f"({len(rest)} other device entries)", flush=True)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _synthetic_showers(n_events, seed):
    """(E_inc (N, 1), showers (N, 6480) in MeV, layer boundaries) on the ds2
    geometry: sparse exponential voxel energies summing to 0.5-0.9 of E_inc,
    with a longitudinal profile peaking in the first third of the layers."""
    rng = np.random.default_rng(seed)
    e_inc = (10 ** rng.uniform(3, 6, (n_events, 1))).astype(np.float32)
    profile = np.exp(-0.5 * ((np.arange(45) - 12) / 8.0) ** 2)
    vox = rng.exponential(1.0, (n_events, 45, 144)) * (rng.random((n_events, 45, 144)) > 0.5)
    vox *= profile[None, :, None]
    vox /= vox.sum((1, 2), keepdims=True)
    showers = (vox.reshape(n_events, 6480) * e_inc * rng.uniform(0.5, 0.9, (n_events, 1)))
    return e_inc, showers.astype(np.float32), np.arange(0, 6481, 144)


class SyntheticCaloChallenge(CaloChallenge):
    """The port's CaloChallenge experiment with synthetic MeV showers on the
    ds2 geometry in place of the training file (the card's machine has no
    h5py and no dataset)."""

    def load_showers(self):
        return _synthetic_showers(N_EVENTS, SEED)


def _experiment_config(tmp: Path, model, transforms, training, model_type, train_val_frac):
    """The composed calochallenge_ds2(_energy) config with the run dir under
    ``tmp`` and the binning XML in ``tmp/data``."""
    return Config({
        "exp_name": f"smoke_{model_type}", "exp_type": "calochallenge", "run_name": "run",
        "base_dir": str(tmp), "data_dir": str(tmp / "data"), "seed": SEED, "debug": False,
        "warm_start_idx": None, "save": True, "use_mlflow": True, "save_source": False,
        "ema": False, "train": True, "evaluate": False, "plot": False,
        "plotting": {"loss": False}, "dtype": "float32", "model_type": model_type,
        "model": model, "training": training,
        "data": {"training_file": "${data_dir}/dataset_2_1.hdf5",
                 "test_file": "${data_dir}/dataset_2_2.hdf5", "particle_type": "electron",
                 "xml_filename": "${data_dir}/binning_dataset_2.xml",
                 "train_val_frac": train_val_frac, "transforms": transforms},
    })


def _check_training(exp, what):
    losses = exp.train_loss + exp.val_loss + exp.grad_norm_train + exp.grad_norm_net
    if not all(math.isfinite(v) for v in losses):
        raise PhaseError(f"{what}: non-finite loss or grad norm")
    if any(exp.skipped):
        raise PhaseError(f"{what}: {sum(exp.skipped)} steps skipped")


def train_phase(tmp: Path, card):
    """The ds2 shape model trained at full width through the experiment;
    returns (K1 launches, the experiment)."""
    training = dict(DS2_SHAPE_TRAINING, iterations=TRAIN_STEPS,
                    validate_every_n_steps=VALIDATE_EVERY)
    cfg = _experiment_config(tmp, DS2_SHAPE_MODEL, DS2_SHAPE_TRANSFORMS, training, "shape",
                             [0.99, 0.01])
    exp = SyntheticCaloChallenge(cfg, device="cuda")
    for c in TRAINING.values():
        c.reset()
    exp()
    launches = {k: c.launches for k, c in TRAINING.items()}
    _check_training(exp, "train")
    steps = len(exp.train_loss)
    val_batches = len(exp.val_loss) * exp._val_iterator.batches_per_epoch
    want = {"qkv_attn_fwd": 6 * (steps + val_batches), "qkv_attn_bwd_delta": 6 * steps,
            "qkv_attn_bwd_dkv": 6 * steps, "qkv_attn_bwd_dq": 6 * steps}
    if steps != TRAIN_STEPS or launches != want:
        raise PhaseError(f"train: {steps} steps, K1 launches {launches}, expected {want} "
                         f"(6 blocks x {steps} steps + {val_batches} validation batches)")
    run = Path(exp.cfg.run_dir)
    for f in ("models/model_run0.pt", "means.npy", "stds.npy", "config.yaml"):
        if not (run / f).exists():
            raise PhaseError(f"train: {f} missing from the run dir")
    steady = exp.step_times[2:]
    batch = int(exp.cfg.training.batchsize)
    print(f"  {steps} steps, {len(exp.val_loss)} validations ({val_batches} batches): loss "
          f"{exp.train_loss[0]:.4f} -> {exp.train_loss[-1]:.4f}, val {exp.val_loss}", flush=True)
    print(f"  K1 launches on the main path: {launches}", flush=True)
    print(f"train: {steps / exp.train_seconds:.3f} steps/s = "
          f"{batch * steps / exp.train_seconds:.1f} showers/s trained over the whole train() "
          f"loop ({steps} steps, batch copies and {len(exp.val_loss)} validations included); "
          f"step interior only (train step + its host sync): {len(steady) / sum(steady):.3f} "
          f"steps/s steady (steps 3-{steps}), {steps / sum(exp.step_times):.3f} over all "
          f"{steps}; batch {batch}; on {card}", flush=True)

    # warm start: the restored state equals the saved one, and run 1 trains on
    saved = torch.load(run / "models" / "model_run0.pt", map_location="cpu", weights_only=True)
    cfg1 = Config(exp.cfg.to_container(resolve=False))
    cfg1.train = False
    warm = SyntheticCaloChallenge(cfg1, device="cuda")
    warm()
    state = warm.state
    same = (warm.cfg.run_idx == 1 and state.step == saved["step"] == TRAIN_STEPS
            and state.ema_updates == saved["ema_updates"] and state.lr_scale == saved["lr_scale"]
            and all(torch.equal(v.cpu(), saved["model"][k])
                    for k, v in warm.model.state_dict().items())
            and all(torch.equal(m[key].cpu(), s[key])
                    for m, s in zip(state.optimizer.state_dict()["state"].values(),
                                    saved["optimizer"]["state"].values())
                    for key in ("exp_avg", "exp_avg_sq"))
            and state.schedule.last_epoch == saved["schedule"]["last_epoch"])
    if not same:
        raise PhaseError("warm start: the restored state differs from model_run0.pt")
    cfg2 = Config(exp.cfg.to_container(resolve=False))
    cfg2.training.iterations = WARM_START_STEPS
    cfg2.training.validate_every_n_steps = WARM_START_STEPS
    warm = SyntheticCaloChallenge(cfg2, device="cuda")
    warm()
    _check_training(warm, "warm start")
    if warm.state.step != TRAIN_STEPS + WARM_START_STEPS or \
            not (run / "models" / "model_run1.pt").exists():
        raise PhaseError(f"warm start: step {warm.state.step}, expected "
                         f"{TRAIN_STEPS + WARM_START_STEPS}, and model_run1.pt")
    print(f"  warm start: restored step {TRAIN_STEPS} exactly (model, Adam moments, schedule, "
          f"counters); run 1 trained {WARM_START_STEPS} steps, loss {warm.train_loss}", flush=True)
    return launches, exp


def train_parity_phase(exp):
    """TRAIN_PARITY_STEPS steps from one state with K1 (attn_impl auto) and
    with the plain attention (xla), on the same batches and (t, x_0)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    models, states, steps = {}, {}, {}
    init = None
    for impl in ("auto", "xla"):
        torch.manual_seed(SEED)
        model = instantiate(_with_net_param(DS2_SHAPE_MODEL, attn_impl=impl)).cuda()
        if init is None:
            _randomize(model, gen)
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        models[impl] = model
        states[impl] = ts.create_train_state(model, Config(DS2_SHAPE_TRAINING), use_ema=False)
        steps[impl] = ts.make_train_step(
            lambda x, c, t, x_0, model=model: model.batch_loss(x, c, t=t, x_0=x_0),
            clip_grad_norm=DS2_SHAPE_TRAINING["clip_grad_norm"])
    layers, energy = exp.train_dataset.layers, exp.train_dataset.energy
    worst = {"loss": 0.0}
    counts = fqa.FWD.launches
    for i in range(TRAIN_PARITY_STEPS):
        sl = slice(64 * i, 64 * (i + 1))
        x = torch.as_tensor(layers[sl], device="cuda")
        c = torch.as_tensor(energy[sl], device="cuda")
        t = torch.rand((64, 1, 1, 1, 1), generator=gen, device="cuda")
        x_0 = torch.randn(x.shape, generator=gen, device="cuda")
        m = {impl: steps[impl](states[impl], (x, c, t, x_0)) for impl in steps}
        rel = abs(float(m["auto"]["loss"]) - float(m["xla"]["loss"])) / abs(float(m["xla"]["loss"]))
        worst["loss"] = max(worst["loss"], rel)
    if fqa.FWD.launches - counts != 6 * TRAIN_PARITY_STEPS:
        raise PhaseError("train parity: the auto model did not run K1 on every block")
    pk, pp = (dict(models[i].named_parameters()) for i in ("auto", "xla"))
    worst["param_abs"] = max((pk[n] - pp[n]).abs().max().item() for n in pp)
    du = torch.cat([(pk[n] - init[n]).flatten() for n in pp])
    dp = torch.cat([(pp[n] - init[n]).flatten() for n in pp])
    worst["update_rel"] = ((du - dp).norm() / dp.norm()).item()
    ok = all(worst[k] <= TRAIN_TOL[k] for k in TRAIN_TOL)
    print(f"  {TRAIN_PARITY_STEPS} steps, K1 vs plain attention: loss rel {worst['loss']:.3e}, "
          f"param max abs {worst['param_abs']:.3e}, update rel {worst['update_rel']:.3e} "
          f"(bounds {TRAIN_TOL}) {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise PhaseError("train parity: K1 training disagrees with the plain attention")
    return worst


def energy_phase(tmp: Path):
    training = dict(DS2_ENERGY_TRAINING, iterations=ENERGY_STEPS,
                    validate_every_n_steps=ENERGY_STEPS // 2)
    cfg = _experiment_config(tmp, DS2_ENERGY_MODEL, DS2_ENERGY_TRANSFORMS, training, "energy",
                             [0.9999, 0.0001])
    exp = SyntheticCaloChallenge(cfg, device="cuda")
    exp()
    _check_training(exp, "energy")
    run = Path(exp.cfg.run_dir)
    if not ((run / "means_u.npy").exists() and (run / "stds_u.npy").exists()):
        raise PhaseError("energy: means_u.npy / stds_u.npy were not written")
    steady = exp.step_times[2:]
    print(f"  {len(exp.train_loss)} steps of batch 256: loss {exp.train_loss[0]:.4f} -> "
          f"{exp.train_loss[-1]:.4f}, {len(steady) / sum(steady):.2f} steps/s steady", flush=True)


def train_profile_phase(exp, card, top=12):
    """One train step of the trained experiment under torch.profiler:
    device ms of K1's kernels, the cuBLAS products and the rest, and the
    step's idle share."""
    from torch.profiler import ProfilerActivity, profile

    batch = exp._batch(next(exp.train_iterator))
    exp._train_step(exp.state, batch)  # warm
    step_s = _clock(lambda: exp._train_step(exp.state, batch))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = _clock(lambda: exp._train_step(exp.state, batch))
    rows = _device_rows(prof)
    groups = {"K1 forward": 0.0, "K1 backward": 0.0, "cuBLAS products": 0.0, "rest": 0.0}
    for ms, _, key in rows:
        if "::fwd_kernel<" in key:
            groups["K1 forward"] += ms
        elif "::bwd_d" in key:
            groups["K1 backward"] += ms
        elif "gemm" in key.lower() or "cutlass" in key.lower() or "xmma" in key.lower():
            groups["cuBLAS products"] += ms
        else:
            groups["rest"] += ms
    busy_ms, wall_ms = sum(groups.values()), wall_s * 1e3
    print(f"  host clock ({card}): one step {step_s * 1e3:.2f} ms; under torch.profiler: wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}", flush=True)
    print("  " + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()), flush=True)
    for ms, count, key in rows[:top]:
        print(f"  {ms:10.3f} ms {count:6d}x  {key[:100]}", flush=True)


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
    print("kernels vs plain versions (ds2 sampling shapes, batch 256):", flush=True)
    serving_kernel_phases(results)
    print("K1 vs plain, ds2 training shape: qkv (64, 135, 1440) f32, 6 heads x 80", flush=True)
    k1_ms = k1_kernel_phase(results, 64, 135)
    ds3: dict = {}
    print("K1 vs plain, ds3 token count: qkv (16, 450, 1440) f32, 6 heads x 80", flush=True)
    k1_ms_ds3 = k1_kernel_phase(ds3, 16, 450)
    failed = [k for r in (results, ds3) for k, v in r.items() if not v["ok"]]
    if failed:
        raise PhaseError(f"kernels disagree with their plain versions: {failed}")
    for label, res in (("", results), (" at N=450", ds3)):
        for k, r in res.items():
            lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
            bound = "" if k not in REPLACES else \
                f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            print(f"  {k}{label}: {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms{lib}{bound} "
                  f"({card})", flush=True)
    for label, ms in (("ds2 training shape", k1_ms), ("N=450", k1_ms_ds3)):
        print(f"  K1 forward + backward through autograd, {label}: K1 {ms['K1']:.4f} ms, plain "
              f"{ms['plain']:.4f} ms, SDPA {ms['sdpa']:.4f} ms ({card})", flush=True)

    print("slice: ds2 two-stage generator at full width", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        launches, times, generator = slice_phase(Path(tmp))
        print(f"slice: {BATCH * len(times) / sum(times):.2f} showers/s over all {len(times)} "
              f"requests, {BATCH * (len(times) - 1) / sum(times[1:]):.2f} steady (first "
              f"request excluded); batch {BATCH}, requests {[round(t, 4) for t in times]} s; "
              f"on {card}", flush=True)
        print("profile: one more request, by layer", flush=True)
        profile_phase(generator, card)
        del generator

    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "data").mkdir()
        _binning_xml(Path(tmp) / "data" / "binning_dataset_2.xml")
        print("train: ds2 shape model at full width through the CaloChallenge experiment",
              flush=True)
        train_launches, exp = train_phase(Path(tmp), card)
        print("train parity: K1 against the plain attention", flush=True)
        train_parity_phase(exp)
        print("train profile: one ds2 train step", flush=True)
        train_profile_phase(exp, card)
        del exp
        print("energy: ds2 energy model at full width", flush=True)
        energy_phase(Path(tmp))
    launches.update(train_launches)

    summary = [{"name": k, "route": "cuda", "source": REPLACES[k][0], "replaces": REPLACES[k][1],
                "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
                "tolerance": TOL[k], "ok": results[k]["ok"], "ms": results[k]["ms"],
                "plain_ms": results[k]["plain_ms"], "bound_ms": results[k]["bound_ms"],
                "bound_by": results[k]["bound_by"], "library_ms": results[k]["library_ms"]}
               for k in REPLACES]
    for entry in summary:
        if entry["name"] in ds3:
            r = ds3[entry["name"]]
            entry["n450"] = {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "library_ms")}
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
