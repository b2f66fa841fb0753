#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the ds2 and ds3 two-stage
shower generators (CFM and cINN shape models), the layer-causal ViT, the ds2
training slice and its megakernel training tier, ds3 CFM training and
serving through the composed block's opt-in kernels, and the 13,500-token
ds3 ViT (ds3_long) through the streaming flash attention K7, at full width,
through the hand-written CUDA kernels.

    python3 chip_smoke.py        # from the repository root, on a machine with a GPU

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: requires CUDA (no CPU path); prints the card's name and power limit;
2. build: compiles every kernel of the port from ``vit4hep_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and prints the seconds;
3. kernels: calls each kernel's wrapper at the shapes of its main paths and
   holds it against its plain PyTorch version on the same inputs, with the
   tolerance stated in ``TOL``; times the kernel, the plain version and,
   where one PyTorch call computes the same function, that call (CUDA
   events, median; SDPA with the boolean mask for a masked kernel). The
   shape groups (``SHAPE_GROUPS``): K3 and K2v at the ds2 sampling shapes
   (batch 256; the ViT GEMM's GELU and gated-residual products also with
   their save outputs, as the training forward runs them, held but not
   timed and kept out of the ``kernels`` line, here and at ds3); K1
   (``fused_qkv_attention``, forward and backward) at the ds2 training shape
   (qkv (64, 135, 1440), 6 heads) and at ds3's token count (16, 450, 1440);
   K4 (``fused_binned_rqs_inverse``) at the ds2 cINN shape (y (256, 3240),
   theta (256, 3240, 31)), also against an f64 run of its plain version,
   with its bytes bound and the issue-slot time its SASS loop gives
   (``k4_issue``), and, untimed, on its other branch (identity tails,
   domain clamping); K1's forward at the ds2 cINN
   subnet shape (qkv (256, 135, 576), 4 heads x 48); at ds3: K2v (products,
   LayerNorm, attention at qkv (256, 450, 1440), whole forward), K1's
   forward at the ds3 cINN subnet shape (256, 225, 576) and K4 at y (256,
   20250); with the layer-causal mask of ds2's (15, 1, 9) token grid: K2v's
   attention and whole forward, and K1's four kernels at the training shape;
   the megakernel tier at the ds2 training shape x (64, 135, 480): the
   training GEMM's saving epilogues, the NT and split-K TN products of a
   block's gradient and their reduction, the row passes and the adaLN
   reduction, K5b (a1 saved; without a1 also at (16, 450, 480)), K2b, K5c
   and the whole-ViT K5a, unmasked and layer-causal; the composed block's
   opt-in kernels at the ds3 training shape (batch 64; their "main" shape)
   and serving shape (batch 256), 450 tokens, 6 heads x 80: K6
   (``flash_qkv_attention``, qkv panel) and K8 (``vmem_attention``, q, k, v
   (B, 6, 450, 80)) forward and backward, unmasked and with the
   layer-causal mask of ds3's (15, 5, 6) grid, against their plain versions
   on the same bf16-rounded multiplicands, SDPA on bf16 as the forward's
   library call and its backward alone as the backward passes', and forward
   + backward through autograd; K9
   (``fused_mlp_half``: its modulated LayerNorm, its two products and the
   whole chain) at x (64 / 256, 450, 480), ``torch.matmul`` on bf16 as the
   products' library call; K7 (``flash_attention``: its pre-pass, bit for
   bit against ``split_plain``, and its forward, dK/dV and dQ passes in
   split TF32 against the f32 plain versions) on strided q/k/v views at
   ds3_long's serving shape (2, 6, 13500, 80) and training shape (8, 6,
   13500, 80) (the plain versions one element at a time), at the ds3
   training shape (64, 6, 450, 80) unmasked and layer-causal, and at (8,
   6, 300, 80) with a tail tile and one wholly masked row, SDPA on the
   same f32 tensors (with the mask where there is one) as the library call
   (its backward alone for the backward passes); K7's forward against f64
   within 2e-5 of the scale at every padded head dim, unmasked, all-True
   and layer-causal, and each masked forward of K7, K6 and K2v with an
   all-True mask equal to its unmasked kernel at every padded head dim
   (``masked_forms_phase``: a register A operand lost to ptxas shows as an
   error of the operand's own size), and K8's forward, unmasked and with an
   all-True mask, against an f64 softmax of its bf16 operands (its two arms
   round the exponent in another order); the block stack
   (``fused_dit_stack``): K2s without gradients (ungrouped and
   layer-causal, exactly 6 x (4 GEMM + 2 modln + 1 attention) launches;
   group 8 bit for bit the ungrouped output) against the chained f32
   blocks, K5a-stack against the chained plain
   blocks on bf16 multiplicands, at x (256, 135, 480) and (64, 450, 480),
   and its gradients against the composed f32 path with its residuals,
   with the residual tier forced off and with ``bwd="xla"``; then K10
   (``tools/megakernel_residue``): the DiT block body timed by kernel at
   ds2 and ds3, each against its bound;
4. serving paths, each at full width with random weights from a seed
   (non-zero adaLN and final-layer weights) behind the energy model
   (cfm_ds2_energy = cfm_ds3_energy), answering REQUESTS requests of BATCH
   incident energies through ``Generator.sample_showers``. The launch
   counters are set to 0 just before and read just after: every kernel of
   the path must have run as often as the path needs. The MeV showers must
   be finite, non-negative and of shape (BATCH, voxels); a small batch is
   held against the same generator on the composed plain-PyTorch nets with
   the same noise; then one more request by layer (energy stage, shape
   stage, host transforms) and under ``torch.profiler`` (device time per
   kernel and per group, the device's idle share). The paths:
   - ds2_cfm: cfm_ds2_electrons (ViT hidden 480, depth 6, 6 heads x 80, 135
     tokens x 48) through calochallenge_ds2's transforms, 6480 voxels; per
     net eval K2v GEMM 26, modln 13, attention 6 and K3 1 launches;
   - ds2_cinn: cinn_ds2_electrons (20 coupling blocks, 40 ViT1D subnets of
     hidden 192, depth 3, 4 heads x 48, 135 tokens x 24; 90.7 M params)
     through calochallenge_ds2_noise's transforms: K4 40, K1 forward 120 and
     K3 80 launches per request;
   - ds3_cfm: cfm_ds3_electrons (450 tokens x 90, 26.1 M params) through
     calochallenge_ds3's transforms, 40500 voxels (45 layers x 50 alpha x
     18 radial bins; the radial edges are synthetic), the launches of
     ds2_cfm;
   - ds3_cinn: cinn_ds3_electrons (10 coupling blocks, 20 ViT1D subnets of
     225 tokens x 90; 53.5 M params) through calochallenge_ds3_noise's
     transforms: K4 20, K1 forward 60 and K3 80 launches per request;
   - causal_cfm: cfm_ds2_electrons with ``causal_attn: true``, the
     reference's layer-causal ViT: K2v's attention takes the shared mask,
     and the plain generator the masked plain attention;
   - ds3_vmem_cfm, ds3_flash_cfm, ds3_mlp_cfm: cfm_ds3_electrons composed
     (``fused_block: false``) with ``attn_impl: vmem`` (K8 6 launches per
     net eval), ``attn_impl: flash`` (K6 6) and ``fused_mlp: true`` (K1's
     forward 6, K9's modulated LayerNorm 6 and products 12), K3 1 each;
     DS3_REQUESTS requests, no profile; the plain generator has no opt-in
     kernel;
   - ds3_long_cfm: ds3_long (cfm_ds3_electrons with (3, 1, 1) patches:
     13,500 tokens x 3, composed, attn_impl auto) at batch
     DS3_LONG_SERVE_BATCH, DS3_REQUESTS requests: K7's pre-pass and
     forward 6 each per net eval, 480 a request; the reference at batch 1 and 2 RK4 steps;
5. ds2_train: the ds2 shape model at full width (hidden 480, depth 6, 6
   heads x 80, 135 tokens x 48, batch 64, AdamW lr 1e-4 wd 0.1, cosine,
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
6. train parity: from one initial state, with the same batches and the same
   (t, x_0), TRAIN_PARITY_STEPS steps with ``attn_impl: auto`` (K1) and with
   ``attn_impl: xla`` (plain) must agree (``TRAIN_TOL``); causal_train: the
   same with ``causal_attn: true``, K1's masked forward and backward against
   the plain masked attention, every K1 kernel launched on every block of
   every step;
7. train profile: one train step under ``torch.profiler``: device ms of K1's
   forward and backward kernels, the cuBLAS products and the rest, and the
   step's idle share;
8. ds2_fused_train: the same model with ``fused_block: true`` through the
   experiment (the megakernel tier: K5a's residual-saving forward and K5b's
   backward per block; K2v on the validation batches), TRAIN_STEPS steps,
   every launch counted exactly (``fused_launches``), finite losses and
   grad norms, no skipped step, steps/s beside ds2_train's;
9. fused train parity: each of ``fused_block: true``, ``"hybrid"`` (K5a +
   the plain residual backward), ``fused_stack: false`` (K2b + K5c),
   ``true`` with ``causal_attn: true`` and ``true`` at ds3 (batch 16, a1
   recomputed) against the composed net from one state: per-tensor
   gradient relative L2 on one batch, then TRAIN_PARITY_STEPS steps on the
   same random batches and draws (``FUSED_TRAIN_TOL``), every kernel
   launched on every block of every step; then one fused train step
   profiled by kernel group;
10. ds3_train, ds3_vmem_train, ds3_flash_train, ds3_mlp_train: the ds3
   shape model composed at full width (450 tokens x 90, hidden 480, depth
   6, batch 64, shape.yaml's AdamW) through the experiment on synthetic
   ds3 showers, with ``attn_impl: auto`` (K1, the steps/s they stand
   beside), ``vmem`` (K8), ``flash`` (K6, and K1's delta in its backward)
   and ``fused_mlp: true`` (K9's chain in each block's forward, plain VJP;
   K1), TRAIN_STEPS steps and their validations, every launch counted
   exactly (``composed_launches``); then each of ``vmem``, ``flash``,
   ``fused_mlp`` and ``vmem`` with ``causal_attn: true`` against ``attn_impl:
   xla``, ``fused_mlp: false`` from one state (``parity_phase``,
   FUSED_TRAIN_TOL: bf16 products against f32); ds3_long_train: ds3_long
   at batch DS3_LONG_TRAIN_BATCH, DS3_LONG_STEPS steps and one validation
   batch through the experiment (K7: 6 forwards per step and per
   validation batch, 6 dK/dV and 6 dQ passes per step, a pre-pass before
   each forward and each backward), a profiled step,
   and its parity against ``attn_impl: xla`` (``checkpoint_grads: true``)
   at batch 1 (K7_TRAIN_TOL: f32 both);
11. energy: a few steps of the ds2 energy experiment at full width (batch
   256; no kernel on its path), which fits ``means_u.npy``/``stds_u.npy``.

The line before the last is the ``{"kernels": [...]}`` summary (per kernel:
its main-path shape's numbers, its launches by path and their sum, and its
numbers at the other shapes); the last line is ``{"ok": true, "device":
{...}}``. Needs no network, no PyYAML, no h5py and nothing of JAX or of the
JAX package: the ds2 and ds3 configs are written out below
(tests/test_torch_chain.py holds them equal to the YAML files).
"""

from __future__ import annotations

import json
import math
import re
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
from vit4hep_tpu_torch.ops import attention as attn
from vit4hep_tpu_torch.ops import flash_attention as fla
from vit4hep_tpu_torch.ops import flash_qkv_attention as ffa
from vit4hep_tpu_torch.ops import fused_dit_block as fdb
from vit4hep_tpu_torch.ops import fused_energy_decoder as fed
from vit4hep_tpu_torch.ops import fused_mlp as fmlp
from vit4hep_tpu_torch.ops import fused_qkv_attention as fqa
from vit4hep_tpu_torch.ops import fused_spline as fsp
from vit4hep_tpu_torch.ops import vmem_attention as fva
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask
from vit4hep_tpu_torch.tools import megakernel_residue
from vit4hep_tpu_torch.tools.timing import BF16_FLOPS, F32_FLOPS, card_name, time_ms, work_bound
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
N_EVENTS_DS3 = 1280  # ds3 (40500 voxels): 19 training batches of 64 (cycled), 13 validation
DS3_REQUESTS = 2  # requests of the composed ds3 serving paths (fused_block: false)
# ds3_long, the 13,500-token ViT: its cuts of batch (for the card's memory and
# the smoke's time; nothing else of the config is cut), its steps, and the
# parity batch (the xla reference holds (B, 6, N, N) f32 scores: 4.4 GB a
# tensor per batch element, recomputed block by block with checkpoint_grads)
# shape.yaml's 64 would need ~8x the 25.9 GiB peak of batch 8 (an estimate)
DS3_LONG_TRAIN_BATCH = 8
DS3_LONG_SERVE_BATCH = 2  # batchsize_sample 256: 80 evals x 6 K7 forwards a request
DS3_LONG_STEPS = 3  # and one validation batch (13 validation events, batch 8)
DS3_LONG_PARITY_BATCH = 1
DS3_LONG_REFERENCE_STEP = 0.5  # the reference generators: 2 RK4 steps, not 20

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

# configs/model/cinn/cinn_ds2_electrons.yaml
DS2_CINN_MODEL = {
    "_target_": "vit4hep_tpu.models.calochallenge.CaloChallengeCINN",
    "in_channels": 1,
    "shape": [45, 16, 9],
    "patch_shape": [[3, 8, 1]],
    "coupling_block": "CaloRQSplineFrEIA",
    "nblocks": 20,
    "is_spatial": [False] * 20,
    "cinn_kwargs": {
        "fused_spline": True, "bins": 10, "min_bin_sizes": [0.001, 0.001],
        "default_domain": [-8.0, 8.0, -8.0, 8.0], "identity_tails": False,
        "domain_clamping": None,
    },
    "vit_kwargs": {
        "dim": 1, "condition_dim": 46, "hidden_dim": 192, "out_channels": 1, "depth": 3,
        "num_heads": 4, "mlp_ratio": 4.0, "attn_drop": 0, "proj_drop": 0,
        "temperature": 10000, "learn_pos_embed": True, "causal_attn": False,
        "checkpoint_grads": False,
    },
}

# data.transforms of configs/calochallenge/cinn/calochallenge_ds2_noise.yaml
DS2_CINN_TRANSFORMS = {
    "NormalizeByElayer": {"ptype": "${data_dir}/binning_dataset_2.xml", "xml_file": "electron"},
    "ScaleTotalEnergy": {"n_layers": 45, "factor": 0.35},
    "SelectiveUniformNoise": {"a": 1.0e-7, "b": 1.0e-6, "cut": True,
                              "exclusions": list(range(-45, 0))},
    "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
    "GlobalStandardizeFromFile": {"model_dir": None},
    "LogEnergy": {},
    "ScaleEnergy": {"e_min": 6.907755, "e_max": 13.815510},
    "AddFeaturesToCond": {"split_index": 6480},
    "Reshape": {"shape": [1, 45, 16, 9]},
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

# configs/model/cfm/cfm_ds3_electrons.yaml
DS3_SHAPE_MODEL = dict(DS2_SHAPE_MODEL, shape=[45, 50, 18], patch_shape=[3, 10, 3], net=dict(
    DS2_SHAPE_MODEL["net"], param=dict(DS2_SHAPE_MODEL["net"]["param"], num_patches=[[15, 5, 6]],
                                       patch_dim=90)))

# ds3_long: configs/model/cfm/cfm_ds3_electrons.yaml with patches of (3, 1, 1):
# 15 x 50 x 18 = 13,500 tokens of 3 values (the 15 layer groups of the shipped
# (15, 5, 6) grid), composed (fused_block false), attn_impl auto: past
# flash_qkv_fits (10,752 tokens at hidden 480) every block's attention is K7
DS3_LONG_MODEL = dict(DS3_SHAPE_MODEL, patch_shape=[3, 1, 1], net=dict(
    DS3_SHAPE_MODEL["net"], param=dict(DS3_SHAPE_MODEL["net"]["param"],
                                       num_patches=[[15, 50, 18]], patch_dim=3,
                                       fused_block=False, attn_impl="auto")))

# configs/model/cfm/cfm_ds3_energy.yaml (byte-identical to cfm_ds2_energy.yaml)
DS3_ENERGY_MODEL = DS2_ENERGY_MODEL

# configs/model/cinn/cinn_ds3_electrons.yaml
DS3_CINN_MODEL = dict(DS2_CINN_MODEL, shape=[45, 50, 18], patch_shape=[[3, 10, 3]], nblocks=10,
                      is_spatial=[False] * 10)

# data.transforms of configs/calochallenge/cfm/calochallenge_ds3.yaml (no
# standardization eps, unlike ds2)
DS3_SHAPE_TRANSFORMS = {
    "NormalizeByElayer": {"ptype": "${data_dir}/binning_dataset_3.xml", "xml_file": "electron"},
    "ScaleTotalEnergy": {"n_layers": 45, "factor": 0.35},
    "CutValues": {"cut": 1.0e-7, "n_layers": 45},
    "ExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True},
    "GlobalStandardizeFromFile": {"model_dir": None},
    "LogEnergy": {},
    "ScaleEnergy": {"e_min": 6.907755, "e_max": 13.815510},
    "AddFeaturesToCond": {"split_index": 40500},
    "Reshape": {"shape": [1, 45, 50, 18]},
}

# data.transforms of configs/calochallenge/cinn/calochallenge_ds3_noise.yaml
DS3_CINN_TRANSFORMS = dict(
    DS2_CINN_TRANSFORMS,
    NormalizeByElayer={"ptype": "${data_dir}/binning_dataset_3.xml", "xml_file": "electron"},
    AddFeaturesToCond={"split_index": 40500}, Reshape={"shape": [1, 45, 50, 18]})

# data.transforms of configs/calochallenge/cfm/calochallenge_ds3_energy.yaml
DS3_ENERGY_TRANSFORMS = dict(
    DS2_ENERGY_TRANSFORMS,
    NormalizeByElayer={"ptype": "${data_dir}/binning_dataset_3.xml", "xml_file": "electron"})

# the CaloChallenge geometries: (alpha bins, radial bin edges) of each of the
# 45 layers. ds2's edges are the dataset's; ds3's real binning file is not in
# the repository, so its 18 radial bins take synthetic edges
GEOMETRY = {
    "ds2": (16, (0, 4, 8, 13, 19, 27, 38, 54, 80, 150)),
    "ds3": (50, (0, 2, 4, 6, 8, 10, 13, 16, 20, 24, 29, 35, 42, 50, 60, 75, 95, 120, 150)),
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

# the TF32 tensor-core peak (NVIDIA H100 SXM data sheet, dense, at 700 W)
TF32_FLOPS = 494.7e12


def split_tf32_bound(nbytes, flops):
    """work_bound of products held to f32 on the tensor cores in split TF32:
    each product runs as three TF32 products (hi hi + hi lo + lo hi), so the
    least time is the larger of the bytes over the HBM rate and 3 x the
    products' operations over the TF32 peak."""
    return work_bound(nbytes, 3 * flops, TF32_FLOPS)


# tolerances of the kernel phases, relative to max(1, max |plain|):
# energy_decoder and K1 hold their plain versions' f32 function: every
# product runs as three TF32 tensor-core products (hi hi + hi lo + lo hi),
# which leaves ~2^-21 of each product term (NVIDIA H100 80GB HBM3, 700 W:
# 3e-6 to 7e-6 of the scale for K1's passes and K3), the rest is summation
# order (K1's online softmax rescales partial sums; energy_decoder at other
# widths keeps the f32 CUDA-core kernel); the ViT kernels round their outputs (modln, GELU hidden, attention context) to bf16, whose
# ulp is 2^-8 = 3.9e-3 relative, so one rounding flip is within 8e-3; the
# whole forward takes bf16 multiplicands through 6 blocks against an f32
# plain version (the TPU kernel's precision contract).
# K4 (binned_rqs_inverse) is f32 like its plain version; its knots are
# summed in another order, so a point at a knot may take the neighbouring
# bin (the spline is C^1 there); it is held on x and on the log-determinant,
# each against its own scale. Its transcendentals run on the SFU: a
# softplus is ln 2 * lg2.approx(1 + ex2.approx(-|v| log2 e)) + max(v, 0),
# within ~3e-7 absolute of log1p(exp(-|v|)) + max(v, 0) (ex2.approx 2 ulp
# relative on a value in (0, 1], the sum 1 + e rounded to 2^-24, lg2.approx
# 2^-22 absolute on [1, 2]); each width or height (>= min_bin_sizes 0.001,
# ~1.6 at the shipped domain) so moves a knot by <= bins x 3e-7 = 3e-6, and
# each derivative (~1) by 3e-7 relative. The logs are lg2.approx (2^-22
# absolute, 3 ulp away from 1) and the divides by a width, the Newton
# denominators (>= half the bin's slope), the tails' slope and the softmax
# sums are rcp.approx products (1 ulp): x moves by ~1e-6 of a scale of
# 8-30, a log-derivative by ~1e-6, a row's sum of D of them by ~1e-6 x
# sqrt(D) at random sign: 1e-4 of the scale holds with a margin of ~10,
# and K4_F64_TOL holds it against f64. The masked kernels and the ds3
# shapes keep these bounds: the mask only replaces scores by -1e30, and 450
# tokens sum 3.3x more softmax terms in f32.
TOL = {"energy_decoder": 1e-3, "vit_gemm": 8e-3, "vit_modln": 8e-3,
       "vit_attention": 8e-3, "fused_vit_forward": 2e-2, "qkv_attn_fwd": 1e-4,
       "qkv_attn_bwd_delta": 1e-4, "qkv_attn_bwd_dkv": 1e-4, "qkv_attn_bwd_dq": 1e-4,
       "binned_rqs_inverse": 1e-4}
# train parity, K1 against the plain attention from one state: per-step
# loss relative 1e-4 (f32 both, summation order only); each parameter within
# half of one step's lr (5e-5 at lr 1e-4) -- Adam divides every gradient
# entry by its own RMS, so the rounding noise of an entry whose true gradient
# is zero (the key biases: softmax ignores them) can move it by a fraction of
# lr -- and the whole update vector within 1e-2 relative, which a wrong
# gradient would miss by O(1)
TRAIN_TOL = {"loss": 1e-4, "param_abs": 5e-5, "update_rel": 1e-2}
# the DiT megakernel tier's training kernels against their plain versions
# (bf16 multiplicands on both sides; the attention in f32 on both, as K1):
# the products agree but for f32 summation order, which reaches a bf16
# output or an intermediate rounded to bf16 (h, h2, the GELU hidden, a1, y)
# as one rounding flip, 2^-8 = 3.9e-3 relative, so 8e-3 holds a single
# block; the ds2 forward K5a compounds such flips through 6 blocks, 2e-2 as
# K2v's whole forward. The f32 products (NT, split-K TN, reductions) are held
# to 1e-3: summation order of up to 8640 bf16 products in f32 only. The
# first card run (NVIDIA H100 80GB HBM3, 700 W) measured, relative to each
# output's scale: K5b 5.9e-4 (masked 6.7e-4), K2b 1.0e-3, the training GEMM
# 2.6e-3 (one flip of a bf16 hidden value), K5c 3.5e-3 (its plain version
# keeps the recomputed a1 in f32, the kernel stores it in bf16 as K5a
# does), K5a 6.7e-3, the TN products 3.6e-6.
TOL.update({"vit_train_gemm": 8e-3, "vit_gemm_nt": 1e-3, "vit_gemm_tn": 1e-3,
            "vit_wgrad_reduce": 1e-4, "vit_bwd_rows": 8e-3, "vit_dmod_reduce": 1e-4,
            "fused_dit_block": 8e-3, "vit_fwd_train": 2e-2, "fused_dit_block_bwd_res": 8e-3,
            "fused_dit_block_bwd": 8e-3})
# fused training (bf16 multiplicands) against the composed f32 path from one
# state on the same batches and draws: each product's multiplicands are
# rounded to bf16 (2^-9 relative each, independent), ~1.6e-3 relative per
# product output; a gradient deep in the net passes ~40 products forward
# and backward, so its relative L2 error is at most about sqrt(40) x 1.6e-3
# = 1e-2 (the first card run measured 3.3e-3 at worst, the products'
# errors being partly independent of each other):
# per-tensor gradient relative L2 within 3e-2 (the train step's grad_norm
# likewise); the loss (target-dominated) within 1e-2 relative; a gradient
# with a missing or wrong term misses these by O(1). Adam's update divides
# each entry by its own RMS, so entries whose gradient is within bf16 noise
# of 0 take either sign: the whole update vector after 3 steps within 0.5
# relative (a wrong gradient gives ~1.4).
FUSED_TRAIN_TOL = {"loss": 1e-2, "grad_rel_l2": 3e-2, "grad_norm": 3e-2, "update_rel": 0.5}
# the composed block's opt-in kernels against their plain versions on the
# same bf16-rounded multiplicands (mm_dtype bf16), accumulating in f32 on
# both sides: they differ by summation order and exp only. That moves s, dp
# or the row sums by ~1e-6 relative, which can flip the bf16 rounding of a p
# or ds element (2^-8 relative) where it sits at a rounding boundary. A
# forward output sums p over its row's keys, each flip moving it by 2^-8 of
# one term's share: 2e-3 of the scale (the first card run, NVIDIA H100 80GB
# HBM3, 700 W, measured at most 7.8e-4, layer-causal at batch 256). The
# backward's dK and dV sum ds and p terms over every query, and the
# layer-causal mask leaves a first-layer row 30 keys, so each of its terms
# weighs ~1/30: 4e-3 (measured at most 1.8e-3 there, 8.3e-4 unmasked). The
# lse comes from f32 sums only. K8's wgmma kernels take exp as the fast
# __expf (a few ulp; ~40 at exp(-30)), far below the bf16 rounding p and ds
# take next: on the same card they measured at most 7.8e-4 of the scale in
# the forward and 1.7e-3 in the backward (dK/dV, layer-causal at batch 256).
# K9's chain rounds the modulated LayerNorm and the GELU hidden to bf16 as
# its plain version does: one rounding flip of a hidden value, 8e-3 as K2b's
# block.
TOL.update({"vmem_attn_fwd": 2e-3, "vmem_attn_bwd_dq": 4e-3, "vmem_attn_bwd_dkv": 4e-3,
            "flash_qkv_fwd": 2e-3, "flash_qkv_bwd_dq": 4e-3, "flash_qkv_bwd_dkv": 4e-3,
            "mlp_modln": 8e-3, "mlp_gemm": 8e-3, "fused_mlp_half": 8e-3})
# training with attn_impl vmem / flash (bf16 attention products) or fused_mlp
# (bf16 MLP products) against attn_impl xla, fused_mlp false (f32) from one
# state: fewer products are bf16 than in the megakernel tier, so its bounds
# (FUSED_TRAIN_TOL) hold with more margin
# K7 (flash_attention, the separated-layout streaming kernel) computes in f32
# like its plain version, as K1: summation order only (its online softmax
# rescales partial sums), 1e-4 of the scale, at 13,500 keys too (a row's
# weights sum 13,500 f32 terms, each error ~1e-7 relative). The block stack
# (K2s, K5a-stack) chains K2b's / K5a's block kernels through 6 blocks: 2e-2,
# the bound of K2v's and K5a's whole forwards (K2s against the f32 blocks,
# K5a-stack against the plain blocks on bf16 multiplicands).
# K7's products run as three TF32 products each (split TF32, as K1's), which
# leaves ~2^-21 of each product term: the same 1e-4 (the first card run,
# NVIDIA H100 80GB HBM3, 700 W, measured at most 7.7e-6 of the scale). Its
# pre-pass writes tf32 roundings of the inputs, the same bits as its plain
# version's (0: bit for bit).
TOL.update({"flash_attn_fwd": 1e-4, "flash_attn_bwd_dkv": 1e-4, "flash_attn_bwd_dq": 1e-4,
            "flash_attn_split": 0.0, "fused_dit_stack": 2e-2, "stack_fwd_train": 2e-2})
# K7's forward against an f64 reference at every padded head dim: split
# TF32 keeps ~2^-21 of each product term, so 2e-5 of the scale; a lo term
# lost (one TF32 product) misses it by ~10x
K7_F64_TOL = 2e-5
# K4 against an f64 run of its plain version: the SFU forms above keep x
# and the log-determinant within ~1e-6 of their scales (the f32 plain
# version itself is ~1e-7 from f64), so 2e-5 of the scale; an approximation
# an order of magnitude coarser (a lost Newton step, tanh.approx, a
# softplus without its log1p) misses it
K4_F64_TOL = 2e-5
# ds3_long training with K7 against attn_impl xla from one state: f32 on both
# sides (the rest of the composed net is the same code), so K1's train
# parity bounds hold (TRAIN_TOL's reasoning): loss and grad norm 1e-4
# relative; per-tensor gradient relative L2 1e-3 (summation order over
# 13,500 keys, ~1e-6, with margin); the update vector after 3 Adam steps 1e-2
# relative (Adam divides each entry by its own RMS, so entries whose gradient
# is rounding noise -- the key biases -- move by a fraction of lr)
K7_TRAIN_TOL = {"loss": 1e-4, "grad_rel_l2": 1e-3, "grad_norm": 1e-4, "update_rel": 1e-2}
K1 = "vit4hep_tpu_torch/csrc/qkv_attention.cu"
K1_BWD = "vit4hep_tpu_torch/csrc/qkv_bwd_tf32.cuh"
K1_BWD_LIB = "vit4hep_tpu_torch/csrc/qkv_attention_bwd.cu"
K2V = "vit4hep_tpu_torch/csrc/vit_forward.cu"
K2V_GEMM = "vit4hep_tpu_torch/csrc/vit_forward.cu (gemm_wgmma_kernel; hopper.cuh)"
K5 = "vit4hep_tpu_torch/csrc/vit_backward.cu"
K5B_PRODUCTS = "vit4hep_tpu_torch/csrc/bwd_wgmma.cuh"
K5A_BODY = "vit4hep_tpu/ops/fused_dit_block.py:1491 (_vit_fwd_train, call :1549)"
K5B_BODY = "vit4hep_tpu/ops/fused_dit_block.py:745 (fused_dit_block_bwd_res, call :808)"
K5C_BODY = "vit4hep_tpu/ops/fused_dit_block.py:1204 (fused_dit_block_bwd, call :1261)"
K2B_BODY = "vit4hep_tpu/ops/fused_dit_block.py:1636 (fused_dit_block, call :1686)"
K8 = "vit4hep_tpu_torch/csrc/vmem_wgmma.cuh (bound in vit4hep_tpu_torch/csrc/vmem_attention.cu)"
K6 = "vit4hep_tpu_torch/csrc/flash_qkv_attention.cu"
K6_BWD = "vit4hep_tpu_torch/csrc/flash_bwd_wgmma.cuh"
K9 = ("vit4hep_tpu_torch/csrc/vit_forward.cu (modln_kernel, gemm_wgmma_kernel; chained in "
      "vit4hep_tpu_torch/ops/fused_mlp.py)")
K9_BODY = "vit4hep_tpu/ops/fused_mlp.py:51 (_kernel, call :114)"
K7 = "vit4hep_tpu_torch/csrc/flash_tf32.cuh"
K7_LIB = "vit4hep_tpu_torch/csrc/flash_attention.cu"
# the block stack's bodies: K2s's (ungrouped, masked, grouped) and K5a-stack's
K2S_BODY = ("vit4hep_tpu/ops/fused_dit_block.py:257, :236 and :265 (fused_dit_stack, calls "
            ":446, :408)")
K5A_STACK_BODY = "vit4hep_tpu/ops/fused_dit_block.py:976 (_stack_fwd_train, call :1021)"
# the TPU bodies each kernel covers: K2v's unmasked, masked and grouped
# whole-ViT kernels; K1's per-head and head-packed forwards, each unmasked
# and masked, and its unmasked and masked backward
K2V_BODIES = "vit4hep_tpu/ops/fused_dit_block.py:1315, :1281 and :1325"
K1_BWD_BODIES = "vit4hep_tpu/ops/fused_qkv_attention.py:252 and :260"
REPLACES = {
    "energy_decoder": ("vit4hep_tpu_torch/csrc/energy_decoder.cu: energy_decoder_tf32_kernel "
                       "(split TF32 wgmma; energy_decoder_kernel at other widths)",
                       "vit4hep_tpu/ops/fused_energy_decoder.py:124"),
    "vit_gemm": (K2V_GEMM, f"{K2V_BODIES}; {K2B_BODY}; {K2S_BODY}"),
    "vit_modln": (K2V, f"{K2V_BODIES}; {K2B_BODY}; {K2S_BODY}"),
    "vit_attention": ("vit4hep_tpu_torch/csrc/vit_attention_wgmma.cuh: vit_attn_wgmma_kernel "
                      "(bound in vit4hep_tpu_torch/csrc/vit_forward.cu)",
                      f"{K2V_BODIES}; {K2B_BODY}; {K2S_BODY}"),
    "qkv_attn_fwd": ("vit4hep_tpu_torch/csrc/qkv_fwd_tf32.cuh: qkv_fwd_tf32_kernel (bound in "
                     "vit4hep_tpu_torch/csrc/qkv_attention.cu)",
                     "vit4hep_tpu/ops/fused_qkv_attention.py:58, :65, :94 and :156"),
    "qkv_attn_bwd_delta": (K1, K1_BWD_BODIES),
    "qkv_attn_bwd_dkv": (f"{K1_BWD}: qkv_bwd_dkv_tf32_kernel (bound in {K1_BWD_LIB})",
                         K1_BWD_BODIES),
    "qkv_attn_bwd_dq": (f"{K1_BWD}: qkv_bwd_dq_tf32_kernel (bound in {K1_BWD_LIB})",
                        K1_BWD_BODIES),
    "binned_rqs_inverse": ("vit4hep_tpu_torch/csrc/binned_rqs.cu: binned_rqs_inverse_kernel",
                           "vit4hep_tpu/ops/fused_spline.py:55"),
    # the megakernel tier's training kernels (K5a also runs modln and K1's
    # forward; K5b K1's backward; K5c K5a's block kernels, then K5b's)
    "vit_train_gemm": (K2V_GEMM, f"{K5A_BODY}; {K5A_STACK_BODY}; the products of {K5B_BODY} and "
                       f"{K5C_BODY}"),
    "vit_gemm_nt": (f"{K5B_PRODUCTS}: nt_wgmma_kernel (bound in {K5})",
                    f"{K5B_BODY}, through it {K5C_BODY}"),
    "vit_gemm_tn": (f"{K5B_PRODUCTS}: tn_wgmma_kernel (bound in {K5})",
                    f"{K5B_BODY}, through it {K5C_BODY}"),
    "vit_wgrad_reduce": (K5, f"{K5B_BODY}, through it {K5C_BODY}"),
    "vit_bwd_rows": (K5, f"{K5B_BODY}, through it {K5C_BODY}"),
    "vit_dmod_reduce": (K5, f"{K5B_BODY}, through it {K5C_BODY}"),
    # the composed block's opt-in kernels (K6's backward also runs K1's delta)
    "vmem_attn_fwd": (f"{K8}: vmem_fwd_wgmma_kernel",
                      "vit4hep_tpu/ops/vmem_attention.py:47 (_oneshot_kernel, call :111)"),
    "vmem_attn_bwd_dq": (f"{K8}: vmem_bwd_dq_wgmma_kernel",
                         "vit4hep_tpu/ops/vmem_attention.py:140 (_bwd_kernel, call :193)"),
    "vmem_attn_bwd_dkv": (f"{K8}: vmem_bwd_dkv_wgmma_kernel",
                          "vit4hep_tpu/ops/vmem_attention.py:140 (_bwd_kernel, call :193)"),
    "flash_qkv_fwd": ("vit4hep_tpu_torch/csrc/attention_wgmma.cuh (bound in "
                      "vit4hep_tpu_torch/csrc/flash_qkv_attention.cu)",
                      "vit4hep_tpu/ops/flash_qkv_attention.py:62 (_fwd_kernel, call :305)"),
    "flash_qkv_bwd_dq": (f"{K6_BWD}: flash_bwd_dq_wgmma_kernel (bound in {K6})",
                         "vit4hep_tpu/ops/flash_qkv_attention.py:119 (_bwd_dq_kernel, call :360)"),
    "flash_qkv_bwd_dkv": (f"{K6_BWD}: flash_bwd_dkv_wgmma_kernel (bound in {K6})",
                          "vit4hep_tpu/ops/flash_qkv_attention.py:164 (_bwd_dkv_kernel, "
                          "call :389)"),
    "mlp_modln": (K9, K9_BODY),
    "mlp_gemm": (K9, K9_BODY),
    # the separated-layout streaming flash attention in split TF32 (its
    # delta is plain); the pre-pass splits the operands that the TPU kernels
    # cast to f32
    "flash_attn_split": (f"{K7}: k7_split_kernel (bound in {K7_LIB})",
                         "vit4hep_tpu/ops/flash_attention.py:39, :84, :128 (the f32 operand "
                         "casts of _fwd_kernel, _bwd_dkv_kernel, _bwd_dq_kernel)"),
    "flash_attn_fwd": (f"{K7}: k7_fwd_kernel (bound in {K7_LIB})",
                       "vit4hep_tpu/ops/flash_attention.py:39 (_fwd_kernel, call :219)"),
    "flash_attn_bwd_dkv": (f"{K7}: k7_bwd_dkv_kernel (bound in {K7_LIB})",
                           "vit4hep_tpu/ops/flash_attention.py:84 (_bwd_dkv_kernel, call :278)"),
    "flash_attn_bwd_dq": (f"{K7}: k7_bwd_dq_kernel (bound in {K7_LIB})",
                          "vit4hep_tpu/ops/flash_attention.py:128 (_bwd_dq_kernel, call :309)"),
}
# the tier's functions (fused_dit_block, vit_fwd_train, fused_dit_block_bwd_res,
# fused_dit_block_bwd) are chains of the kernels above: the kernel phase holds
# them against their plain versions and prints their times, and the kernels
# line counts their kernels' launches, not their calls
SERVING = {"energy_decoder": fed.ENERGY_DECODER, "vit_gemm": fdb.GEMM,
           "vit_modln": fdb.MODLN, "vit_attention": fdb.ATTENTION}
TRAINING = {"qkv_attn_fwd": fqa.FWD, "qkv_attn_bwd_delta": fqa.BWD_DELTA,
            "qkv_attn_bwd_dkv": fqa.BWD_DKV, "qkv_attn_bwd_dq": fqa.BWD_DQ}
# the opt-in kernels of the composed block (attn_impl vmem / flash, fused_mlp)
OPT_IN = {"vmem_attn_fwd": fva.FWD, "vmem_attn_bwd_dq": fva.BWD_DQ,
          "vmem_attn_bwd_dkv": fva.BWD_DKV, "flash_qkv_fwd": ffa.FWD,
          "flash_qkv_bwd_dq": ffa.BWD_DQ, "flash_qkv_bwd_dkv": ffa.BWD_DKV,
          "mlp_modln": fmlp.MODLN, "mlp_gemm": fmlp.GEMM, "flash_attn_split": fla.SPLIT,
          "flash_attn_fwd": fla.FWD, "flash_attn_bwd_dkv": fla.BWD_DKV,
          "flash_attn_bwd_dq": fla.BWD_DQ}
# every counter a composed ds3 train step, validation or serving request can move
COMPOSED = {**TRAINING, **SERVING, **OPT_IN}
# every counter a fused train step or its validation can move
FUSED_TRAINING = {**TRAINING, **SERVING, "vit_train_gemm": fdb.TRAIN_GEMM,
                  "vit_gemm_nt": fdb.GEMM_NT, "vit_gemm_tn": fdb.GEMM_TN,
                  "vit_wgrad_reduce": fdb.WGRAD_REDUCE, "vit_bwd_rows": fdb.BWD_ROWS,
                  "vit_dmod_reduce": fdb.DMOD_REDUCE}


# the launches of K5b's kernels for one block's gradient (K1's backward included)
K5B_PER_BLOCK = {"vit_bwd_rows": 3, "vit_gemm_nt": 4, "vit_gemm_tn": 4, "vit_wgrad_reduce": 4,
                 "vit_dmod_reduce": 1, "qkv_attn_bwd_delta": 1, "qkv_attn_bwd_dkv": 1,
                 "qkv_attn_bwd_dq": 1}


def fused_launches(variant, steps, val_batches, depth=6):
    """The launches of each kernel on a fused training path (steps train
    steps, val_batches validation batches under no_grad): "true" (K5a, K5b
    per block, a1 saved), "noa1" (the same, a1 recomputed: ds3), "hybrid"
    (K5a, the plain residual backward), "nostack" (K2b per block, K5c)."""
    n = dict.fromkeys(FUSED_TRAINING, 0)
    per_block_bwd = K5B_PER_BLOCK
    if variant == "nostack":  # K2b forward and validation, K5c's recompute + K5b
        k2b = {"vit_gemm": 4, "vit_modln": 2, "vit_attention": 1}
        for k, v in k2b.items():
            n[k] += v * depth * (steps + val_batches)
        for k, v in {"vit_train_gemm": 5, "vit_modln": 2, "qkv_attn_fwd": 1,
                     **per_block_bwd}.items():
            n[k] += v * depth * steps
        return n
    for k, v in {"vit_train_gemm": 2 + 4 * depth, "vit_modln": 2 * depth + 1,
                 "qkv_attn_fwd": depth}.items():
        n[k] += v * steps
    for k in ("vit_gemm", "vit_modln", "vit_attention"):  # K2v on the validation batches
        n[k] += CFM_PER_EVAL[k] * val_batches
    if variant != "hybrid":
        for k, v in {"vit_train_gemm": 2 if variant == "noa1" else 1,
                     **per_block_bwd}.items():
            n[k] += v * depth * steps
    return n


def stack_launches(variant, depth=6):
    """The launches of each kernel for one forward and backward of
    ``fused_dit_stack`` over ``depth`` blocks: "res" (K5a-stack, K5b per
    block; a1 saved), "xla" (K5a-stack, the plain hybrid arm), "recompute"
    (no residual tier: K2s, then K2b on the first depth - 1 blocks and K5c
    per block)."""
    n = dict.fromkeys(FUSED_TRAINING, 0)
    if variant == "recompute":
        for k, v in {"vit_gemm": 4, "vit_modln": 2, "vit_attention": 1}.items():
            n[k] += v * (2 * depth - 1)
        for k, v in {"vit_train_gemm": 5, "vit_modln": 2, "qkv_attn_fwd": 1,
                     **K5B_PER_BLOCK}.items():
            n[k] += v * depth
        return n
    for k, v in {"vit_train_gemm": 4, "vit_modln": 2, "qkv_attn_fwd": 1}.items():
        n[k] += v * depth
    if variant == "res":
        for k, v in {"vit_train_gemm": 1, **K5B_PER_BLOCK}.items():
            n[k] += v * depth
    return n


def composed_launches(setting, steps, val_batches, depth=6):
    """The launches of each kernel on a composed ds3 path (steps train
    steps, val_batches forwards without gradients: validation batches, or
    net evals of a request): "auto" (K1 per block), "vmem" (K8), "flash"
    (K6, with K1's delta in its backward), "fused_mlp" (K1, and K9's chain
    per block, whose backward is the plain VJP), "k7" (K7: ds3_long, past the
    panel kernel's bound; its pre-pass before each forward and each
    backward)."""
    n = dict.fromkeys(COMPOSED, 0)
    fwd, bwd = {"vmem": ("vmem_attn_fwd", ("vmem_attn_bwd_dq", "vmem_attn_bwd_dkv")),
                "flash": ("flash_qkv_fwd", ("qkv_attn_bwd_delta", "flash_qkv_bwd_dq",
                                            "flash_qkv_bwd_dkv")),
                "k7": ("flash_attn_fwd", ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"))}.get(
        setting, ("qkv_attn_fwd", ("qkv_attn_bwd_delta", "qkv_attn_bwd_dkv", "qkv_attn_bwd_dq")))
    n[fwd] += depth * (steps + val_batches)
    for k in bwd:
        n[k] += depth * steps
    if setting == "k7":
        n["flash_attn_split"] += depth * (2 * steps + val_batches)
    if setting == "fused_mlp":
        n["mlp_modln"] += depth * (steps + val_batches)
        n["mlp_gemm"] += 2 * depth * (steps + val_batches)
    return n


# ds3_long serving: launches per net eval (K7's pre-pass and forward in each
# of 6 blocks; the energy net's decoder)
DS3_LONG_PER_EVAL = {"energy_decoder": 1, "flash_attn_split": 6, "flash_attn_fwd": 6}
# the CFM request: launches per net eval of each kernel on its path (embed,
# 6 x 4 block products and the final product; 2 LayerNorms per block and the
# final one; one attention per block; the energy net's decoder)
CFM_PER_EVAL = {"energy_decoder": 1, "vit_gemm": 2 + 4 * 6, "vit_modln": 2 * 6 + 1,
                "vit_attention": 6}
# the cINN request: launches per request of each kernel on its path (ds2: 40
# coupling sides, 40 subnets x 3 blocks, 80 energy net evals; ds3: 20, 60, 80)
CINN = {"binned_rqs_inverse": fsp.INVERSE, "qkv_attn_fwd": fqa.FWD,
        "energy_decoder": fed.ENERGY_DECODER}
CINN_PER_REQUEST = {"ds2": {"binned_rqs_inverse": 40, "qkv_attn_fwd": 120, "energy_decoder": 80},
                    "ds3": {"binned_rqs_inverse": 20, "qkv_attn_fwd": 60, "energy_decoder": 80}}

# the ViT GEMM's main-path shapes (K2v's sampling forward at batch BATCH;
# tree_compare.py times the same): tokens and patch dim by geometry, and the
# six products of a forward, (name, (K, N), epilogue)
VIT_TOKENS = {"ds2": (135, 48), "ds3": (450, 90)}


def vit_products(pdim, h=480, fdim=1920):
    return (("embed", (pdim, h), fdb.EPI_BIAS_POS), ("qkv", (h, 3 * h), fdb.EPI_BIAS),
            ("out", (h, h), fdb.EPI_GATED_RESID), ("fc1", (h, fdim), fdb.EPI_BIAS_GELU),
            ("fc2", (fdim, h), fdb.EPI_GATED_RESID), ("final", (h, pdim), fdb.EPI_BIAS))


# K6's and K8's ds3 shapes, qkv (batch, 450, 1440): (shape group, batch,
# layer-causal mask of (15, 5, 6), label)
K68_SHAPES = (("main", 64, False, "ds3 training shape"),
              ("ds3_serve", BATCH, False, "ds3 serving shape"),
              ("ds3_causal", 64, True, "ds3 training shape, layer-causal"),
              ("ds3_serve_causal", BATCH, True, "ds3 serving shape, layer-causal"))

# the kernel phase's shape groups: each kernel's main-path shape (ds2
# sampling; K1 at the ds2 training shape), then the others it is held at
SHAPE_GROUPS = {
    "main": "main-path shape: ds2 sampling (K3, K2v, K4), the ds2 training shape (K1, the "
            "tier), the ds3 training shape (K6, K8, K9), the ds3_long serving shape (K7: q/k/v "
            "(2, 6, 13500, 80))",
    "n450": "K1 at qkv (16, 450, 1440); K5b without a1 at x (16, 450, 480)",
    "noa1": "ds2 training shape, K5b without a1 (recomputed): x (64, 135, 480)",
    "causal_noa1": "ds2 training shape with the layer-causal mask, K5b without a1",
    "cinn": "K1 forward at the ds2 cINN subnet, qkv (256, 135, 576)",
    "ds3": "ds3: K2v at tokens (256, 450, 90), K1 forward at qkv (256, 225, 576), K4 at "
           "(256, 20250)",
    "causal": "ds2 with the layer-causal mask: K2v at (256, 135), K1 at (64, 135, 1440), "
              "K5b, K2b, K5c and K5a at x (64, 135, 480)",
    "ds3_serve": "K6, K8 and K9 at the ds3 serving shape: qkv (256, 450, 1440), q/k/v (256, 6, "
                 "450, 80), x (256, 450, 480)",
    "ds3_causal": "K6, K8 and K7 at the ds3 training shape with the layer-causal mask of "
                  "(15, 5, 6)",
    "ds3_serve_causal": "K6 and K8 at the ds3 serving shape with the layer-causal mask of "
                        "(15, 5, 6)",
    "ds3_train": "K7 at the ds3 training shape, q/k/v (64, 6, 450, 80), unmasked",
    "ds3_long_train": "K7 at the ds3_long training shape, q/k/v (8, 6, 13500, 80), the plain "
                      "versions one batch element at a time",
    "k7_tail": "K7 at q/k/v (8, 6, 300, 80): a tail tile of 44 rows, a causal mask with one "
               "wholly masked row",
    "stack": "the block stack (K2s, K5a-stack), depth 6, at x (256, 135, 480)",
    "stack_causal": "the block stack at x (256, 135, 480) with the layer-causal mask of "
                    "(15, 1, 9)",
    "stack_ds3": "the block stack at x (64, 450, 480)",
}


class PhaseError(RuntimeError):
    pass


def _rel_err(out, ref):
    """(max abs error, the bound's scale max(1, max |ref|))."""
    err = (out.float() - ref.float()).abs().max().item()
    return err, max(1.0, ref.float().abs().max().item())


def _agree(name, out, ref):
    """(ok, max abs error, its scale) of outputs against their plain
    version under TOL[name]; ``out``/``ref`` may be tuples of outputs, each
    held to the tolerance against its own scale."""
    torch.cuda.synchronize()
    pairs = list(zip(out, ref)) if isinstance(out, tuple) else [(out, ref)]
    errs = [_rel_err(o, r) for o, r in pairs]
    ok = all(math.isfinite(e) and e <= TOL[name] * sc for e, sc in errs)
    return (ok, *max(errs, key=lambda es: es[0] / es[1]))


def _check(name, out, ref, results, kernel_fn, plain_fn, bound, library_fn=None):
    """Hold a kernel's output against its plain version and time both (and
    the library call); repeated calls under one name add up (vit_gemm's six
    product shapes)."""
    ok, err, scale = _agree(name, out, ref)
    prev = results.get(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ok": True,
                              "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                              "library_ms": 0.0 if library_fn else None})
    b_ms, _ = bound
    res = {"max_abs_err": max(prev["max_abs_err"], err),
           "ms": prev["ms"] + time_ms(kernel_fn),
           "plain_ms": prev["plain_ms"] + time_ms(plain_fn),
           "ok": prev["ok"] and ok, "bound_ms": prev["bound_ms"] + b_ms,
           "bytes_ms": prev["bytes_ms"] + (b_ms if bound[1] == "bytes" else 0.0),
           "ops_ms": prev["ops_ms"] + (b_ms if bound[1] == "operations" else 0.0),
           "library_ms": None if library_fn is None else prev["library_ms"] + time_ms(library_fn)}
    res["bound_by"] = "bytes" if res["bytes_ms"] >= res["ops_ms"] else "operations"
    results[name] = res
    print(f"  {name}: max_abs_err {err:.3e} (bound {TOL[name]:g} x {scale:.3g}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)


def _hold(name, what, out, ref):
    """Hold outputs against their plain version under TOL[name] without
    timing them (a branch or an output that the timed check of ``name``
    does not cover): printed, kept out of the timing record, and a
    disagreement fails the phase at once."""
    ok, err, scale = _agree(name, out, ref)
    print(f"  {name}, {what}: max_abs_err {err:.3e} (bound {TOL[name]:g} x {scale:.3g}) "
          f"{'ok' if ok else 'FAILED'}, untimed", flush=True)
    if not ok:
        raise PhaseError(f"{name} disagrees with its plain version: {what}")


# gelu(a1) in f32 on the card against torch's: its tanh form cancels in the
# far negative tail (1 + tanh -> 0), where the two differ by ~1e-7 absolute
GELU_ATOL = 1e-6


def _hold_rounded(name, what, got, ref, atols):
    """Hold bf16 outputs that are f32 values rounded once (a product's side
    outputs) against f32 values: each element within one bf16 ulp (rounding
    to nearest moves it half an ulp) past its ``atols`` entry (how far the
    f32 values themselves may differ), printed untimed; a disagreement
    fails the phase at once."""
    torch.cuda.synchronize()
    worst = 0.0
    for o, r, atol in zip(got, ref, atols):
        r = r.float()
        ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        worst = max(worst, (((o.float() - r).abs() - atol).clamp(min=0) / ulp).max().item())
    ok = math.isfinite(worst) and worst <= 1.0
    print(f"  {name}, {what}: at most {worst:.3f} bf16 ulp from the f32 values "
          f"{'ok' if ok else 'FAILED'}, untimed", flush=True)
    if not ok:
        raise PhaseError(f"{name}: {what} are not the plain values rounded to bf16")


def _rand(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * std


def k3_inputs(b=BATCH):
    """(K3's call, its plain version, the bytes it must move, its products'
    operations) at the energy net's sampling shape: tgt (b, 45, 128), 4
    layers, 4 heads, F 512, TE 64, head 512, inputs made from SEED."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n, dm, te, fdim, hn, depth = 45, 128, 64, 512, 512, 4
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
    return k3, k3_plain, k3_bytes, k3_flops


def k3_kernel_phase(results):
    """K3 against its plain version at the energy net's sampling shape,
    batch BATCH (the same for ds2 and ds3). Its products hold the f32
    function in split TF32, so its bound is split_tf32_bound's."""
    k3, k3_plain, k3_bytes, k3_flops = k3_inputs()
    _check("energy_decoder", k3(), k3_plain(), results, k3, k3_plain,
           split_tf32_bound(k3_bytes, k3_flops))


def _causal_mask(grid):
    """The layer-causal (T, T) bool mask of a token grid on the card."""
    return torch.from_numpy(layer_causal_mask(grid)).cuda()


def _attn_flops(b, heads, n, d, mask):
    """Operations of softmax(q k^T) v: 4 b h n^2 d, over the (query, key)
    pairs the mask keeps (the work this run's data needs). K2v's is bounded
    at the bf16 rate (the TPU kernel takes bf16 multiplicands with f32
    accumulation); K1's, held to the f32 function in split TF32, by
    split_tf32_bound (three TF32 products for each)."""
    pairs = n * n if mask is None else int(mask.sum().item())
    return 4 * b * heads * pairs * d


def k2v_kernel_phase(results, n, pdim, mask=None, gemms=True):
    """K2v against its plain versions at the sampling shape of n tokens x
    pdim (ds2: 135 x 48, ds3: 450 x 90), batch BATCH, H 480, 6 heads x 80,
    F 1920, L 6: with ``gemms`` the six product shapes of a forward (embed,
    qkv, out-proj, fc1, fc2, final; ms/plain_ms/bound_ms of vit_gemm add up
    one call at each) and the modulated LayerNorm; then the attention and
    the whole forward, with the shared ``mask`` when given."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    b, h, heads, fdim, depth = BATCH, 480, 6, 1920, 6
    m = b * n
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    tokens = _rand(gen, b, n, pdim)
    pos = _rand(gen, n, h)
    mods = _rand(gen, b, depth, 6, h, std=0.1)
    fmod = _rand(gen, b, 2, h, std=0.1)
    products = vit_products(pdim, h, fdim)
    w = {key: _rand(gen, *s, std=0.05) for key, s, _ in products}
    bias = {key: _rand(gen, s[1], std=0.05) for key, s, _ in products}
    if gemms:
        x = _rand(gen, m, h)
        xs = x.clone()
        h_bf = bf(_rand(gen, m, h))
        hid_bf = bf(_rand(gen, m, fdim))
        gate = mods[:, 0, 2]
        for key, _, epi in products:
            a = tokens.reshape(m, pdim) if key == "embed" else hid_bf if key == "fc2" else h_bf
            kw = {fdb.EPI_BIAS_POS: dict(pos=pos),
                  fdb.EPI_GATED_RESID: dict(gate=gate)}.get(epi, {})
            wk = bf(w[key])
            a_bf = bf(a)
            resid = epi == fdb.EPI_GATED_RESID
            ker = lambda: fdb.linear(a, wk, bias[key], epi,  # noqa: E731
                                     out=x if resid else None, n_tok=n, **kw)
            pla = lambda: fdb.linear_plain(a, wk, bias[key], epi,  # noqa: E731
                                           out=x if resid else None, n_tok=n, **kw)
            lib = lambda: torch.matmul(a_bf, wk)  # noqa: E731  (the product only)
            kk, nn_ = wk.shape
            out_bytes = 2 if epi == fdb.EPI_BIAS_GELU else (8 if resid else 4)  # resid: r + w
            g_bytes = (a.numel() * a.element_size() + wk.numel() * 2 + nn_ * 4
                       + m * nn_ * out_bytes + (pos.numel() * 4 if epi == fdb.EPI_BIAS_POS else 0)
                       + (b * nn_ * 4 if resid else 0))
            bound = work_bound(g_bytes, 2 * m * nn_ * kk, BF16_FLOPS)
            if resid:  # in place: compare one update of the same starting residual
                x.copy_(xs)
                out = ker().clone()
                x.copy_(xs)
                ref = pla().clone()
            else:
                out, ref = ker(), pla()
            _check("vit_gemm", out, ref, results, ker, pla, bound, lib)
            if epi in (fdb.EPI_BIAS_GELU, fdb.EPI_GATED_RESID):
                # the same product with its save output (a1 or y), as the
                # training forward takes it: held, not timed
                saves = [torch.empty(m, nn_, dtype=torch.bfloat16, device="cuda")
                         for _ in range(2)]
                outs = []
                for fn, sv in ((fdb.train_linear, saves[0]), (fdb.linear_plain, saves[1])):
                    x.copy_(xs)
                    outs.append(fn(a, wk, bias[key], epi, out=x if resid else None, n_tok=n,
                                   save=sv, **kw).clone())
                _hold("vit_train_gemm", f"{key} ({m}, {kk}) x ({kk}, {nn_}) with its save",
                      tuple(outs[:1] + saves[:1]), tuple(outs[1:] + saves[1:]))
        del h_bf, hid_bf
        shift, scl = mods[:, 0, 0], mods[:, 0, 1]
        ker = lambda: fdb.modln(x, shift, scl, n)  # noqa: E731
        pla = lambda: fdb.modln_plain(x, shift, scl, n)  # noqa: E731
        _check("vit_modln", ker(), pla(), results, ker, pla,
               work_bound(m * h * 4 + 2 * b * h * 4 + m * h * 2, 8 * m * h, F32_FLOPS))
        del x, xs

    # the attention against its plain version on the kernel's bf16
    # multiplicands; its library call is SDPA on bf16 q, k, v (the TPU
    # kernel's precision), and SDPA on f32 q, k, v is timed beside it
    qkv = _rand(gen, b, n, 3 * h)
    q, k, v = (t.contiguous() for t in qkv.reshape(b, n, 3, heads, 80).permute(2, 0, 3, 1, 4))
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    ker = lambda m=mask: fdb.attention(qkv, heads, 80 ** -0.5, m)  # noqa: E731
    pla = lambda m=mask: fdb.attention_plain(  # noqa: E731
        qkv, heads, 80 ** -0.5, m, torch.bfloat16)
    lib = lambda: F.scaled_dot_product_attention(q16, k16, v16, attn_mask=mask)  # noqa: E731
    a_bytes = qkv.numel() * 4 + b * n * h * 2 + (0 if mask is None else mask.numel())
    _check("vit_attention", ker(), pla(), results, ker, pla,
           work_bound(a_bytes, _attn_flops(b, heads, n, 80, mask), BF16_FLOPS), lib)
    f32_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    results["vit_attention"]["library_f32_ms"] = f32_ms
    print(f"  vit_attention library calls: SDPA bf16 {time_ms(lib):.4f} ms, SDPA f32 "
          f"{f32_ms:.4f} ms", flush=True)
    if mask is not None:  # a row whose every key is masked gets the mean of V
        dead = mask.clone()
        dead[7] = False
        _hold("vit_attention", f"({b}, {n}) with row 7 wholly masked", ker(dead), pla(dead))
        del dead
    del qkv, q, k, v, q16, k16, v16

    wl = lambda s: _rand(gen, depth, *s, std=0.05)  # noqa: E731
    va = [tokens, pos, mods, fmod, w["embed"], bias["embed"],
          wl((h, 3 * h)), wl((3 * h,)), wl((h, h)), wl((h,)), wl((h, fdim)), wl((fdim,)),
          wl((fdim, h)), wl((h,)), w["final"], bias["final"]]
    ker = lambda: fdb.fused_vit_forward(*va, mask, heads, None)  # noqa: E731
    pla = lambda: fdb.vit_forward_reference(*va, mask, heads, 80 ** -0.5)  # noqa: E731
    _check("fused_vit_forward", ker(), pla(), results, ker, pla, (0.0, "operations"))


def k1_fwd_phase(results, b, n, heads, d, mask=None):
    """K1's forward against its plain version at qkv (b, n, 3 * heads * d)
    f32, with the shared ``mask`` when given, timed beside SDPA (with the
    boolean mask). Returns (generator, qkv, context, lse, (q, k, v))."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    qkv = _rand(gen, b, n, 3 * heads * d)
    scale = d ** -0.5
    out, lse = fqa.attention_fwd_kernel(qkv, heads, scale, mask)
    out_p, lse_p = fqa.attention_fwd_plain(qkv, heads, scale, mask)
    q, k, v = (t.contiguous() for t in qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    mask_bytes = 0 if mask is None else mask.numel()
    _check("qkv_attn_fwd", torch.cat([out.flatten(), lse.flatten()]),
           torch.cat([out_p.flatten(), lse_p.flatten()]), results,
           lambda: fqa.attention_fwd_kernel(qkv, heads, scale, mask),
           lambda: fqa.attention_fwd_plain(qkv, heads, scale, mask),
           split_tf32_bound(4 * (qkv.numel() + out.numel() + lse.numel()) + mask_bytes,
                            _attn_flops(b, heads, n, d, mask)),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
    if mask is not None:  # a row whose every key is masked: the mean of V, lse -1e30
        dead = mask.clone()
        dead[7] = False
        out_d, lse_d = fqa.attention_fwd_kernel(qkv, heads, scale, dead)
        out_p, lse_p = fqa.attention_fwd_plain(qkv, heads, scale, dead)
        live = torch.arange(n, device="cuda") != 7
        _hold("qkv_attn_fwd", f"({b}, {n}) with row 7 wholly masked", (out_d, lse_d[..., live]),
              (out_p, lse_p[..., live]))
        if not (lse_d[..., 7] == -1e30).all():
            raise PhaseError("qkv_attn_fwd: the wholly masked row's lse is not -1e30")
        del dead, out_d, lse_d, out_p, lse_p
    r = results["qkv_attn_fwd"]
    print(f"  qkv_attn_fwd at qkv ({b}, {n}, {3 * heads * d}): {r['ms']:.4f} ms, f32 SDPA "
          f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), bound {r['bound_ms']:.4f} "
          "ms", flush=True)
    return gen, qkv, out, lse, (q, k, v)


def k1_kernel_phase(results, b, n, heads=6, d=80, mask=None):
    """K1's forward and backward kernels against their plain versions at
    qkv (b, n, 3 * heads * d) f32, with the shared ``mask`` when given;
    prints the kernel, plain and SDPA times of the forward and of forward +
    backward."""
    gen, qkv, out, lse, (q, k, v) = k1_fwd_phase(results, b, n, heads, d, mask)
    g = _rand(gen, b, n, heads * d)
    scale = d ** -0.5
    hd = heads * d
    pair_flops = _attn_flops(b, heads, n, d, mask) // 4  # b h pairs d

    delta = fqa.attention_bwd_delta_kernel(g, out, heads)
    _check("qkv_attn_bwd_delta", delta, fqa.delta_plain(g, out, heads), results,
           lambda: fqa.attention_bwd_delta_kernel(g, out, heads),
           lambda: fqa.delta_plain(g, out, heads),
           work_bound(4 * (2 * g.numel() + delta.numel()), 2 * g.numel(), F32_FLOPS))
    want = fqa.attention_bwd_plain(qkv, g, lse, heads, scale, mask)
    dqkv = torch.zeros_like(qkv)
    fqa.attention_bwd_dkv_kernel(qkv, g, lse, delta, heads, scale, dqkv, mask)
    fqa.attention_bwd_dq_kernel(qkv, g, lse, delta, heads, scale, dqkv, mask)
    # what both kernels read
    small = 4 * (qkv.numel() + g.numel() + 2 * lse.numel()) + (0 if mask is None else mask.numel())
    for name, cols, flops, kernel, writes in (
            ("qkv_attn_bwd_dkv", slice(hd, 3 * hd), 8 * pair_flops,
             fqa.attention_bwd_dkv_kernel, 2 * b * n * hd),
            ("qkv_attn_bwd_dq", slice(0, hd), 6 * pair_flops,
             fqa.attention_bwd_dq_kernel, b * n * hd)):
        _check(name, dqkv[..., cols], want[..., cols], results,
               lambda kernel=kernel: kernel(qkv, g, lse, delta, heads, scale, dqkv, mask),
               lambda: fqa.attention_bwd_plain(qkv, g, lse, heads, scale, mask),
               split_tf32_bound(small + 4 * writes, flops))

    # forward + backward of the same upstream gradient g: K1 through its
    # autograd.Function, the plain forward + plain backward, SDPA through autograd
    xk = qkv.clone().requires_grad_()
    xs = q.clone().requires_grad_(), k.clone().requires_grad_(), v.clone().requires_grad_()
    g_heads = g.reshape(b, n, heads, d).permute(0, 2, 1, 3).contiguous()

    def k1_run():
        xk.grad = None
        fqa.fused_qkv_attention(xk, heads, mask).backward(g)

    def plain_run():
        _, lse_run = fqa.attention_fwd_plain(qkv, heads, scale, mask)
        fqa.attention_bwd_plain(qkv, g, lse_run, heads, scale, mask)

    def sdpa_run():
        for t in xs:
            t.grad = None
        F.scaled_dot_product_attention(*xs, attn_mask=mask, scale=scale).backward(g_heads)

    # the graph the backward reuses
    sdpa_out = F.scaled_dot_product_attention(*xs, attn_mask=mask, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, xs, g_heads, retain_graph=True)  # noqa: E731
    return {"K1": time_ms(k1_run), "plain": time_ms(plain_run), "sdpa": time_ms(sdpa_run),
            "sdpa_bwd": time_ms(sdpa_bwd),
            "bwd": sum(results[k]["ms"] for k in ("qkv_attn_bwd_delta", "qkv_attn_bwd_dkv",
                                                  "qkv_attn_bwd_dq"))}


def _block_weights(gen, h=480, fdim=1920, std=0.05):
    """wqkv, bqkv, wout, bout, w1, b1, w2, b2 of one block, f32 on the card."""
    return [_rand(gen, *shape, std=std) for shape in
            ((h, 3 * h), (3 * h,), (h, h), (h,), (h, fdim), (fdim,), (fdim, h), (h,))]


def _block_flops(m, h, fdim):
    """Operations of one block's four products over m rows."""
    return 2 * m * (h * 3 * h + h * h + 2 * h * fdim)


def _bwd_flops(m, h, fdim, attn_pairs, d, save_a1=True):
    """Operations of a block's gradient from saved residuals: the out-
    projection re-derived, dY @ W^T and A^T @ dY of the four products, the
    attention backward with its scores recomputed (5 products of b h pairs
    d), and without a1 the fc1 product again."""
    return (2 * m * h * h + 2 * _block_flops(m, h, fdim) + 10 * attn_pairs * d
            + (0 if save_a1 else 2 * m * h * fdim))


def k5_kernel_phase(results, b, n, mask=None, primitives=True, save_a1=True, composites=True):
    """The megakernel tier's training kernels against their plain versions
    at x (b, n, 480), 6 heads x 80, F 1920 (ds2 training: b 64, n 135),
    with the shared ``mask`` when given. With ``primitives``: the training
    GEMM's two saving epilogues, the four NT and four split-K TN products of
    a block's gradient, their reduction, the three row passes and the adaLN
    reduction (ms of a name add up over its calls). Then K5b from the plain
    forward's residuals (a1 bf16 or, without ``save_a1``, recomputed; y
    bf16; lse), and with ``composites`` K2b, K5c and the whole-ViT K5a
    (depth 6, 48-value patches)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50 + n)
    h, heads, d, fdim, depth = 480, 6, 80, 1920, 6
    m, scale, bf = b * n, d ** -0.5, torch.bfloat16
    x, g = _rand(gen, b, n, h), _rand(gen, b, n, h)
    mod6 = _rand(gen, b, 6, h, std=0.3)
    ws = _block_weights(gen)
    wqkv, bqkv, wout, bout, w1, b1, w2, b2 = ws
    wbytes = 2 * (4 * h * h + 2 * h * fdim) + 4 * (5 * h + fdim)
    pairs = _attn_flops(b, heads, n, d, mask) // (4 * d)  # (b, head, query, key) kept
    mask_bytes = 0 if mask is None else mask.numel()
    if primitives:
        hb, hid = _rand(gen, m, h).to(bf), _rand(gen, m, fdim).to(bf)
        xr = x.reshape(m, h)
        for a, w, bias, epi, nout in ((hb, w1, b1, fdb.EPI_BIAS_GELU, fdim),
                                      (hid, w2, b2, fdb.EPI_GATED_RESID, h)):
            wk = w.to(bf)
            resid = epi == fdb.EPI_GATED_RESID
            outs = [torch.empty(m, nout, device="cuda") if resid else None for _ in range(2)]
            saves = [torch.empty(m, nout, dtype=bf, device="cuda") for _ in range(2)]
            kw = dict(gate=mod6[:, 5], resid=xr, n_tok=n) if resid else dict(n_tok=n)
            ker = lambda: fdb.train_linear(  # noqa: E731
                a, wk, bias, epi, out=outs[0], save=saves[0], **kw)
            pla = lambda: fdb.linear_plain(  # noqa: E731
                a, wk, bias, epi, out=outs[1], save=saves[1], **kw)
            out, ref = ker(), pla()
            nbytes = (a.numel() * 2 + wk.numel() * 2 + nout * 4
                      + m * nout * (2 + (4 if resid else 2))
                      + (m * nout * 4 + b * nout * 4 if resid else 0))
            _check("vit_train_gemm", (out, saves[0]), (ref, saves[1]), results, ker, pla,
                   work_bound(nbytes, 2 * m * a.shape[1] * nout, BF16_FLOPS),
                   lambda a=a, wk=wk: torch.matmul(a, wk))
        a1 = hid
        dy, da1, dattn, dqkv = (_rand(gen, m, k) for k in (h, fdim, h, 3 * h))
        # the products read bf16 operands, as the main path gives them: the
        # copies the row passes and the GELU-derivative product write beside
        # their f32 outputs (K1's dqkv cast once)
        sixteen = {id(t): t.to(bf) for t in (dy, da1, dattn, dqkv)}
        nt_saves = [torch.empty(m, fdim, dtype=bf, device="cuda") for _ in range(4)]
        for a, w, aux in ((dy, w2, a1), (da1, w1, None), (dattn, wout, None), (dqkv, wqkv, None)):
            wk, a16 = w.to(bf), sixteen[id(a)]
            # the GELU-derivative product also writes bf16 da1 and gelu(a1)
            kw_k, kw_p = ({}, {}) if aux is None else (
                dict(save=nt_saves[0], gelu_save=nt_saves[1]),
                dict(save=nt_saves[2], gelu_save=nt_saves[3]))
            ker = lambda a16=a16, wk=wk, aux=aux, kw=kw_k: fdb.gemm_nt(  # noqa: E731
                a16, wk, aux, **kw)
            pla = lambda a16=a16, wk=wk, aux=aux, kw=kw_p: fdb.gemm_nt_plain(  # noqa: E731
                a16, wk, aux, **kw)
            out, ref = ker(), pla()
            nn_, kk = wk.shape
            if aux is not None:  # the saves: the f32 values rounded once
                _hold_rounded("vit_gemm_nt", f"bf16 da1 and gelu(a1) of ({m}, {kk}) x ({kk}, "
                              f"{nn_})", nt_saves[:2], (out, fdb._gelu(aux.float())),
                              (0.0, GELU_ATOL))
            nbytes = (a16.numel() * 2 + wk.numel() * 2 + m * nn_ * 4
                      + (0 if aux is None else 3 * m * nn_ * 2))
            _check("vit_gemm_nt", out, ref, results, ker, pla,
                   work_bound(nbytes, 2 * m * nn_ * kk, BF16_FLOPS),
                   lambda a16=a16, wk=wk: torch.matmul(a16, wk.t()))
        # dW2's A is gelu(a1) as the GELU-derivative product wrote it; the
        # plain version forms it from a1
        x16 = x.reshape(m, h).to(bf)
        for ak, ap, bb, gelu in ((nt_saves[1], a1, dy, True), (hb, hb, da1, False),
                                 (x16, x16, dattn, False), (hb, hb, dqkv, False)):
            b16 = sixteen[id(bb)]
            ker = lambda ak=ak, bb=bb, b16=b16: fdb.weight_grad_partial(  # noqa: E731
                ak, bb, b16=b16)
            pla = lambda ap=ap, bb=bb, gelu=gelu: fdb.weight_grad_partial_plain(  # noqa: E731
                ap, bb, gelu)
            ws_k, cs_k = ker()
            kk, nn_ = ak.shape[1], bb.shape[1]
            # dY once, in f32 (the bias sums need it): its bf16 copy is the
            # port's design, not part of the function
            nbytes = ak.numel() * 2 + bb.numel() * 4 + (ws_k.numel() + cs_k.numel()) * 4
            _check("vit_gemm_tn", (ws_k, cs_k), pla(), results, ker, pla,
                   work_bound(nbytes, 2 * m * kk * nn_, BF16_FLOPS),
                   lambda ak=ak, b16=b16: torch.matmul(ak.t(), b16))
            _check("vit_wgrad_reduce", fdb.wgrad_reduce(ws_k, cs_k),
                   fdb.wgrad_reduce_plain(ws_k, cs_k), results,
                   lambda ws_k=ws_k, cs_k=cs_k: fdb.wgrad_reduce(ws_k, cs_k),
                   lambda ws_k=ws_k, cs_k=cs_k: fdb.wgrad_reduce_plain(ws_k, cs_k),
                   work_bound(4 * (ws_k.numel() + cs_k.numel() + kk * nn_ + nn_), ws_k.numel(),
                          F32_FLOPS),
                   lambda ws_k=ws_k, cs_k=cs_k: (ws_k.sum(0), cs_k.sum(0)))
            # split-K without atomics: two runs give the same dW and db bit for bit
            runs = [fdb.wgrad_reduce(*ker()) for _ in range(2)]
            torch.cuda.synchronize()
            same = all(torch.equal(u, v) for u, v in zip(*runs))
            print(f"  vit_gemm_tn + vit_wgrad_reduce ({kk}, {nn_}): dW and db of two runs "
                  f"{'equal bit for bit' if same else 'DIFFER'}", flush=True)
            if not same:
                raise PhaseError(f"weight_grad ({kk}, {nn_}) is not deterministic")
            del ws_k, cs_k, runs
        del hid, dy, da1, dattn, dqkv, sixteen, nt_saves, x16
        attn, dz = _rand(gen, b, n, h), _rand(gen, b, n, h)
        yb = _rand(gen, b, n, h).to(bf)
        part = torch.zeros(b, fdb.row_chunks(n)[0], 6, h, device="cuda")
        slots = {1: [5], 2: [2, 3, 4], 3: [0, 1]}
        dx1 = None
        for mode, kw, nio in ((1, dict(attn=attn, g=g, y=yb), 3 * 4 + 2 + 2 * 2 + 4 + 2),
                              (2, dict(attn=attn, g=g, dgrad=dz), 4 * 4 + 2 * 4 + 2),
                              (3, None, 3 * 4 + 4)):
            kw = kw or dict(dgrad=dz, dx1=dx1)
            # modes 1 and 2 also write the bf16 copy of dy / dattn
            c16 = [torch.empty(b, n, h, dtype=bf, device="cuda") for _ in range(2)] \
                if mode < 3 else [None, None]
            ker = lambda mode=mode, kw=kw, c=c16[0]: fdb.bwd_rows(  # noqa: E731
                mode, x, mod6, part, copy16=c, **kw)
            pla = lambda mode=mode, kw=kw, c=c16[1]: fdb.bwd_rows_plain(  # noqa: E731
                mode, x, mod6, copy16=c, **kw)
            outs = ker()
            want, sums = pla()
            sl = slots[mode]
            got_sums = part.sum(1)[:, sl]
            copies = (c16[0],) if mode < 3 else ()
            want_copies = (c16[1],) if mode < 3 else ()
            _check("vit_bwd_rows", (*outs, *copies, got_sums),
                   (*want, *want_copies, sums[:, sl]), results, ker, pla,
                   work_bound(m * h * nio + part[:, :, sl].numel() * 4, 20 * m * h, F32_FLOPS))
            if mode == 2:
                dx1 = outs[0]
        _check("vit_dmod_reduce", fdb.dmod_reduce(part), fdb.dmod_reduce_plain(part), results,
               lambda: fdb.dmod_reduce(part), lambda: fdb.dmod_reduce_plain(part),
               work_bound(4 * (part.numel() + b * 6 * h), part.numel(), F32_FLOPS),
               lambda: part.sum(1))
        del attn, dz, yb, part, hb

    # K5b from residuals of the plain forward (the types K5a saves them in)
    _, qkv, ctx, a1, y, lse = fdb.block_fwd_res_plain(x, mod6, *ws, mask, heads, scale, bf,
                                                      want_lse=True)
    a1, y = a1.to(bf), y.to(bf)
    args = (x, qkv, ctx, a1 if save_a1 else None, y, mod6, wqkv, wout, bout, w1, b1, w2, g, mask,
            heads, scale)
    ker = lambda: fdb.fused_dit_block_bwd_res(*args, lse=lse)  # noqa: E731
    pla = lambda: fdb.block_bwd_res_plain(  # noqa: E731
        *args, mm_dtype=bf, attn_dtype=torch.float32)
    nbytes = (4 * m * 6 * h + (2 * m * fdim if save_a1 else 0) + 2 * m * h + 4 * b * 6 * h
              + wbytes + 4 * lse.numel() + mask_bytes + 4 * (m * h + b * 6 * h)
              + 2 * wbytes)  # in; dx, dmod; f32 weight and bias grads
    _check("fused_dit_block_bwd_res", ker(), pla(), results, ker, pla,
           work_bound(nbytes, _bwd_flops(m, h, fdim, pairs, d, save_a1), BF16_FLOPS))
    del qkv, ctx, a1, y, lse
    if not composites:
        return
    with torch.no_grad():
        ker = lambda: fdb.fused_dit_block(x, mod6, *ws, mask, heads, None)  # noqa: E731
        pla = lambda: fdb.block_fwd_res_plain(x, mod6, *ws, mask, heads, scale, bf)[0]  # noqa: E731
        _check("fused_dit_block", ker(), pla(), results, ker, pla,
               work_bound(4 * (2 * m * h + b * 6 * h) + wbytes + mask_bytes,
                      _block_flops(m, h, fdim) + 4 * pairs * d, BF16_FLOPS))
    ker = lambda: fdb.fused_dit_block_bwd(x, mod6, *ws, g, mask, heads, None)  # noqa: E731
    pla = lambda: fdb.block_bwd_plain(x, mod6, *ws, g, mask, heads, scale, bf,  # noqa: E731
                                      torch.float32)
    _check("fused_dit_block_bwd", ker(), pla(), results, ker, pla,
           work_bound(4 * (3 * m * h + 2 * b * 6 * h) + 3 * wbytes + mask_bytes,
                  _block_flops(m, h, fdim) + 4 * pairs * d + _bwd_flops(m, h, fdim, pairs, d),
                  BF16_FLOPS))
    pdim = 48
    va = [_rand(gen, b, n, pdim), _rand(gen, n, h), _rand(gen, b, depth, 6, h, std=0.3),
          _rand(gen, b, 2, h, std=0.3), _rand(gen, pdim, h, std=0.05), _rand(gen, h, std=0.05),
          *(torch.stack([t] * depth) for t in _block_weights(gen)), _rand(gen, h, pdim, std=0.05),
          _rand(gen, pdim, std=0.05)]
    ker = lambda: fdb.vit_fwd_train(*va, mask, heads, None)  # noqa: E731
    pla = lambda: fdb.vit_fwd_train_plain(*va, mask, heads, scale, mm_dtype=bf)  # noqa: E731
    out, res, lses = ker()
    pout, pres, plses = pla()
    pres = pres[:3] + (pres[3].to(bf), pres[4].to(bf))  # a1, y kept in bf16
    res_bytes = 4 * m * ((depth + 1) * h + depth * 4 * h) + 2 * m * depth * (fdim + h) + \
        4 * lses.numel()
    _check("vit_fwd_train", (out, *res, lses), (pout, *pres, plses), results, ker, pla,
           work_bound(4 * (m * pdim + n * h + b * (6 * depth + 2) * h + m * pdim) + depth * wbytes
                  + 2 * 2 * pdim * h + mask_bytes + res_bytes,
                  2 * m * pdim * h * 2 + depth * (_block_flops(m, h, fdim) + 4 * pairs * d),
                  BF16_FLOPS))


def _f32_bytes(*tensors):
    return 4 * sum(t.numel() for t in tensors)


def k68_kernel_phase(results, b, n, heads=6, d=80, mask=None):
    """K6 and K8, forward and backward, against their plain versions on the
    same bf16-rounded multiplicands at the ds3 path shapes: qkv (b, n, 3 *
    heads * d) f32 for K6 (flash_qkv_attention), its q, k, v as contiguous
    (b, heads, n, d) for K8 (vmem_attention), with the shared ``mask`` when
    given; SDPA on bf16 q, k, v (with the boolean mask) times the forward's
    library call. Returns the forward + backward times through autograd of
    K6, K8 (from the qkv panel, as the ViT calls them), the plain f32
    attention and SDPA on bf16."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60 + n + b)
    bf, scale, hd = torch.bfloat16, d ** -0.5, heads * d
    qkv, g = _rand(gen, b, n, 3 * hd), _rand(gen, b, n, hd)
    q, k, v = (t.contiguous() for t in qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    gh = g.reshape(b, n, heads, d).permute(0, 2, 1, 3).contiguous()
    qb, kb, vb = (t.to(bf) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qb, kb, vb, attn_mask=mask, scale=scale)
    pair = _attn_flops(b, heads, n, d, mask) // 4  # b h pairs d
    mb = 0 if mask is None else mask.numel()

    fwd = lambda: ffa.flash_fwd_kernel(qkv, heads, scale, mask)  # noqa: E731
    fwd_p = lambda: ffa.flash_fwd_plain(qkv, heads, scale, mask, bf)  # noqa: E731
    out, lse = fwd()
    _check("flash_qkv_fwd", (out, lse), fwd_p(), results, fwd, fwd_p,
           work_bound(_f32_bytes(qkv, out, lse) + mb, 4 * pair, BF16_FLOPS), sdpa)
    # SDPA's backward alone on bf16 (dQ, dK and dV in one call): the library
    # call of the backward passes
    xs = tuple(t.clone().requires_grad_() for t in (qb, kb, vb))
    g_bf = gh.to(bf)
    sdpa_out = F.scaled_dot_product_attention(*xs, attn_mask=mask, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, xs, g_bf, retain_graph=True)  # noqa: E731
    delta = fqa.attention_bwd_delta_kernel(g, out, heads)
    bwd_p = lambda: ffa.flash_bwd_plain(qkv, g, out, lse, heads, scale, mask, bf)  # noqa: E731
    want = bwd_p()
    dqkv = torch.zeros_like(qkv)
    ffa.flash_bwd_dq_kernel(qkv, g, lse, delta, heads, scale, dqkv, mask)
    ffa.flash_bwd_dkv_kernel(qkv, g, lse, delta, heads, scale, dqkv, mask)
    reads = _f32_bytes(qkv, g, lse, delta) + mb
    for name, cols, flops, kernel, writes in (
            ("flash_qkv_bwd_dq", slice(0, hd), 6 * pair, ffa.flash_bwd_dq_kernel, b * n * hd),
            ("flash_qkv_bwd_dkv", slice(hd, 3 * hd), 8 * pair, ffa.flash_bwd_dkv_kernel,
             2 * b * n * hd)):
        _check(name, dqkv[..., cols], want[..., cols], results,
               lambda kernel=kernel: kernel(qkv, g, lse, delta, heads, scale, dqkv, mask), bwd_p,
               work_bound(reads + 4 * writes, flops, BF16_FLOPS), sdpa_bwd)
    del want, dqkv, delta
    if mask is not None:  # a row whose every key is masked weighs every key 0 (K6's rule)
        dead = mask.clone()
        dead[7] = False
        out_d, lse_d = ffa.flash_fwd_kernel(qkv, heads, scale, dead)
        delta = fqa.attention_bwd_delta_kernel(g, out_d, heads)
        got = torch.empty_like(qkv)
        ffa.flash_bwd_dq_kernel(qkv, g, lse_d, delta, heads, scale, got, dead)
        ffa.flash_bwd_dkv_kernel(qkv, g, lse_d, delta, heads, scale, got, dead)
        want = ffa.flash_bwd_plain(qkv, g, out_d, lse_d, heads, scale, dead, bf)
        for name, cols in (("flash_qkv_bwd_dq", slice(0, hd)),
                           ("flash_qkv_bwd_dkv", slice(hd, 3 * hd))):
            _hold(name, f"({b}, {n}) with row 7 wholly masked", got[..., cols], want[..., cols])
        if not (got[:, 7, :hd] == 0).all():
            raise PhaseError("flash_qkv_bwd_dq: the wholly masked row's dQ is not 0")
        del dead, out_d, lse_d, delta, got, want

    fwd = lambda: fva.vmem_fwd_kernel(q, k, v, scale, mask)  # noqa: E731
    fwd_p = lambda: fva.vmem_fwd_plain(q, k, v, scale, mask, bf)  # noqa: E731
    out8, lse8 = fwd()
    _check("vmem_attn_fwd", (out8, lse8), fwd_p(), results, fwd, fwd_p,
           work_bound(_f32_bytes(q, k, v, out8, lse8) + mb, 4 * pair, BF16_FLOPS), sdpa)
    bwd_p = lambda: fva.vmem_bwd_plain(q, k, v, gh, lse8, scale, mask, bf)  # noqa: E731
    want = bwd_p()
    dq_k = lambda: fva.vmem_bwd_dq_kernel(q, k, v, gh, lse8, scale, mask)  # noqa: E731
    dq, rowterm = dq_k()
    _check("vmem_attn_bwd_dq", dq, want[0], results, dq_k, bwd_p,
           work_bound(_f32_bytes(q, k, v, gh, lse8, dq, rowterm) + mb, 6 * pair, BF16_FLOPS),
           sdpa_bwd)
    dkv_k = lambda: fva.vmem_bwd_dkv_kernel(q, k, v, gh, lse8, rowterm, scale, mask)  # noqa: E731
    dk, dv = dkv_k()
    _check("vmem_attn_bwd_dkv", (dk, dv), want[1:], results, dkv_k, bwd_p,
           work_bound(_f32_bytes(q, k, v, gh, lse8, rowterm, dk, dv) + mb, 8 * pair, BF16_FLOPS),
           sdpa_bwd)
    del want, dq, rowterm, dk, dv, out8, lse8, sdpa_out

    # forward + backward of the same upstream gradient through autograd
    xk = qkv.clone().requires_grad_()

    def run(impl):
        xk.grad = None
        attn.qkv_attention(xk, heads, mask, impl=impl, scale=scale).backward(g)

    def sdpa_run():
        for t in xs:
            t.grad = None
        F.scaled_dot_product_attention(*xs, attn_mask=mask, scale=scale).backward(g_bf)

    return {"K6": time_ms(lambda: run("flash")), "K8": time_ms(lambda: run("vmem")),
            "plain": time_ms(lambda: run("xla")), "sdpa": time_ms(sdpa_run)}


def k9_kernel_phase(results, b, n, h=480, fdim=1920):
    """K9 (fused_mlp_half) against its plain version on the same bf16
    roundings at x (b, n, h) f32, F fdim: its modulated LayerNorm, the fc1
    product with its GELU epilogue and the fc2 product with its gated
    residual (mlp_gemm's times add up over the two), then the whole chain;
    torch.matmul on bf16 is the products' library call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80 + b)
    m, bf = b * n, torch.bfloat16
    x = _rand(gen, b, n, h)
    mod = _rand(gen, b, 6 * h, std=0.3)
    shift, scl, gate = mod[:, 3 * h:4 * h], mod[:, 4 * h:5 * h], mod[:, 5 * h:]
    w1, b1, w2, b2 = (_rand(gen, *s, std=0.05) for s in ((h, fdim), (fdim,), (fdim, h), (h,)))
    xr = x.view(m, h)
    ker = lambda: fmlp.modln(xr, shift, scl, n)  # noqa: E731
    pla = lambda: fdb.modln_plain(xr, shift, scl, n)  # noqa: E731
    _check("mlp_modln", ker(), pla(), results, ker, pla,
           work_bound(m * h * 4 + 2 * b * h * 4 + m * h * 2, 8 * m * h, F32_FLOPS))
    hb = pla()
    w1b, w2b = w1.to(bf), w2.to(bf)
    hid = fdb.linear_plain(hb, w1b, b1, fdb.EPI_BIAS_GELU)
    for a, wk, bias, epi, nout in ((hb, w1b, b1, fdb.EPI_BIAS_GELU, fdim),
                                   (hid, w2b, b2, fdb.EPI_GATED_RESID, h)):
        resid = epi == fdb.EPI_GATED_RESID
        kw = dict(gate=gate, resid=xr, n_tok=n) if resid else dict(n_tok=n)
        outs = [torch.empty(m, nout, device="cuda") if resid else None for _ in range(2)]
        ker = lambda a=a, wk=wk, bias=bias, epi=epi, kw=kw: fmlp.linear(  # noqa: E731
            a, wk, bias, epi, out=outs[0], **kw)
        pla = lambda a=a, wk=wk, bias=bias, epi=epi, kw=kw: fdb.linear_plain(  # noqa: E731
            a, wk, bias, epi, out=outs[1], **kw)
        nbytes = (a.numel() * 2 + wk.numel() * 2 + nout * 4 + m * nout * (4 if resid else 2)
                  + (m * nout * 4 + b * nout * 4 if resid else 0))
        _check("mlp_gemm", ker(), pla(), results, ker, pla,
               work_bound(nbytes, 2 * m * a.shape[1] * nout, BF16_FLOPS),
               lambda a=a, wk=wk: torch.matmul(a, wk))
    args = (x, shift, scl, gate, w1, b1, w2, b2)
    ker = lambda: fmlp.mlp_half_kernel(*args)  # noqa: E731
    pla = lambda: fmlp.mlp_half_plain(*args, mm_dtype=bf)  # noqa: E731
    _check("fused_mlp_half", ker(), pla(), results, ker, pla,
           work_bound(4 * (2 * m * h + 3 * b * h + 2 * h * fdim + fdim + h), 4 * m * h * fdim,
                  BF16_FLOPS),
           lambda: (torch.matmul(hb, w1b), torch.matmul(hid, w2b)))


def _batched(fn, chunk, *tensors):
    """``fn`` on ``chunk`` batch elements of every tensor at a time, its
    outputs joined along the batch: the plain versions' (chunk, 6, N, N) f32
    scores are 4.4 GB an element at N = 13,500."""
    parts = [fn(*(t[i:i + chunk] for t in tensors)) for i in range(0, tensors[0].shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def k7_kernel_phase(results, b, n, mask=None, chunk=None):
    """K7's pre-pass, forward, dK/dV and dQ passes against their plain
    versions at q, k, v (b, 6, n, 80): strided views of a random qkv panel,
    as the ViT hands them over, with the shared ``mask`` when given. The
    pre-pass bit for bit (the forward's K and V^T, the backward's seven
    operand layouts; its time is the two's sum, one of each a training
    step); the passes (each timed on operands split beforehand) in split
    TF32 against the f32 plain versions. The kernels run on the whole batch,
    the plain versions on ``chunk`` batch elements at a time (all at once by
    default). SDPA on the same f32 tensors (with the boolean mask) is the
    library call: its forward for the forward's row, its backward alone
    (through autograd, all three gradients) for the backward rows. A pass's
    bound counts the bytes of its f32 function (q, k, v, dO, lse, delta and
    the mask read once, its outputs written once); the split buffers'
    bytes count only in the pre-pass's bound. Returns
    the forward + backward times: K7 through autograd, the plain forward and
    backward, SDPA through autograd."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70 + n + b)
    heads, d = 6, 80
    scale = d ** -0.5
    qkv = _rand(gen, b, n, 3 * heads * d)
    q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    g = _rand(gen, b, n, heads * d).reshape(b, n, heads, d).permute(0, 2, 1, 3)
    qc, kc, vc, gc = (t.contiguous() for t in (q, k, v, g))
    pair = _attn_flops(b, heads, n, d, mask) // 4  # b h pairs d
    mb = 0 if mask is None else mask.numel()
    buf = 4 * b * heads * fla.padded(n) * fla.padded_dim(d)  # one split buffer's bytes
    xs = tuple(t.clone().requires_grad_() for t in (qc, kc, vc))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qc, kc, vc, attn_mask=mask, scale=scale)
    chunk = chunk or b
    tensors = {"q": q, "k": k, "v": v, "g": g}

    # the pre-pass: the forward's operands, then the backward's
    fwd_ops = ((k, fla.ROWS), (v, fla.COLS))
    split_f = lambda: fla.split_kernel(  # noqa: E731
        "flash_attention_fwd", [(k, (fla.ROWS,)), (v, (fla.COLS,))], b, heads, n, d)
    split_fp = lambda: tuple(t for x, lay in fwd_ops for t in fla.split_plain(x, lay))  # noqa: E731
    kr, vt = split_f()
    _check("flash_attn_split", (*kr[fla.ROWS], *vt[fla.COLS]), split_fp(), results, split_f,
           split_fp, work_bound(_f32_bytes(k, v) + 4 * buf, 0, F32_FLOPS))
    split_b = lambda: fla.split_bwd(q, k, v, g)  # noqa: E731
    split_bp = lambda: tuple(t for nm, lay in fla.BWD_OPS  # noqa: E731
                             for t in fla.split_plain(tensors[nm], lay))
    ops = split_b()
    _check("flash_attn_split", tuple(t for op in fla.BWD_OPS for t in ops[op]), split_bp(),
           results, split_b, split_bp,
           work_bound(_f32_bytes(q, k, v, g) + 2 * len(fla.BWD_OPS) * buf, 0, F32_FLOPS))

    kv = (kr, vt)
    fwd = lambda: fla.flash_fwd_kernel(q, k, v, scale, mask, kv)  # noqa: E731
    fwd_p = lambda: _batched(lambda *t: fla.flash_fwd_plain(*t, scale, mask),  # noqa: E731
                             chunk, q, k, v)
    out, lse = fwd()
    bounds = {"flash_attn_fwd": split_tf32_bound(_f32_bytes(q, k, v, out, lse) + mb, 4 * pair)}
    _check("flash_attn_fwd", (out, lse), fwd_p(), results, fwd, fwd_p,
           bounds["flash_attn_fwd"], sdpa)
    del kv, kr, vt
    delta = fla.delta_plain(g, out)
    bwd_p = lambda: _batched(lambda *t: fla.flash_bwd_plain(*t, scale, mask),  # noqa: E731
                             chunk, q, k, v, g, out, lse)
    want = bwd_p()
    sdpa_out = F.scaled_dot_product_attention(*xs, attn_mask=mask, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, xs, gc, retain_graph=True)  # noqa: E731
    reads = _f32_bytes(q, k, v, g, lse, delta) + mb
    dkv = lambda: fla.flash_bwd_dkv_kernel(q, k, v, g, lse, delta, scale, mask, ops)  # noqa: E731
    bounds["flash_attn_bwd_dkv"] = split_tf32_bound(reads + 2 * _f32_bytes(q), 8 * pair)
    _check("flash_attn_bwd_dkv", dkv(), want[1:], results, dkv, bwd_p,
           bounds["flash_attn_bwd_dkv"], sdpa_bwd)
    dq = lambda: fla.flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale, mask, ops)  # noqa: E731
    dq_k = dq()
    bounds["flash_attn_bwd_dq"] = split_tf32_bound(reads + _f32_bytes(q), 6 * pair)
    _check("flash_attn_bwd_dq", dq_k, want[0], results, dq, bwd_p,
           bounds["flash_attn_bwd_dq"], sdpa_bwd)
    print("  bounds: " + ", ".join(f"{nm} {ms:.4f} ms ({by})" for nm, (ms, by) in bounds.items()),
          flush=True)
    del ops
    dead = [] if mask is None else (~mask).all(1).nonzero().flatten().tolist()
    for row in dead:  # a wholly masked row: the mean of V, and its dQ is 0 (JAX's)
        if not (torch.allclose(out[:, :, row], v.mean(2), atol=1e-5)
                and torch.equal(dq_k[:, :, row], torch.zeros_like(dq_k[:, :, row]))):
            raise PhaseError(f"K7: the wholly masked row {row} is not JAX's")
    if dead:
        print(f"  wholly masked rows {dead}: the mean of V, dQ 0 (as JAX)", flush=True)
    del want, sdpa_out, dq_k

    def k7_run():
        for t in xs:
            t.grad = None
        fla.flash_attention(*xs, mask).backward(g)

    def plain_run():
        def one(*t):
            o, lse_run = fla.flash_fwd_plain(*t[:3], scale, mask)
            return fla.flash_bwd_plain(*t, o, lse_run, scale, mask)
        _batched(one, chunk, q, k, v, g)

    def sdpa_run():
        for t in xs:
            t.grad = None
        F.scaled_dot_product_attention(*xs, attn_mask=mask, scale=scale).backward(gc)

    return {"K7": time_ms(k7_run), "plain": time_ms(plain_run), "sdpa": time_ms(sdpa_run)}


PADDED_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)


def masked_forms_phase(b=2, n=200, heads=2):
    """At every padded head dim, on qkv (b, n, 3 * heads * d) with several
    key tiles: K7's forward against an f64 reference within K7_F64_TOL of
    the scale, unmasked, with an all-True mask and layer-causal (a lo term
    lost misses it by ~10x); and each masked forward of K7, K6 and K2v with
    an all-True mask against its unmasked kernel on the same inputs, within
    1e-5 of the scale (the same instructions on the same values: bit for
    bit is expected; a register A operand that ptxas reused for scratch
    after a loop's first products read it gives errors of the operand's own
    size). K8's masked forward is held otherwise: its unmasked arm fuses s *
    scale - max into one FFMA where the masked arm rounds s * scale, selects
    it or -1e30 and then subtracts, so an exponent may differ in its last
    bit and p round to the other bf16 neighbour; each arm, unmasked and with
    an all-True mask, is held against an f64 softmax of the same bf16
    operands within TOL["vmem_attn_fwd"] of the scale (a register fault
    misses it by O(1))."""
    ones = torch.ones(n, n, dtype=torch.bool, device="cuda")
    causal = torch.tril(ones)
    worst = {}
    for d in PADDED_HEAD_DIMS:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 90 + d)
        qkv = _rand(gen, b, n, 3 * heads * d)
        q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        scale = d ** -0.5
        q16, k16, v16 = (t.to(torch.bfloat16).double() for t in (q, k, v))
        ref16 = torch.matmul(torch.softmax(torch.matmul(q16, k16.transpose(-1, -2)) * scale, -1),
                             v16)
        for kind, m in (("unmasked", None), ("all-True", ones)):
            err, sc = _rel_err(fva.vmem_fwd_kernel(q, k, v, scale, m)[0], ref16)
            worst[f"K8 vs f64, {kind}"] = max(worst.get(f"K8 vs f64, {kind}", 0.0), err / sc)
            if not err <= TOL["vmem_attn_fwd"] * sc:
                raise PhaseError(f"K8's forward at d = {d}, {kind}: {err:.3e} from f64 (bound "
                                 f"{TOL['vmem_attn_fwd']:g} x {sc:.3g})")
        q64, k64, v64 = (t.double() for t in (q, k, v))
        for kind, m in (("unmasked", None), ("all-True", ones), ("layer-causal", causal)):
            s64 = torch.matmul(q64, k64.transpose(-1, -2)) * scale
            if m is not None:
                s64 = s64.masked_fill(~m, -1e30)
            err, sc = _rel_err(fla.flash_fwd_kernel(q, k, v, scale, m)[0],
                               torch.matmul(torch.softmax(s64, -1), v64))
            worst[f"K7 vs f64, {kind}"] = max(worst.get(f"K7 vs f64, {kind}", 0.0), err / sc)
            if not err <= K7_F64_TOL * sc:
                raise PhaseError(f"K7's forward at d = {d}, {kind}: {err:.3e} from f64 (bound "
                                 f"{K7_F64_TOL:g} x {sc:.3g})")
        for name, run in (("K7", lambda m: fla.flash_fwd_kernel(q, k, v, scale, m)[0]),
                          ("K6", lambda m: ffa.flash_fwd_kernel(qkv, heads, scale, m)[0]),
                          ("K2v", lambda m: fdb.attention(qkv, heads, scale, m))):
            err, sc = _rel_err(run(ones), run(None))
            worst[f"{name} all-True vs unmasked"] = max(
                worst.get(f"{name} all-True vs unmasked", 0.0), err / sc)
            if not err <= 1e-5 * sc:
                raise PhaseError(f"{name}'s masked forward at d = {d} with an all-True mask "
                                 f"differs from the unmasked one by {err:.3e}")
    print("  at d = 16-128 (relative to the scale): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + " ok", flush=True)


def _stack_weights(gen, depth, h=480, fdim=1920, std=0.05):
    """The 8 block weights stacked (depth, ...), drawn per block."""
    return [_rand(gen, depth, *shape, std=std) for shape in
            ((h, 3 * h), (3 * h,), (h, h), (h,), (h, fdim), (fdim,), (fdim, h), (h,))]


def stack_kernel_phase(results, b, n, mask=None, group=None):
    """The block stack against its plain versions at x (b, n, 480), 6
    blocks of 6 heads x 80, F 1920, with the shared ``mask`` when given:
    K2s (``fused_dit_stack`` without gradients) against the chained f32
    blocks, with exactly 6 x (4 GEMM + 2 modln + 1 attention) launches;
    with ``group``, K2s grouped must give the ungrouped output bit for bit
    with the same launches (the group changes only the TPU's batch
    padding); K5a-stack (``stack_fwd_train``) on its residual tier against
    the chained ``block_fwd_res_plain`` on bf16 multiplicands: output,
    residuals, lse."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90 + n + b)
    h, heads, d, fdim, depth, bf = 480, 6, 80, 1920, 6, torch.bfloat16
    m, scale = b * n, d ** -0.5
    x, mods = _rand(gen, b, n, h), _rand(gen, b, depth, 6, h, std=0.3)
    ws = _stack_weights(gen, depth)
    pairs = _attn_flops(b, heads, n, d, mask) // (4 * d)
    mb = 0 if mask is None else mask.numel()
    wbytes = depth * (2 * (4 * h * h + 2 * h * fdim) + 4 * (5 * h + fdim))
    flops = depth * (_block_flops(m, h, fdim) + 4 * pairs * d)
    io = 4 * (2 * m * h + b * depth * 6 * h) + wbytes + mb
    counters = {"vit_gemm": fdb.GEMM, "vit_modln": fdb.MODLN, "vit_attention": fdb.ATTENTION}
    want = {"vit_gemm": 4 * depth, "vit_modln": 2 * depth, "vit_attention": depth}

    def counted(g):
        for c in counters.values():
            c.reset()
        out = fdb.fused_dit_stack(x, mods, *ws, mask, heads, None, g)
        launches = {k: c.launches for k, c in counters.items()}
        if launches != want:
            raise PhaseError(f"K2s (group {g}): launches {launches}, expected {want}")
        return out

    with torch.no_grad():
        pla = lambda: fdb.stack_reference(x, mods, *ws, mask, heads, scale)  # noqa: E731
        ker = lambda: fdb.fused_dit_stack(x, mods, *ws, mask, heads, None)  # noqa: E731
        out = counted(1)
        print(f"  K2s: launches {want}", flush=True)
        if group is not None:
            if not torch.equal(counted(group), out):
                raise PhaseError(f"K2s: group {group} differs from the ungrouped stack")
            print(f"  K2s group {group}: the ungrouped output bit for bit, the same launches",
                  flush=True)
        _check("fused_dit_stack", out, pla(), results, ker, pla, work_bound(io, flops, BF16_FLOPS))
        del out
    save_a1, rbytes = fdb.stack_residual_tier(n, h, fdim, depth, heads, bf)
    if rbytes is None:
        raise PhaseError(f"K5a-stack: no residual tier at N = {n}")
    ker = lambda: fdb.stack_fwd_train(x, mods, *ws, mask, heads, None, save_a1)  # noqa: E731
    pla = lambda: fdb.stack_fwd_train_plain(x, mods, *ws, mask, heads, scale,  # noqa: E731
                                            save_a1, bf)
    out, res, lses = ker()
    pout, pres, plses = pla()
    pres = tuple(None if r is None else (r.to(bf) if i >= 3 else r) for i, r in enumerate(pres))
    keep = [i for i, r in enumerate(res) if r is not None]
    res_bytes = 4 * m * ((depth + 1) * h + depth * 4 * h) + \
        2 * m * depth * ((fdim if save_a1 else 0) + h) + 4 * lses.numel()
    _check("stack_fwd_train", (out, *(res[i] for i in keep), lses),
           (pout, *(pres[i] for i in keep), plses), results, ker, pla,
           work_bound(io + res_bytes, flops, BF16_FLOPS))
    print(f"  K5a-stack: residual tier save_a1={save_a1} ({rbytes} bytes per element)",
          flush=True)


def stack_grad_phase():
    """The stack's gradients (x, mods and every weight) against the
    composed f32 path (autograd through the chained plain blocks) at x (64,
    135, 480), depth 6, under FUSED_TRAIN_TOL's gradient bound: with its
    residuals (K5a-stack + K5b), with the residual tier forced off (K2s,
    then K2b + K5c), and with bwd="xla" (K5a-stack + the plain hybrid arm);
    every launch counted (``stack_launches``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 95)
    b, n, h, heads, depth = 64, 135, 480, 6, 6
    ins = [_rand(gen, b, n, h), _rand(gen, b, depth, 6, h, std=0.3), *_stack_weights(gen, depth)]
    ins = [t.requires_grad_() for t in ins]
    g = _rand(gen, b, n, h)
    ref = torch.autograd.grad(fdb.stack_reference(*ins, None, heads, 80 ** -0.5), ins, g)
    names = ["x", "mods", "wqkv", "bqkv", "wout", "bout", "w1", "b1", "w2", "b2"]
    real_bytes = fdb.train_residual_bytes
    for label, variant, bwd in (("residuals (K5a-stack, K5b)", "res", "pallas"),
                                ("residual tier off (K2s; K2b + K5c)", "recompute", "pallas"),
                                ('bwd="xla" (K5a-stack, plain hybrid arm)', "xla", "xla")):
        for c in FUSED_TRAINING.values():
            c.reset()
        if variant == "recompute":  # price every residual tier out, as JAX's tests do
            fdb.train_residual_bytes = lambda *a, **kw: 1 << 40
        try:
            grads = torch.autograd.grad(fdb.fused_dit_stack(*ins, None, heads, None, 1, bwd),
                                        ins, g)
        finally:
            fdb.train_residual_bytes = real_bytes
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in FUSED_TRAINING.items()}
        rel = {nm: ((a - r).norm() / r.norm()).item() for nm, a, r in zip(names, grads, ref)}
        worst = max(rel, key=rel.get)
        ok = rel[worst] <= FUSED_TRAIN_TOL["grad_rel_l2"]
        print(f"  stack gradients, {label}, x ({b}, {n}, {h}): relative L2 worst {rel[worst]:.3e} "
              f"({worst}), median {float(np.median(list(rel.values()))):.3e} (bound "
              f"{FUSED_TRAIN_TOL['grad_rel_l2']}) {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            raise PhaseError(f"fused_dit_stack gradients ({label}) disagree with the composed path")
        if launches != stack_launches(variant, depth):
            raise PhaseError(f"fused_dit_stack ({label}): launches {launches}, expected "
                             f"{stack_launches(variant, depth)}")
        print(f"  launches: { {k: v for k, v in launches.items() if v} }", flush=True)


def residue_phase(card):
    """K10: the block body itemized by kernel at ds2 (135 tokens, batch 256)
    and ds3 (450 tokens, batch 64) (``tools/megakernel_residue``)."""
    for tag, (n, batch) in megakernel_residue.SHAPES.items():
        rows = megakernel_residue.itemize(megakernel_residue.make_inputs(n, batch))
        if not all(math.isfinite(r[2]) and 0 < r[3] < r[2] for r in rows):
            raise PhaseError(f"megakernel_residue {tag}: a row below its bound or not timed")
        print(megakernel_residue.table(f"{tag}: {n} tokens, batch {batch}, hidden 480, 6 heads, "
                                       f"MLP 1920, R {megakernel_residue.R}", rows, card),
              flush=True)


def _k4_ops(bins):
    """f32 operations per scalar of the binned-RQS inverse, counting a
    softplus (max, abs, exp, log1p, add, negate) as 6 and every other
    arithmetic, comparison, select and transcendental as 1: the constrain
    (2 * bins softplus widths/heights with shift and minimum, bins - 1
    derivatives, 2 * bins knot sums, edges, scale, shift), the searchsorted
    and the one-hot selection of the bin, and the bin solve (Citardauq root,
    two Newton steps, log-derivative)."""
    constrain = 2 * bins * 8 + (bins - 1) * 7 + 2 * bins + 9
    search = 3 * (bins + 1) + 6 * (bins - 1) + 6
    solve = 30 + 2 * 31 + 26
    return constrain + search + solve


def sm_clock_mhz():
    """The card's maximum SM clock in MHz, as nvidia-smi gives it."""
    return float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                 "--format=csv,noheader,nounits"], capture_output=True, text=True,
                                check=True).stdout.split()[0])


# the shipped cINNs' spline (cinn_ds{2,3}_electrons.yaml): bins, min_bin_sizes,
# domain, identity_tails, domain_clamping
K4_SPLINE = (10, (0.001, 0.001), (-8.0, 8.0, -8.0, 8.0), False, None)


def loop_body(ins, marker):
    """The instructions of the outermost loop of a SASS listing of
    (address, instruction) pairs (``_cuda.sass_functions(...,
    addresses=True)``) that holds an instruction matching the regex
    ``marker``: from the target of a backward branch to the branch, each
    inner loop counted once."""
    mark = next(at for at, line in ins if re.search(marker, line))
    loops = [(int(m.group(1), 16), at) for at, line in ins
             for m in [re.search(r"\bBRA\b[^;]*?\b0x([0-9a-f]+)", line)]
             if m and int(m.group(1), 16) <= mark < at]
    lo, hi = min(loops, key=lambda loop: (loop[0], -loop[1]))
    return [line for at, line in ins if lo <= at <= hi]


def k4_issue(n, bins=10):
    """The issue-slot time of K4's shipped instantiation
    (``binned_rqs_inverse_kernel<bins, false, false>``: affine tails, no
    clamping) over n scalars, from its
    SASS: the instructions of the consumers' unit loop (the loop around
    their named barrier, ``bar.sync 1``, each inner loop counted once) for
    every consumer warp and unit, at one instruction per scheduler and
    cycle (4 a SM), and its MUFU (SFU) instructions at 16 lanes per SM and
    cycle, at the card's maximum SM clock. Returns (instructions a warp and
    unit, MUFU, issue ms, SFU ms, clock MHz, (registers, spill bytes) from
    the -Xptxas -v report where the build wrote it, else None)."""
    name = f"binned_rqs_inverse_kernelILi{bins}ELb0ELb0E"
    funcs = _cuda.sass_functions(_cuda._lib_path("binned_rqs"), addresses=True)
    ins = next(v for k, v in funcs.items() if name in k)
    body = loop_body(ins, r"^BAR\.SYNC\S* 0x1,")  # the consumers' bar.sync 1
    mufu = sum("MUFU." in i for i in body)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = sm_clock_mhz()
    warps = fsp.plan(1, n, 1).units * fsp.UNIT // 32
    issue = len(body) * warps / (4 * sms) / (mhz * 1e6) * 1e3
    sfu = mufu * 32 * warps / (16 * sms) / (mhz * 1e6) * 1e3
    log = (_cuda.BUILD_DIR / "binned_rqs.log").read_text()
    regs = re.search(name + r"\S*\s+(\d+) bytes stack frame, (\d+) bytes spill stores.*?Used (\d+) "
                     r"registers", log, re.S)
    return len(body), mufu, issue, sfu, mhz, (regs.group(3), regs.group(2)) if regs else None


def k4_kernel_phase(results, d, other_branch=True):
    """K4 against its plain version at a cINN sampling shape: y (BATCH, d)
    ~ 6 N(0, 1) and theta (BATCH, d, 31) ~ N(0, 1) (ds2 d = 3240, ds3
    20250), so that points fall in every bin and in both tails; x and the
    log-determinant are each held to TOL against their own scale and to
    K4_F64_TOL against an f64 run of the plain version, and two launches
    must agree bit for bit. Prints the bytes bound beside the issue-slot
    time its SASS gives (``k4_issue``). With ``other_branch``, then,
    untimed, the softmax branch (identity tails) with domain clamping at a
    small shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    b, spline = BATCH, K4_SPLINE
    bins = spline[0]
    y = _rand(gen, b, d, std=6.0)
    theta = _rand(gen, b, d, 3 * bins + 1)
    ker = lambda: fsp.fused_binned_rqs_inverse(y, theta, *spline)  # noqa: E731
    pla = lambda: fsp.inverse_plain(y, theta, *spline)  # noqa: E731
    out, ref = ker(), pla()
    nbytes = 4 * (y.numel() + theta.numel() + out[0].numel() + out[1].numel())
    bound = work_bound(nbytes, y.numel() * _k4_ops(bins), F32_FLOPS)
    _check("binned_rqs_inverse", out, ref, results, ker, pla, bound)
    again = ker()
    torch.cuda.synchronize()
    if not (torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])):
        raise PhaseError("binned_rqs_inverse: two launches on the same inputs differ")
    del ref
    ref64 = fsp.inverse_plain(y.double(), theta.double(), *spline)
    errs = [_rel_err(o, r) for o, r in zip(out, ref64)]
    del ref64
    n_ins, mufu, issue, sfu, mhz, regs = k4_issue(b * d, bins)
    print(f"  binned_rqs_inverse at ({b}, {d}): bytes bound {bound[0]:.4f} ms; SASS of "
          f"binned_rqs_inverse_kernel<{bins}, false, false>: {n_ins} instructions, {mufu} MUFU a "
          f"consumer warp and unit, so "
          f"{issue:.4f} ms of issue slots and {sfu:.4f} ms of SFU at {mhz:g} MHz (registers, "
          f"spill bytes: {regs}); against f64: "
          f"x {errs[0][0] / errs[0][1]:.3e}, logdet {errs[1][0] / errs[1][1]:.3e} of the scale "
          f"(bound {K4_F64_TOL:g})", flush=True)
    if not all(e <= K4_F64_TOL * sc for e, sc in errs):
        raise PhaseError(f"binned_rqs_inverse at ({b}, {d}) misses f64 by more than "
                         f"{K4_F64_TOL:g} of the scale")
    if not other_branch:
        return

    other = (bins, (0.001, 0.001), (-8.0, 8.0, -8.0, 8.0), True, 15.0)
    y2, theta2 = _rand(gen, 16, 1000, std=6.0), _rand(gen, 16, 1000, 3 * bins)
    _hold("binned_rqs_inverse", "identity tails and domain clamping 15, (16, 1000): x and "
          "logdet", fsp.fused_binned_rqs_inverse(y2, theta2, *other),
          fsp.inverse_plain(y2, theta2, *other))


def _binning_xml(path: Path, geometry: str):
    """45 layers of a geometry's alpha x radial bins (ds2: 16 x 9 = 6480
    voxels; ds3: 50 x 18 = 40500)."""
    n_alpha, r_edges = GEOMETRY[geometry]
    edges = ",".join(str(v) for v in r_edges)
    layers = [f'    <Layer id="{i}" r_edges="{edges}" n_bin_alpha="{n_alpha}"/>'
              for i in range(45)]
    path.write_text("\n".join(['<Bins>', '  <Particle name="electron">', *layers,
                               '  </Particle>', '</Bins>']))


def _voxels(geometry: str) -> int:
    n_alpha, r_edges = GEOMETRY[geometry]
    return 45 * n_alpha * (len(r_edges) - 1)


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


def _run_dirs(tmp: Path, geometry: str, shape_cfg: dict, energy_cfg: dict):
    """(shape transforms, energy transforms) on a geometry ("ds2" or
    "ds3") with synthetic statistics in the run dirs under ``tmp``."""
    data_dir, shape_dir, energy_dir = tmp / "data", tmp / "shape_run", tmp / "energy_run"
    for d in (data_dir, shape_dir, energy_dir):
        d.mkdir()
    _binning_xml(data_dir / f"binning_dataset_{geometry[-1]}.xml", geometry)
    rng = np.random.default_rng(SEED)
    np.save(shape_dir / "means.npy", np.float32(-9.0))
    np.save(shape_dir / "stds.npy", np.float32(4.0))
    np.save(energy_dir / "means_u.npy", rng.normal(0.0, 0.3, 45).astype(np.float32))
    np.save(energy_dir / "stds_u.npy", rng.uniform(0.8, 1.5, 45).astype(np.float32))
    return (_transforms(shape_cfg, data_dir, shape_dir),
            _transforms(energy_cfg, data_dir, energy_dir))


def _serve(generator, counters, voxels, requests=REQUESTS, batch=BATCH):
    """``requests`` requests of ``batch`` showers through ``sample_showers``,
    each checked (shape (batch, voxels), finite, non-negative); the counters
    are set to 0 just before and read just after. Returns (launches,
    seconds per request)."""
    for c in counters.values():
        c.reset()
    times, showers = [], None
    for i in range(requests):
        e_inc = 10 ** np.random.default_rng(SEED + 1 + i).uniform(3, 6, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        showers = generator.sample_showers(e_inc, seed=SEED + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = []
        if showers.shape != (batch, voxels):
            bad.append(f"shape {showers.shape}, expected {(batch, voxels)}")
        if not np.isfinite(showers).all():
            bad.append("non-finite values")
        if (showers < 0).any():
            bad.append(f"negative values (min {showers.min()})")
        if bad:
            raise PhaseError(f"request {i}: " + ", ".join(bad))
        print(f"  request {i}: {batch} showers in {times[-1]:.3f} s, total energy "
              f"{showers.sum(1).mean():.1f} MeV mean", flush=True)
    return {k: c.launches for k, c in counters.items()}, times


def _compare_generators(kern, plain, noise, counters, shower_tol=5e-2):
    """The kernel generator against the plain one on the same noise (its
    batch): u 1e-3 absolute, the shower in the training basis ``shower_tol``
    of its scale, layer energies in MeV 1e-3 relative. The plain generator
    must launch none of the ``counters``' kernels."""
    nb = noise[0].shape[0]
    e_inc = 10 ** np.random.default_rng(SEED).uniform(3, 6, nb)
    cond = kern.condition(e_inc)
    basis_k, full_k = kern.generate(cond, noise=noise)
    before = {k: c.launches for k, c in counters.items()}
    basis_p, full_p = plain.generate(cond, noise=noise)
    if {k: c.launches for k, c in counters.items()} != before:
        raise PhaseError("the plain reference generator launched a kernel")
    u_err = (full_k - full_p).abs().max().item()
    s_err, s_scale = _rel_err(basis_k, basis_p)
    mev_k = kern.sample_showers(e_inc, noise=noise)
    mev_p = plain.sample_showers(e_inc, noise=noise)
    layer_k, layer_p = (m.reshape(nb, 45, -1).sum(-1) for m in (mev_k, mev_p))
    layer_rel = float(np.abs(layer_k - layer_p).max() / max(1e-30, np.abs(layer_p).max()))
    print(f"  reference (batch {nb}, composed plain nets, same noise): u max_abs_err "
          f"{u_err:.3e}, shower max_abs_err {s_err:.3e} (bound {shower_tol:g} x scale "
          f"{s_scale:.3g}), layer-energy max rel err {layer_rel:.3e}", flush=True)
    if not (u_err <= 1e-3 and s_err <= shower_tol * s_scale and layer_rel <= 1e-3):
        raise PhaseError("kernel generator disagrees with the composed plain generator")


def _models(shape_cfg, energy_cfg, seed):
    """The shape and energy models on the card in eval mode, with random
    weights from ``seed`` (final layers included, so that nothing is 0)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape_model = instantiate(shape_cfg).cuda().eval()
    energy_model = instantiate(energy_cfg).cuda().eval()
    _randomize(shape_model, gen)
    _randomize(energy_model, gen)
    return shape_model, energy_model, gen


def cfm_phase(tmp: Path, geometry, shape_cfg, energy_cfg, shape_tf_cfg, energy_tf_cfg,
              requests=REQUESTS, counters=SERVING, per_eval=CFM_PER_EVAL, batch=BATCH,
              reference=(REFERENCE_BATCH, None, 5e-2)):
    """A CFM shape model (ds2, ds3, or ds2 with ``causal_attn``; or ds3
    composed with an opt-in kernel; or ds3_long) behind its energy model at
    full width: ``requests`` requests of ``batch`` with every kernel of
    ``counters`` counted on every net eval (``per_eval`` launches each, 0
    where absent), then the composed plain generator (plain attention,
    masked where the model is: ``auto`` would launch K1 from 128 tokens; no
    fused MLP) on the same noise. ``reference`` = (its batch, an RK4 step
    size for both shape models there or None for the model's, the shower
    bound). Energy stage: f32 kernel vs f32 composed -> u and layer energies
    agree to ~1e-4; shape stage: bf16 multiplicands over 80 evals -> 5e-2 of
    scale."""
    shape_tf, energy_tf = _run_dirs(tmp, geometry, shape_tf_cfg, energy_tf_cfg)
    shape_model, energy_model, gen = _models(shape_cfg, energy_cfg, SEED)
    evals = shape_model.net_evals_per_sample()
    print(f"  shape model {shape_model.param_count()} params ({shape_model.token_shape(1)[1:]} "
          f"tokens x patch, causal_attn {shape_model.net.cfg.causal_attn}), energy model "
          f"{energy_model.param_count()} params, {evals} net evals per model per request",
          flush=True)
    generator = Generator(shape_model, energy_model, energy_tf, shape_tf, batch=batch)
    launches, times = _serve(generator, counters, _voxels(geometry), requests, batch)
    for k in counters:
        per = per_eval.get(k, 0)
        want = requests * evals * per
        if launches[k] != want:
            raise PhaseError(f"{k}: {launches[k]} launches on the main path, expected {want} "
                             f"({per} per net eval, {evals} evals, {requests} requests)")
    launches = {k: v for k, v in launches.items() if v}
    print(f"  launches on the main path: {launches}", flush=True)

    nb, step, shower_tol = reference
    ref_cfg, kern_shape = shape_cfg, shape_model
    if step is not None:
        ref_cfg = dict(shape_cfg, odeint_kwargs={"method": "rk4", "options": {"step_size": step}})
        kern_shape = instantiate(ref_cfg).cuda().eval()
        kern_shape.load_state_dict(shape_model.state_dict())
    plain_shape = instantiate(_with_net_param(ref_cfg, fused_block=False, attn_impl="xla",
                                              fused_mlp=False)).cuda().eval()
    plain_energy = instantiate(_with_net_param(energy_cfg, fused_block=False)).cuda().eval()
    plain_shape.load_state_dict(shape_model.state_dict())
    plain_energy.load_state_dict(energy_model.state_dict())
    noise = (torch.randn(nb, 45, generator=gen, device="cuda"),
             torch.randn(shape_model.token_shape(nb), generator=gen, device="cuda"))
    _compare_generators(Generator(kern_shape, energy_model, energy_tf, shape_tf, batch=nb),
                        Generator(plain_shape, plain_energy, energy_tf, shape_tf, batch=nb),
                        noise, COMPOSED, shower_tol)
    return launches, times, generator


def cinn_phase(tmp: Path, geometry, shape_cfg, energy_cfg, shape_tf_cfg, energy_tf_cfg):
    """A cINN shape model (ds2: 20 coupling blocks, 40 ViT1D subnets of 135
    tokens; ds3: 10 and 20 of 225) behind its energy model at full width:
    REQUESTS requests with CINN_PER_REQUEST launches each, then the composed
    plain generator (plain spline, plain attention, plain energy decoder;
    all f32, so the chain tolerances hold with margin) on the same noise."""
    shape_tf, energy_tf = _run_dirs(tmp, geometry, shape_tf_cfg, energy_tf_cfg)
    shape_model, energy_model, gen = _models(shape_cfg, energy_cfg, SEED + 5)
    print(f"  cINN shape model {shape_model.param_count()} params ({shape_cfg['nblocks']} "
          f"coupling blocks, {2 * shape_cfg['nblocks']} ViT1D subnets), energy model "
          f"{energy_model.param_count()} params", flush=True)
    generator = Generator(shape_model, energy_model, energy_tf, shape_tf, batch=BATCH)
    launches, times = _serve(generator, CINN, _voxels(geometry))
    per_request = CINN_PER_REQUEST[geometry]
    want = {k: REQUESTS * per for k, per in per_request.items()}
    if launches != want:
        raise PhaseError(f"cinn: launches {launches} on the main path, expected {want} "
                         f"({per_request} per request, {REQUESTS} requests)")
    print(f"  launches on the main path: {launches}", flush=True)

    plain_cfg = dict(shape_cfg,
                     cinn_kwargs=dict(shape_cfg["cinn_kwargs"], fused_spline=False),
                     vit_kwargs=dict(shape_cfg["vit_kwargs"], attn_impl="xla"))
    plain_shape = instantiate(plain_cfg).cuda().eval()
    plain_energy = instantiate(_with_net_param(energy_cfg, fused_block=False)).cuda().eval()
    plain_shape.load_state_dict(shape_model.state_dict())
    plain_energy.load_state_dict(energy_model.state_dict())
    nb = REFERENCE_BATCH
    noise = (torch.randn(nb, 45, generator=gen, device="cuda"),
             torch.randn(shape_model.x_shape(nb), generator=gen, device="cuda"))
    _compare_generators(Generator(shape_model, energy_model, energy_tf, shape_tf, batch=nb),
                        Generator(plain_shape, plain_energy, energy_tf, shape_tf, batch=nb),
                        noise, CINN)
    del plain_shape, plain_energy
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


def _is_k1_fwd(key):
    return "qkv_fwd_tf32_kernel<" in key


def _is_k1_bwd(key):
    """K1's backward: its delta kernel and its two TF32 passes."""
    return "::bwd_d" in key or "qkv_bwd_d" in key


def _is_k3(key):
    """K3: its tensor-core kernel and its f32 one (other widths)."""
    return "energy_decoder_tf32_kernel" in key or "energy_decoder_kernel" in key


def _is_gemm(key):
    key = key.lower()
    return "gemm" in key or "cutlass" in key or "xmma" in key


# device-time groups of a CFM and of a cINN request: (label, does a kernel
# name belong)
CFM_GROUPS = [
    ("K2v gemm_wgmma_kernel", lambda k: "gemm_wgmma_kernel<" in k),
    ("K2v attention", lambda k: "vit_attn_wgmma_kernel<" in k),
    ("K2v modln_kernel", lambda k: "modln_kernel" in k),
    ("K3 energy_decoder", _is_k3),
    ("cuBLAS products", _is_gemm),
]
CINN_GROUPS = [
    ("K4 binned_rqs_inverse", lambda k: "binned_rqs_inverse_kernel<" in k),
    ("K1 forward", _is_k1_fwd),
    ("K3 energy_decoder", _is_k3),
    ("cuBLAS products", _is_gemm),
]


def _grouped(rows, groups):
    """Device ms per group, the first group that claims a kernel taking it;
    the rest (elementwise, LayerNorm, reductions, copies) under 'rest'."""
    sums = {label: 0.0 for label, _ in groups}
    sums["rest"] = 0.0
    for ms, _, key in rows:
        label = next((lb for lb, claims in groups if claims(key)), "rest")
        sums[label] += ms
    return sums


def profile_phase(generator, card, top=15, groups=None):
    """One more request of BATCH showers, measured by layer: the energy
    stage (energy ODE), the chain (+ u map + shape stage) and the whole
    request (+ host transforms) on the host clock; then the request under
    torch.profiler: device time per kernel (and per group of ``groups``)
    and the device's idle share of the request's wall time (one stream, so
    idle = 1 - kernel time / wall)."""
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
    if groups:
        print("  " + ", ".join(f"{k} {v:.3f} ms" for k, v in _grouped(rows, groups).items()),
              flush=True)
    for ms, count, key in rows[:top]:
        print(f"  {ms:10.2f} ms {count:6d}x  {key[:100]}", flush=True)
    rest = rows[top:]
    print(f"  {sum(r[0] for r in rest):10.2f} ms {sum(r[1] for r in rest):6d}x  "
          f"({len(rest)} other device entries)", flush=True)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _synthetic_showers(n_events, seed, geometry="ds2"):
    """(E_inc (N, 1), showers (N, voxels) in MeV, layer boundaries) on a
    geometry (ds2: 6480 voxels, ds3: 40500): sparse exponential voxel
    energies summing to 0.5-0.9 of E_inc, with a longitudinal profile
    peaking in the first third of the layers."""
    n_alpha, r_edges = GEOMETRY[geometry]
    per_layer = n_alpha * (len(r_edges) - 1)
    rng = np.random.default_rng(seed)
    e_inc = (10 ** rng.uniform(3, 6, (n_events, 1))).astype(np.float32)
    profile = np.exp(-0.5 * ((np.arange(45) - 12) / 8.0) ** 2)
    shape = (n_events, 45, per_layer)
    vox = rng.exponential(1.0, shape) * (rng.random(shape) > 0.5)
    vox *= profile[None, :, None]
    vox /= vox.sum((1, 2), keepdims=True)
    showers = (vox.reshape(n_events, 45 * per_layer) * e_inc
               * rng.uniform(0.5, 0.9, (n_events, 1)))
    return e_inc, showers.astype(np.float32), np.arange(0, 45 * per_layer + 1, per_layer)


class SyntheticCaloChallenge(CaloChallenge):
    """The port's CaloChallenge experiment with synthetic MeV showers on the
    ds2 geometry in place of the training file (the card's machine has no
    h5py and no dataset)."""

    geometry, n_events = "ds2", N_EVENTS

    def load_showers(self):
        return _synthetic_showers(self.n_events, SEED, self.geometry)


class SyntheticCaloChallengeDS3(SyntheticCaloChallenge):
    """The same on the ds3 geometry (40500 voxels)."""

    geometry, n_events = "ds3", N_EVENTS_DS3


def _experiment_config(tmp: Path, model, transforms, training, model_type, train_val_frac,
                       geometry="ds2"):
    """The composed calochallenge_ds2(_energy) config (or ds3's, with its
    model and transforms) with the run dir under ``tmp`` and the binning XML
    in ``tmp/data``."""
    ds = geometry[-1]
    return Config({
        "exp_name": f"smoke_{model_type}", "exp_type": "calochallenge", "run_name": "run",
        "base_dir": str(tmp), "data_dir": str(tmp / "data"), "seed": SEED, "debug": False,
        "warm_start_idx": None, "save": True, "use_mlflow": True, "save_source": False,
        "ema": False, "train": True, "evaluate": False, "plot": False,
        "plotting": {"loss": False}, "dtype": "float32", "model_type": model_type,
        "model": model, "training": training,
        "data": {"training_file": f"${{data_dir}}/dataset_{ds}_1.hdf5",
                 "test_file": f"${{data_dir}}/dataset_{ds}_2.hdf5", "particle_type": "electron",
                 "xml_filename": f"${{data_dir}}/binning_dataset_{ds}.xml",
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


def train_parity_phase(exp, causal=False):
    """TRAIN_PARITY_STEPS steps from one state with K1 (attn_impl auto) and
    with the plain attention (xla), on the same batches and (t, x_0); with
    ``causal`` the layer-causal ViT, whose mask runs through K1's masked
    forward and backward. K1's counters are set to 0 just before and read
    just after: each kernel must have run on every block of every step.
    Returns (worst errors, K1 launches)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    models, states, steps = {}, {}, {}
    init = None
    for impl in ("auto", "xla"):
        torch.manual_seed(SEED)
        model = instantiate(_with_net_param(DS2_SHAPE_MODEL, attn_impl=impl,
                                            causal_attn=causal)).cuda()
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
    for c in TRAINING.values():
        c.reset()
    for i in range(TRAIN_PARITY_STEPS):
        sl = slice(64 * i, 64 * (i + 1))
        x = torch.as_tensor(layers[sl], device="cuda")
        c = torch.as_tensor(energy[sl], device="cuda")
        t = torch.rand((64, 1, 1, 1, 1), generator=gen, device="cuda")
        x_0 = torch.randn(x.shape, generator=gen, device="cuda")
        m = {impl: steps[impl](states[impl], (x, c, t, x_0)) for impl in steps}
        rel = abs(float(m["auto"]["loss"]) - float(m["xla"]["loss"])) / abs(float(m["xla"]["loss"]))
        worst["loss"] = max(worst["loss"], rel)
    launches = {k: c.launches for k, c in TRAINING.items()}
    if launches != {k: 6 * TRAIN_PARITY_STEPS for k in TRAINING}:
        raise PhaseError(f"train parity: K1 launches {launches}, expected 6 blocks x "
                         f"{TRAIN_PARITY_STEPS} steps of each kernel")
    pk, pp = (dict(models[i].named_parameters()) for i in ("auto", "xla"))
    worst["param_abs"] = max((pk[n] - pp[n]).abs().max().item() for n in pp)
    du = torch.cat([(pk[n] - init[n]).flatten() for n in pp])
    dp = torch.cat([(pp[n] - init[n]).flatten() for n in pp])
    worst["update_rel"] = ((du - dp).norm() / dp.norm()).item()
    ok = all(worst[k] <= TRAIN_TOL[k] for k in TRAIN_TOL)
    print(f"  {TRAIN_PARITY_STEPS} steps, K1 vs plain attention{' (masked)' if causal else ''}: "
          f"K1 launches {launches}, loss rel {worst['loss']:.3e}, "
          f"param max abs {worst['param_abs']:.3e}, update rel {worst['update_rel']:.3e} "
          f"(bounds {TRAIN_TOL}) {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise PhaseError("train parity: K1 training disagrees with the plain attention")
    return worst, launches


def fused_train_phase(tmp: Path, card, composed):
    """The ds2 shape model with ``fused_block: true`` trained TRAIN_STEPS
    steps through the experiment (the megakernel tier: K5a forward, K5b
    backward per block; K2v on the validation batches), its launches
    counted exactly; steps/s beside the composed path's (``composed``, the
    ds2_train experiment of this run). Returns (launches, the experiment)."""
    training = dict(DS2_SHAPE_TRAINING, iterations=TRAIN_STEPS,
                    validate_every_n_steps=VALIDATE_EVERY)
    cfg = _experiment_config(tmp, _with_net_param(DS2_SHAPE_MODEL, fused_block=True),
                             DS2_SHAPE_TRANSFORMS, training, "shape", [0.99, 0.01])
    cfg.exp_name = "smoke_shape_fused"
    exp = SyntheticCaloChallenge(cfg, device="cuda")
    for c in FUSED_TRAINING.values():
        c.reset()
    exp()
    launches = {k: c.launches for k, c in FUSED_TRAINING.items()}
    _check_training(exp, "fused train")
    steps = len(exp.train_loss)
    val_batches = len(exp.val_loss) * exp._val_iterator.batches_per_epoch
    want = fused_launches("true", steps, val_batches)
    if steps != TRAIN_STEPS or launches != want:
        raise PhaseError(f"fused train: {steps} steps, launches {launches}, expected {want}")
    print(f"  {steps} steps, {len(exp.val_loss)} validations ({val_batches} batches): loss "
          f"{exp.train_loss[0]:.4f} -> {exp.train_loss[-1]:.4f}, val {exp.val_loss}", flush=True)
    print(f"  launches on the main path: { {k: v for k, v in launches.items() if v} }",
          flush=True)
    rate = lambda e: (len(e.train_loss) / e.train_seconds,  # noqa: E731
                      len(e.step_times[2:]) / sum(e.step_times[2:]))
    (f_loop, f_step), (c_loop, c_step) = rate(exp), rate(composed)
    print(f"fused train: {f_loop:.3f} steps/s over the whole train() loop, {f_step:.3f} steady "
          f"step interior (steps 3-{steps}); composed path (ds2_train, this run): {c_loop:.3f} / "
          f"{c_step:.3f}; batch {int(cfg.training.batchsize)}; on {card}", flush=True)
    return {k: v for k, v in launches.items() if v}, exp


# the composed ds3 paths through the block's opt-in kernels: (path stem,
# label, the setting of composed_launches, the net.param overrides)
DS3_SETTINGS = [
    ("ds3", "attn_impl: auto (K1)", "auto", {}),
    ("ds3_vmem", "attn_impl: vmem (K8)", "vmem", {"attn_impl": "vmem"}),
    ("ds3_flash", "attn_impl: flash (K6)", "flash", {"attn_impl": "flash"}),
    ("ds3_mlp", "fused_mlp: true (K9; attn_impl: auto, K1)", "fused_mlp", {"fused_mlp": True}),
]


def ds3_train_phase(tmp: Path, card, path, label, setting, param, model=DS3_SHAPE_MODEL,
                    steps=TRAIN_STEPS, validate_every=VALIDATE_EVERY, batch=64):
    """The ds3 shape model (cfm_ds3_electrons at full width, composed:
    ``fused_block: false``, with ``param``; or ``model``, ds3_long) trained
    ``steps`` steps at ``batch``, validating every ``validate_every``,
    through the experiment on synthetic ds3 showers, every launch counted
    exactly (``composed_launches``), then one step profiled. Returns
    (launches, (steps/s over the whole train() loop, steady step
    interior))."""
    training = dict(DS2_SHAPE_TRAINING, iterations=steps, batchsize=batch,
                    validate_every_n_steps=validate_every)
    cfg = _experiment_config(tmp, _with_net_param(model, fused_block=False, **param),
                             DS3_SHAPE_TRANSFORMS, training, "shape", [0.99, 0.01], "ds3")
    cfg.exp_name = f"smoke_{path}"
    exp = SyntheticCaloChallengeDS3(cfg, device="cuda")
    for c in COMPOSED.values():
        c.reset()
    exp()
    launches = {k: c.launches for k, c in COMPOSED.items()}
    _check_training(exp, path)
    done = len(exp.train_loss)
    val_batches = len(exp.val_loss) * exp._val_iterator.batches_per_epoch
    want = composed_launches(setting, done, val_batches)
    if done != steps or launches != want:
        raise PhaseError(f"{path}: {done} steps, launches {launches}, expected {want}")
    steady = exp.step_times[2:]
    rate = (steps / exp.train_seconds, len(steady) / sum(steady))
    launches = {k: v for k, v in launches.items() if v}
    print(f"  {steps} steps, {len(exp.val_loss)} validations ({val_batches} batches): loss "
          f"{exp.train_loss[0]:.4f} -> {exp.train_loss[-1]:.4f}, val {exp.val_loss}", flush=True)
    print(f"  launches on the main path: {launches}", flush=True)
    print(f"{path}: {label}: {rate[0]:.4f} steps/s over the whole train() loop, {rate[1]:.4f} "
          f"steady step interior (steps 3-{steps}); batch {int(cfg.training.batchsize)}; on "
          f"{card}", flush=True)
    print(f"{path} profile: one train step", flush=True)
    train_profile_phase(exp, card, groups=DS3_TRAIN_GROUPS)
    return launches, rate


# the opt-in kernels' parity paths against attn_impl xla, fused_mlp false at
# ds3, batch 64: (path, label, net.param overrides, setting)
DS3_PARITY = [
    ("ds3_vmem_parity", "ds3, attn_impl: vmem", {"attn_impl": "vmem"}, "vmem"),
    ("ds3_flash_parity", "ds3, attn_impl: flash", {"attn_impl": "flash"}, "flash"),
    ("ds3_mlp_parity", "ds3, fused_mlp: true", {"fused_mlp": True}, "fused_mlp"),
    ("ds3_vmem_causal_parity", "ds3, attn_impl: vmem, causal_attn: true",
     {"attn_impl": "vmem", "causal_attn": True}, "vmem"),
]
# the composed ds3 serving paths (fused_block: false): (path, label, net.param
# overrides, launches per net eval)
DS3_SERVING = [
    ("ds3_vmem_cfm", "attn_impl: vmem (K8)", {"attn_impl": "vmem"},
     {"energy_decoder": 1, "vmem_attn_fwd": 6}),
    ("ds3_flash_cfm", "attn_impl: flash (K6)", {"attn_impl": "flash"},
     {"energy_decoder": 1, "flash_qkv_fwd": 6}),
    ("ds3_mlp_cfm", "fused_mlp: true (K9; K1 attention)", {"fused_mlp": True},
     {"energy_decoder": 1, "qkv_attn_fwd": 6, "mlp_modln": 6, "mlp_gemm": 12}),
]


# the fused-vs-composed parity paths: (path, label, model config, batch,
# the launch variant of fused_launches)
FUSED_PARITY = [
    ("fused_true", "fused_block: true", _with_net_param(DS2_SHAPE_MODEL, fused_block=True), 64,
     "true"),
    ("fused_hybrid", "fused_block: hybrid",
     _with_net_param(DS2_SHAPE_MODEL, fused_block="hybrid"), 64, "hybrid"),
    ("fused_nostack", "fused_block: true, fused_stack: false",
     _with_net_param(DS2_SHAPE_MODEL, fused_block=True, fused_stack=False), 64, "nostack"),
    ("fused_causal", "fused_block: true, causal_attn: true",
     _with_net_param(DS2_SHAPE_MODEL, fused_block=True, causal_attn=True), 64, "true"),
    ("fused_ds3", "ds3, fused_block: true (a1 recomputed)",
     _with_net_param(DS3_SHAPE_MODEL, fused_block=True), 16, "noa1"),
]


def fused_parity_phase(label, cfg, batch, variant):
    """The fused net against the composed one (``fused_block: false``, K1's
    attention) from one state (``parity_phase``), every launch of the fused
    steps counted (``fused_launches``)."""
    return parity_phase(label, cfg, _with_net_param(cfg, fused_block=False), batch,
                        FUSED_TRAINING, fused_launches(variant, TRAIN_PARITY_STEPS, 0))


def parity_phase(label, cfg, ref_cfg, batch, counters, want, tol=FUSED_TRAIN_TOL):
    """The net of ``cfg`` against the one of ``ref_cfg`` from one state: per
    parameter tensor the relative L2 of the gradients of one batch, then
    TRAIN_PARITY_STEPS train steps of each on the same random batches and
    draws (x ~ N(0, 1), c ~ U(0, 1)), held to ``tol``. The first net's steps
    must launch ``want`` of each of ``counters``. Returns (worst errors,
    launches)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    fused = instantiate(cfg).cuda()
    _randomize(fused, gen)
    composed = instantiate(ref_cfg).cuda()
    composed.load_state_dict(fused.state_dict())
    init = {k: v.clone() for k, v in fused.state_dict().items()}
    shape = (batch, cfg["in_channels"], *cfg["shape"])
    cdim = cfg["net"]["param"]["condition_dim"]
    draws = [(torch.randn(shape, generator=gen, device="cuda"),
              torch.rand((batch, cdim), generator=gen, device="cuda"),
              torch.rand((batch, 1, 1, 1, 1), generator=gen, device="cuda"),
              torch.randn(shape, generator=gen, device="cuda"))
             for _ in range(TRAIN_PARITY_STEPS)]
    loss = lambda model, d: model.batch_loss(d[0], d[1], t=d[2], x_0=d[3])  # noqa: E731
    gf, gc = (torch.autograd.grad(loss(m, draws[0]), list(m.parameters()))
              for m in (fused, composed))
    names = [n for n, _ in fused.named_parameters()]
    rel = {n: ((a - b).norm() / b.norm()).item() for n, a, b in zip(names, gf, gc)
           if b.norm() > 0}
    worst = {"grad_rel_l2": max(rel.values()), "loss": 0.0, "grad_norm": 0.0}
    worst_name = max(rel, key=rel.get)
    del gf, gc
    states = {k: ts.create_train_state(m, Config(DS2_SHAPE_TRAINING), use_ema=False)
              for k, m in (("fused", fused), ("composed", composed))}
    steps = {k: ts.make_train_step(lambda *d, m=m: loss(m, d),
                                   clip_grad_norm=DS2_SHAPE_TRAINING["clip_grad_norm"])
             for k, m in (("fused", fused), ("composed", composed))}
    counts = dict.fromkeys(counters, 0)
    for d in draws:
        before = {k: c.launches for k, c in counters.items()}
        mf = steps["fused"](states["fused"], d)
        counts = {k: counts[k] + c.launches - before[k] for k, c in counters.items()}
        mc = steps["composed"](states["composed"], d)
        for key in ("loss", "grad_norm"):
            worst[key] = max(worst[key], abs(float(mf[key]) - float(mc[key])) / abs(float(mc[key])))
        if mf["skipped"] or mc["skipped"]:
            raise PhaseError(f"parity ({label}): a step was skipped")
    if counts != want:
        raise PhaseError(f"parity ({label}): launches {counts}, expected {want}")
    pf, pc = (dict(m.named_parameters()) for m in (fused, composed))
    du = torch.cat([(pf[n] - init[n]).flatten() for n in pc])
    dc = torch.cat([(pc[n] - init[n]).flatten() for n in pc])
    worst["update_rel"] = ((du - dc).norm() / dc.norm()).item()
    ok = all(worst[k] <= tol[k] for k in tol)
    print(f"  {label}, batch {batch}: gradient rel L2 worst {worst['grad_rel_l2']:.3e} "
          f"({worst_name}), median {float(np.median(list(rel.values()))):.3e}; "
          f"{TRAIN_PARITY_STEPS} steps: loss rel {worst['loss']:.3e}, grad_norm rel "
          f"{worst['grad_norm']:.3e}, update rel {worst['update_rel']:.3e} (bounds "
          f"{tol}) {'ok' if ok else 'FAILED'}", flush=True)
    print(f"  launches: { {k: v for k, v in counts.items() if v} }", flush=True)
    if not ok:
        raise PhaseError(f"parity ({label}): training disagrees with the reference path")
    return worst, {k: v for k, v in counts.items() if v}


# device-time groups of a fused train step
FUSED_TRAIN_GROUPS = [
    ("K5a gemm_wgmma_kernel", lambda k: "gemm_wgmma_kernel<" in k),
    ("K5b gemm_nt", lambda k: "nt_wgmma_kernel<" in k),
    ("K5b gemm_tn", lambda k: "tn_wgmma_kernel" in k),
    ("K5b reductions", lambda k: "wgrad_reduce_kernel" in k or "dmod_reduce_kernel" in k),
    ("K5b bwd_rows", lambda k: "bwd_rows_kernel" in k),
    ("modln", lambda k: "modln_kernel" in k),
    ("K1 forward", _is_k1_fwd),
    ("K1 backward", _is_k1_bwd),
    ("cuBLAS products", _is_gemm),
]


# device-time groups of a composed ds3 train step (K8's and K6's kernels
# live in namespace aw, K6's backward named flash_bwd_*; K1's forward in tf,
# its backward in an anonymous namespace; K7's in k7, named k7_*)
DS3_TRAIN_GROUPS = [
    ("K7 pre-pass", lambda k: "k7_split_kernel" in k),
    ("K7 forward", lambda k: "k7_fwd_kernel" in k),
    ("K7 backward", lambda k: "k7_bwd_d" in k),
    ("K8 forward", lambda k: "vmem_fwd_wgmma_kernel" in k),
    ("K8 backward", lambda k: "vmem_bwd_dq_wgmma_kernel" in k
     or "vmem_bwd_dkv_wgmma_kernel" in k),
    ("K6 forward", lambda k: "flash_fwd_wgmma_kernel" in k),
    ("K6 backward", lambda k: "flash_bwd_d" in k),
    ("K1 forward", _is_k1_fwd),
    ("K1 backward", _is_k1_bwd),
    ("K9 gemm_wgmma_kernel", lambda k: "gemm_wgmma_kernel<" in k),
    ("K9 modln_kernel", lambda k: "modln_kernel" in k),
    ("cuBLAS products", _is_gemm),
]


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


def train_profile_phase(exp, card, top=12, groups=None):
    """One train step of the trained experiment under torch.profiler:
    device ms by group (default: K1's kernels, the cuBLAS products; then
    the rest), and the step's idle share."""
    from torch.profiler import ProfilerActivity, profile

    batch = exp._batch(next(exp.train_iterator))
    exp._train_step(exp.state, batch)  # warm
    step_s = _clock(lambda: exp._train_step(exp.state, batch))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = _clock(lambda: exp._train_step(exp.state, batch))
    rows = _device_rows(prof)
    groups = _grouped(rows, groups or [("K1 forward", _is_k1_fwd),
                                       ("K1 backward", _is_k1_bwd),
                                       ("cuBLAS products", _is_gemm)])
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
    card = card_name()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    t0 = time.perf_counter()
    compiled = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({compiled or 'all current'})", flush=True)

    # kernel results by shape group; "main" holds each kernel's first shape
    groups = {g: {} for g in SHAPE_GROUPS}
    print("kernels vs plain versions (ds2 sampling shapes, batch 256):", flush=True)
    k3_kernel_phase(groups["main"])
    k2v_kernel_phase(groups["main"], *VIT_TOKENS["ds2"])
    print("K1 vs plain, ds2 training shape: qkv (64, 135, 1440) f32, 6 heads x 80", flush=True)
    k1_ms = {"ds2 training shape": k1_kernel_phase(groups["main"], 64, 135)}
    print("K1 vs plain, ds3 token count: qkv (16, 450, 1440) f32, 6 heads x 80", flush=True)
    k1_ms["N=450"] = k1_kernel_phase(groups["n450"], 16, 450)
    print("K4 vs plain, ds2 cINN sampling shape: y (256, 3240), theta (256, 3240, 31) f32",
          flush=True)
    k4_kernel_phase(groups["main"], 3240)
    print("K1 forward vs plain, ds2 cINN subnet shape: qkv (256, 135, 576) f32, 4 heads x 48",
          flush=True)
    k1_fwd_phase(groups["cinn"], BATCH, 135, 4, 48)
    print("K2v vs plain versions, ds3 sampling shapes: tokens (256, 450, 90), qkv (256, 450, "
          "1440), unmasked", flush=True)
    k2v_kernel_phase(groups["ds3"], *VIT_TOKENS["ds3"])
    print("K1 forward vs plain, ds3 cINN subnet shape: qkv (256, 225, 576) f32, 4 heads x 48",
          flush=True)
    k1_fwd_phase(groups["ds3"], BATCH, 225, 4, 48)
    print("K4 vs plain, ds3 cINN sampling shape: y (256, 20250), theta (256, 20250, 31) f32",
          flush=True)
    k4_kernel_phase(groups["ds3"], 20250, other_branch=False)
    mask = _causal_mask((15, 1, 9))
    print("K2v attention and forward vs plain, ds2 with the layer-causal mask of (15, 1, 9)",
          flush=True)
    k2v_kernel_phase(groups["causal"], 135, 48, mask=mask, gemms=False)
    print("K1 vs plain, ds2 training shape with the layer-causal mask of (15, 1, 9)", flush=True)
    k1_ms["ds2 training shape, masked"] = k1_kernel_phase(groups["causal"], 64, 135, mask=mask)
    print("K5 tier vs plain, ds2 training shape: x (64, 135, 480), 6 heads x 80, F 1920: the "
          "training GEMM epilogues, NT and split-K TN products, row passes, K5b (a1 saved), K2b, "
          "K5c, K5a", flush=True)
    k5_kernel_phase(groups["main"], 64, 135)
    print("K5b without a1, ds2 training shape", flush=True)
    k5_kernel_phase(groups["noa1"], 64, 135, primitives=False, save_a1=False, composites=False)
    print("K5b without a1, N = 450: x (16, 450, 480)", flush=True)
    k5_kernel_phase(groups["n450"], 16, 450, primitives=False, save_a1=False, composites=False)
    print("K5b (a1 saved, and without), K2b, K5c, K5a with the layer-causal mask of (15, 1, 9)",
          flush=True)
    k5_kernel_phase(groups["causal"], 64, 135, mask=mask, primitives=False)
    k5_kernel_phase(groups["causal_noa1"], 64, 135, mask=mask, primitives=False, save_a1=False,
                    composites=False)
    del mask
    mask3 = _causal_mask((15, 5, 6))
    for group, b, causal, label in K68_SHAPES:
        print(f"K6 (flash_qkv_attention) and K8 (vmem_attention) vs plain, {label}: qkv ({b}, "
              f"450, 1440) f32, 6 heads x 80", flush=True)
        k1_ms[f"K6/K8, {label}"] = k68_kernel_phase(groups[group], b, 450,
                                                    mask=mask3 if causal else None)
        torch.cuda.empty_cache()
    for group, b in (("main", 64), ("ds3_serve", BATCH)):
        print(f"K9 (fused_mlp_half) vs plain: x ({b}, 450, 480), F 1920", flush=True)
        k9_kernel_phase(groups[group], b, 450)
    print(f"K7 (flash_attention) vs plain, ds3_long serving shape: q/k/v "
          f"({DS3_LONG_SERVE_BATCH}, 6, 13500, 80) f32, strided views of the qkv panel",
          flush=True)
    k1_ms["K7, ds3_long serving shape"] = k7_kernel_phase(groups["main"], DS3_LONG_SERVE_BATCH,
                                                          13500)
    torch.cuda.empty_cache()
    print(f"K7 vs plain, ds3_long training shape: q/k/v ({DS3_LONG_TRAIN_BATCH}, 6, 13500, 80) "
          "f32, the plain versions one batch element at a time", flush=True)
    k1_ms["K7, ds3_long training shape"] = k7_kernel_phase(
        groups["ds3_long_train"], DS3_LONG_TRAIN_BATCH, 13500, chunk=1)
    torch.cuda.empty_cache()
    tail = torch.tril(torch.ones(300, 300, dtype=torch.bool, device="cuda"))
    tail[7] = False
    for group, b, n, m, label in (("ds3_train", 64, 450, None, "ds3 training shape"),
                                  ("ds3_causal", 64, 450, mask3,
                                   "ds3 training shape, layer-causal"),
                                  ("k7_tail", 8, 300, tail,
                                   "N = 300 (a tail tile), causal with row 7 wholly masked")):
        print(f"K7 vs plain, {label}: q/k/v ({b}, 6, {n}, 80)", flush=True)
        k1_ms[f"K7, {label}"] = k7_kernel_phase(groups[group], b, n, mask=m)
    del mask3, tail
    print("K7 forward vs f64, and the masked forwards of K7, K6 and K2v with an all-True mask "
          "vs their unmasked kernels, at every padded head dim 16-128", flush=True)
    masked_forms_phase()
    print("K2s and K5a-stack (fused_dit_stack) vs plain: x (256, 135, 480), depth 6, ungrouped "
          "and group 8; with the layer-causal mask of (15, 1, 9); x (64, 450, 480)", flush=True)
    stack_kernel_phase(groups["stack"], BATCH, 135, group=8)
    stack_kernel_phase(groups["stack_causal"], BATCH, 135, mask=_causal_mask((15, 1, 9)))
    stack_kernel_phase(groups["stack_ds3"], 64, 450)
    torch.cuda.empty_cache()
    print("fused_dit_stack gradients vs the composed f32 path", flush=True)
    stack_grad_phase()
    torch.cuda.empty_cache()
    failed = [f"{k} ({g})" for g, r in groups.items() for k, v in r.items() if not v["ok"]]
    if failed:
        raise PhaseError(f"kernels disagree with their plain versions: {failed}")
    for g, res in groups.items():
        for k, r in res.items():
            lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
            if "library_f32_ms" in r:
                lib += f" (SDPA f32 {r['library_f32_ms']:.4f} ms)"
            bound = "" if r["bound_ms"] == 0 else \
                f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            print(f"  {k} [{SHAPE_GROUPS[g]}]: {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms"
                  f"{lib}{bound} ({card})", flush=True)
    for label, ms in k1_ms.items():
        if "K1" in ms:
            print(f"  K1 forward + backward through autograd, {label}: K1 {ms['K1']:.4f} ms, "
                  f"plain {ms['plain']:.4f} ms, SDPA {ms['sdpa']:.4f} ms; K1's backward "
                  f"(delta + dK/dV + dQ) {ms['bwd']:.4f} ms against SDPA's backward alone "
                  f"{ms['sdpa_bwd']:.4f} ms ({ms['bwd'] / ms['sdpa_bwd']:.2f}x) ({card})",
                  flush=True)
        elif "K7" in ms:
            print(f"  forward + backward, {label}: K7 (autograd) {ms['K7']:.4f} ms, plain f32 "
                  f"{ms['plain']:.4f} ms, SDPA f32 (autograd) {ms['sdpa']:.4f} ms ({card})",
                  flush=True)
        else:
            print(f"  forward + backward through autograd, {label}: K6 {ms['K6']:.4f} ms, K8 "
                  f"{ms['K8']:.4f} ms, plain f32 {ms['plain']:.4f} ms, SDPA bf16 "
                  f"{ms['sdpa']:.4f} ms ({card})", flush=True)

    print("megakernel_residue (K10): the DiT block body by kernel", flush=True)
    residue_phase(card)

    # each path runs with the counters set to 0 just before and read just
    # after; launches[path] = {kernel: launches}
    launches = {}
    serving = [
        ("ds2_cfm", "ds2 CFM", cfm_phase, "ds2", DS2_SHAPE_MODEL, DS2_ENERGY_MODEL,
         DS2_SHAPE_TRANSFORMS, DS2_ENERGY_TRANSFORMS, CFM_GROUPS),
        ("ds2_cinn", "ds2 cINN", cinn_phase, "ds2", DS2_CINN_MODEL, DS2_ENERGY_MODEL,
         DS2_CINN_TRANSFORMS, DS2_ENERGY_TRANSFORMS, CINN_GROUPS),
        ("ds3_cfm", "ds3 CFM", cfm_phase, "ds3", DS3_SHAPE_MODEL, DS3_ENERGY_MODEL,
         DS3_SHAPE_TRANSFORMS, DS3_ENERGY_TRANSFORMS, CFM_GROUPS),
        ("ds3_cinn", "ds3 cINN", cinn_phase, "ds3", DS3_CINN_MODEL, DS3_ENERGY_MODEL,
         DS3_CINN_TRANSFORMS, DS3_ENERGY_TRANSFORMS, CINN_GROUPS),
        ("causal_cfm", "ds2 CFM, layer-causal ViT", cfm_phase, "ds2",
         _with_net_param(DS2_SHAPE_MODEL, causal_attn=True), DS2_ENERGY_MODEL,
         DS2_SHAPE_TRANSFORMS, DS2_ENERGY_TRANSFORMS, CFM_GROUPS),
    ]
    for path, label, phase, geometry, *cfgs, prof_groups in serving:
        with tempfile.TemporaryDirectory() as tmp:
            print(f"{path}: {label} two-stage generator at full width", flush=True)
            launches[path], times, generator = phase(Path(tmp), geometry, *cfgs)
            print(f"{path}: {BATCH * len(times) / sum(times):.2f} showers/s over all "
                  f"{len(times)} requests, {BATCH * (len(times) - 1) / sum(times[1:]):.2f} steady "
                  f"(first request excluded); batch {BATCH}, requests "
                  f"{[round(t, 4) for t in times]} s; on {card}", flush=True)
            print(f"{path} profile: one more request, by layer and by kernel", flush=True)
            profile_phase(generator, card, groups=prof_groups)
            del generator
            torch.cuda.empty_cache()
    for path, label, param, per_eval in DS3_SERVING:
        with tempfile.TemporaryDirectory() as tmp:
            print(f"{path}: ds3 CFM two-stage generator at full width, fused_block: false, "
                  f"{label}", flush=True)
            launches[path], times, generator = cfm_phase(
                Path(tmp), "ds3", _with_net_param(DS3_SHAPE_MODEL, fused_block=False, **param),
                DS3_ENERGY_MODEL, DS3_SHAPE_TRANSFORMS, DS3_ENERGY_TRANSFORMS, DS3_REQUESTS,
                COMPOSED, per_eval)
            print(f"{path}: {BATCH * len(times) / sum(times):.2f} showers/s over all "
                  f"{len(times)} requests, {BATCH * (len(times) - 1) / sum(times[1:]):.2f} steady "
                  f"(first request excluded); batch {BATCH}, requests "
                  f"{[round(t, 4) for t in times]} s; on {card}", flush=True)
            del generator
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        print(f"ds3_long_cfm: ds3_long (13,500 tokens of (3, 1, 1) patches, fused_block: false, "
              f"attn_impl auto: K7) two-stage generator, batch {DS3_LONG_SERVE_BATCH}", flush=True)
        # the reference: batch 1, 2 RK4 steps; f32 attention on both sides (K7
        # and the plain one), the rest the same composed code: the showers
        # differ by summation order only, 1e-3 of scale with margin
        launches["ds3_long_cfm"], times, generator = cfm_phase(
            Path(tmp), "ds3", DS3_LONG_MODEL, DS3_ENERGY_MODEL, DS3_SHAPE_TRANSFORMS,
            DS3_ENERGY_TRANSFORMS, DS3_REQUESTS, COMPOSED, DS3_LONG_PER_EVAL,
            DS3_LONG_SERVE_BATCH,
            (1, DS3_LONG_REFERENCE_STEP, 1e-3))
        print(f"ds3_long_cfm: {DS3_LONG_SERVE_BATCH * len(times) / sum(times):.4f} showers/s "
              f"over all {len(times)} requests, "
              f"{DS3_LONG_SERVE_BATCH * (len(times) - 1) / sum(times[1:]):.4f} steady (first "
              f"request excluded); batch {DS3_LONG_SERVE_BATCH}, requests "
              f"{[round(t, 4) for t in times]} s; on {card}", flush=True)
        del generator
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "data").mkdir()
        _binning_xml(Path(tmp) / "data" / "binning_dataset_2.xml", "ds2")
        print("ds2_train: ds2 shape model at full width through the CaloChallenge experiment",
              flush=True)
        launches["ds2_train"], exp = train_phase(Path(tmp), card)
        print("train parity: K1 against the plain attention", flush=True)
        train_parity_phase(exp)
        print("causal_train: train parity of the layer-causal ViT, K1 masked against the plain "
              "masked attention", flush=True)
        _, launches["causal_train"] = train_parity_phase(exp, causal=True)
        print("train profile: one ds2 train step", flush=True)
        train_profile_phase(exp, card)
        print("ds2_fused_train: ds2 shape model, fused_block: true, through the experiment",
              flush=True)
        launches["ds2_fused_train"], fexp = fused_train_phase(Path(tmp), card, exp)
        print("fused train parity: the megakernel tier against the composed path", flush=True)
        for path, label, cfg, batch, variant in FUSED_PARITY:
            _, launches[path] = fused_parity_phase(label, cfg, batch, variant)
            torch.cuda.empty_cache()
        print("fused train profile: one ds2 fused train step", flush=True)
        train_profile_phase(fexp, card, groups=FUSED_TRAIN_GROUPS)
        del exp, fexp
        _binning_xml(Path(tmp) / "data" / "binning_dataset_3.xml", "ds3")
        rates = {}
        for stem, label, setting, param in DS3_SETTINGS:
            path = f"{stem}_train"
            print(f"{path}: ds3 shape model at full width, composed, {label}, through the "
                  "CaloChallenge experiment", flush=True)
            launches[path], rates[path] = ds3_train_phase(Path(tmp), card, path, label, setting,
                                                          param)
            torch.cuda.empty_cache()
        print(f"ds3_long_train: ds3_long at full width (13,500 tokens, K7), batch "
              f"{DS3_LONG_TRAIN_BATCH}, {DS3_LONG_STEPS} steps and one validation batch, through "
              "the CaloChallenge experiment", flush=True)
        launches["ds3_long_train"], rates["ds3_long_train"] = ds3_train_phase(
            Path(tmp), card, "ds3_long_train", "13,500 tokens, attn_impl auto (K7)", "k7", {},
            DS3_LONG_MODEL, DS3_LONG_STEPS, DS3_LONG_STEPS, DS3_LONG_TRAIN_BATCH)
        torch.cuda.empty_cache()
        print("ds3 training, steps/s over the whole train() loop / steady step interior: "
              + ", ".join(f"{p} {a:.3f} / {b:.3f}" for p, (a, b) in rates.items())
              + f"; on {card}", flush=True)
        print("ds3 train parity: the opt-in kernels against attn_impl xla, fused_mlp false",
              flush=True)
        for path, label, param, setting in DS3_PARITY:
            cfg = _with_net_param(DS3_SHAPE_MODEL, fused_block=False, **param)
            ref = _with_net_param(cfg, attn_impl="xla", fused_mlp=False)
            _, launches[path] = parity_phase(label, cfg, ref, 64, COMPOSED,
                                             composed_launches(setting, TRAIN_PARITY_STEPS, 0))
            torch.cuda.empty_cache()
        print("ds3_long train parity: K7 against attn_impl xla (checkpoint_grads: true, so that "
              "its (N, N) scores are held one block at a time)", flush=True)
        _, launches["ds3_long_parity"] = parity_phase(
            "ds3_long, attn_impl auto (K7)", DS3_LONG_MODEL,
            _with_net_param(DS3_LONG_MODEL, attn_impl="xla", checkpoint_grads=True),
            DS3_LONG_PARITY_BATCH, COMPOSED, composed_launches("k7", TRAIN_PARITY_STEPS, 0),
            K7_TRAIN_TOL)
        torch.cuda.empty_cache()
        print("energy: ds2 energy model at full width", flush=True)
        energy_phase(Path(tmp))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    summary = []
    for k in REPLACES:
        main_r = groups["main"][k]
        by_path = {p: n[k] for p, n in launches.items() if k in n}
        summary.append({
            "name": k, "route": "cuda", "source": REPLACES[k][0], "replaces": REPLACES[k][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "tolerance": TOL[k], "ok": main_r["ok"],
            **{key: main_r[key] for key in keys + ("library_f32_ms",) if key in main_r},
            "shapes": {SHAPE_GROUPS[g]: {key: r[k][key] for key in keys + ("library_f32_ms",)
                                         if key in r[k]}
                       for g, r in groups.items() if g != "main" and k in r}})
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
