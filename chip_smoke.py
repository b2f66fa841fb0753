#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the ds1 (photons, pions),
ds2 and ds3 two-stage shower generators (CFM and cINN shape models), the
shipped ``_tpu`` variants, the layer-causal ViT, the ds2 training slice and
its megakernel training tier, ds3 CFM training and serving through the
composed block's opt-in kernels, the 13,500-token ds3 ViT (ds3_long)
through the streaming flash attention K7, training, sampling and
evaluation through the CaloChallenge experiment (ds2, ds1 photons), the
rest of the cINN (its training, the energy cINN, the nflows couplings, the
ViT1D kernel twins), and the other three families (CaloGAN, LEMURS,
CaloHadronic: serving, training, sampling and evaluation through their
experiments), cross-dataset fine-tuning (ds2 -> ds3, LEMURS ->
CaloHadronic), the ``torch.export`` serving artifacts of the ds2 CFM and
cINN chains, CaloHadronic training over the mmap record cache, the
autoregressive energy net and the parallel layer (data-parallel training
through the launcher's ``distributed: true``, NCCL, Megatron tensor
parallelism, the GPipe pipeline and ring attention, in ranks of this
script on the one card), at full width, through the hand-written CUDA
kernels.

    python3 chip_smoke.py        # from the repository root, on a machine with a GPU

Phases, each of which fails the run (non-zero exit) when it fails:

1. device: requires CUDA (no CPU path); prints the card's name and power limit;
2. build: compiles every kernel of the port from ``vit4hep_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and prints the seconds;
   the kernel phase starts once all but LATE_SOURCES (K8's, K6's and K7's,
   the longest builds) are built, and waits for those before K6;
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
   with the residual tier forced off and with ``bwd="xla"``; at ds1's
   shapes (groups ``ds1_photons``, ``ds1_pions``): K3 at the energy nets'
   5 and 7 tokens, K2v at tokens (256, 88 / 125, 5) (its embed and final
   products at K = 5 and N = 5), K4 at y (256, 265 / 370); at the _tpu
   variants' head dims: K2v's attention and whole forward at 4 heads x 120
   at 135 and 450 tokens (``tpu``, ``tpu_ds3``), K1's forward and backward at qkv (64, 135, 1440) in 4 heads
   x 120, and K1's forward at the _tpu cINN subnet's (256, 135, 768) in 4
   heads x 64 (``tpu_cinn``); at the cINN's (``cinn_train``, ``cinn_twin``,
   ``nflows*``): K1's forward and backward at cinn_ds2_electrons' training
   shape qkv (64, 135, 576) in 4 heads x 48, K5b, K2b, K5c and K5a at its
   ViT1D subnet's x (64, 135, 192) (F 768, depth 3, 744 outputs a token),
   K2v at the subnet's sampling shape (256, 135, 24), K1's forward and
   backward at cinn_nflows' (64, 135 / 270, 1080) in 6 heads x 60 and
   cinn_nflows_ds3's (16, 675, 1080) in 4 heads x 90, and K1's forward at
   their serving shapes (batch 256); then K10
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
   - ds1_photons_cfm, ds1_pions_cfm: cfm_ds1_{photons,pions} (the
     multi-section ViT: 88 / 125 tokens x 5, hidden 480, depth 6, 6 heads x
     80) behind cfm_ds1_*_energy (5 / 7 u's) through calochallenge_ds1_*'s
     transforms (AddAngularBins reversed), 368 / 533 voxels (GEOMETRY: the
     published bin counts on synthetic radial edges); the launches of
     ds2_cfm; a profile of the photons' request;
   - ds1_photons_cinn, ds1_pions_cinn: cinn_ds1_{photons,pions} (10
     couplings on the (53 / 74, 1, 10) grid, ViT1D subnets of 53 / 74
     tokens in 4 heads x 60, which take the plain attention under ``auto``)
     through calochallenge_ds1_*_noise's transforms: K4 20, K1 0 and K3 80
     launches per request; a profile of the photons' request;
   - tpu_cfm, tpu_cinn: cfm_ds2_electrons_tpu (4 heads x 120) and
     cinn_ds2_electrons_tpu (subnets of hidden 256 in 4 heads x 64) through
     the ds2 transforms, with ds2_cfm's and ds2_cinn's launches;
   - energy_cinn_chain: cinn_ds2_electrons behind the energy cINN
     (cinn_energy: 6 nflows couplings over the 45 u's, MLPs 3 x 128; no
     kernel), K4 40 and K1 120 launches a request, no K3;
   - nflows_cinn, nflows_oneside_cinn, nflows_ds3_cinn: cinn_nflows (8
     couplings, subnets of hidden 360 in 6 heads x 60 over 135 or, spatial,
     270 tokens), cinn_nflows_oneside (10 one-sided couplings) and, one
     request, cinn_nflows_ds3 (1350 tokens x 30; subnets over 675 tokens in
     4 heads x 90) behind the energy CFM: their spline is the plain
     nflows_rqs (no K4, as in JAX), K1's forward 32 / 20 / 24 a request;
   - vit1d_twin_cinn: cinn_ds2_electrons with ``fused_block: sample``:
     sampling through the flow's twin, K2v over each of the 40 subnets
     (GEMM 14, modln 7, attention 3 each), K4 40, no K1;
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
12. experiment sampling (``experiment_sampling_phase``): on the run dirs
   of ds2_train and energy, ``CaloChallenge.sample_n`` of SAMPLING_SHOWERS
   showers (5 batches of 256), staged
   (``sample_us``) and through the fused chain (``fused_generation``), each
   with its exact K3 and K2v launches (paths ``experiment_sampling`` and
   ``experiment_sampling_fused``), the path that ran, and showers/s; the
   fused chain against the staged path on the same noise, stage by stage;
   ``to_mev``, ``plot``'s inverse pipeline; a few steps of the DNN's and
   ResNet18's training on the card against the host's; the evaluation
   core at calochallenge_ds2.yaml's widths on the card against synthetic
   showers of another seed
   (``all-cls``: cls-low, cls-high, cls-resnet; ``fpd``: FPD/KPD), and the
   energy run's ``eval_ui_dists``, each AUC / JSD / FPD / KPD finite, with
   its seconds. No plots and no HDF5 writes (no matplotlib, no h5py here).
13. ds1_train (``ds1_train_phase``): ds1 photons through the experiment on
   synthetic ds1 showers: the energy model, then the shape model
   DS1_TRAIN_STEPS steps at batch 64 (plain attention: no kernel
   launches), then ``sample_n`` of DS1_SAMPLES showers on ds1's discrete
   incident energies with K3 and K2v counted exactly (path
   ``ds1_sampling``), ``to_mev`` to 368 voxels, and the high-level features
   and the ``all-cls`` DNNs (cls-low, cls-high) for one epoch.
14. the rest of the cINN: ds2_cinn_train (cinn_ds2_electrons at full
   width, 90.7 M params, through the experiment with training/cinn/ds23:
   batch 64, AdamW, clip_grad_norm 1000; CINN_TRAIN_STEPS steps on
   synthetic ds2 showers, validating after the last; K1's forward on
   all 120 subnet blocks of every step and validation batch, its backward
   on every step's, no K4; steps/s and one profiled step); then from one
   state (``parity_phase``, CINN_PARITY, CINN_PARITY_STEPS steps; the
   ds2 cINN cut to CINN_CUT_BLOCKS couplings) K1 against the plain
   attention
   (cinn_ds2_electrons, cinn_nflows, cinn_nflows_oneside: CINN_TRAIN_TOL),
   ``remat_spline: true`` against false, and the ViT1D twins' training
   (``fused_block: true``: K5a and K5b; ``fused_stack: false``: K2b and
   K5c) against the composed subnets (CINN_FUSED_TRAIN_TOL), every launch
   counted (``"hybrid"``, K5a with the plain backward, is held on the CPU);
   energy_cinn: cinn_energy trained ENERGY_STEPS steps as a ``model_type:
   energy`` experiment (no launch); cinn_sampling: ``sample_n`` of
   CINN_SAMPLES showers of the ds2_cinn_train run behind the energy-cINN
   run, staged and fused (K4 40 and K1 120 a batch), the fused chain held
   against the staged path on the same noise.
15. the other families (configs written out below as dicts; the card gets
   synthetic events in each family's raw layout through the experiments'
   readers: ``SyntheticCaloGAN``, ``SyntheticLEMURS``,
   ``SyntheticCaloHadronic``). Kernel groups ``calogan`` (K2v at tokens
   (256, 84, 6)), ``calohad`` (K2v at (256, 606, 75): the embed product's K
   and the final one's N 75, the attention's last 64-row tile 30 rows
   full), ``calohad_tpu`` (4 heads x 120 at 606) and ``calohad_train`` (K1
   at qkv (32, 606, 1440)); cfm_lemurs serves and trains at ds2's shapes.
   After ds3_long_cfm, ``family_serving_phase`` on ``FAMILY_SERVING``:
   cfm_eplus behind cfm_eplus_energy ([E | u]), cfm_lemurs behind
   cfm_lemurs_energy (the energy model on [E, theta, phi], the shape model
   on [u | E, theta, phi | labels]), cfm_calohad behind cfm_calohad_energy
   ([u | E]) through ``Generator``, REQUESTS requests of BATCH each (the
   _tpu CaloHadronic one), the conditions drawn and transformed as
   ``sample_n`` does and the showers reversed to physical units on the host
   (``to_showers``): K2v's launches exact (the family energy nets run
   composed: no K3, as in JAX), the kernel generator against the composed
   plain one on the same noise, one request profiled (device events only).
   Last, for each family (``FAMILY_TRAIN``): ``family_train_phase`` (the
   energy model FAMILY_ENERGY_STEPS steps, the shape model
   FAMILY_TRAIN_STEPS at the shipped batch through ``train()``, K1's
   launches exact, a profiled step, the collator's host seconds),
   ``family_parity_phase`` (LEMURS and CaloHadronic: 3 steps with K1
   against the plain attention, TRAIN_TOL) and ``family_sampling_phase``
   (``sample_n`` of FAMILY_SAMPLES staged and fused on the same conditions
   and noise, exact launches, SAMPLING_U_TOL / SAMPLING_TOL, then
   ``to_showers`` and the evaluation on arrays: CaloGAN's DNN,
   LEMURS's ``all-cls``, CaloHadronic's feature DNN, one epoch each).
   CaloHadronic's runs read their events from record caches
   (``data.native_cache``: ``data/native_cache.py`` writes them from the
   events in memory and gathers with its C++ library, built at first use
   with the host's compiler); ``cache_phase`` holds both splits' cached
   batches against the events' own, bit for bit, and times a batch's
   gather, and gather and collator, from each.
   Serving artifacts (``export_phase``, after the ds2_cfm and ds2_cinn
   serving paths, ``EXPORTS``): the path's live ``Generator``, its CFMs
   at 2 RK4 steps (COARSE_STEP), the cINN at CINN_CUT_BLOCKS couplings,
   traced by ``torch.export``
   (utils/serving.trace_generator), saved and loaded into a fresh
   ``LoadedSampler``; the program must hold each kernel's registered op
   once for each launch the live path makes a request
   (ops/library.py); REQUESTS requests through the artifact (launches
   exact, counted from 0) must equal the live generator's on the same
   seeds bit for bit (the same kernels on the same inputs in the same
   order); the export, save and load seconds, the file's bytes and both
   rates are printed. ``ar_phase``: ``ARtransformer`` at its defaults,
   AR_STEPS train steps and one batch of BATCH sampled (45 dimensions one
   after another), finite and repeatable from a seed.
16. cross-dataset fine-tuning (``models/finetuning.py``,
   ``experiments/*_finetuning.py``; the backbones' configs handed in from
   memory through ``backbone_run_config``). Kernel group ``ft_ds3``: K2v at
   tokens (256, 450, 48), the embed product's K 48 after the 90 -> 48
   x_mapper and the final one's N 90. ``ft_ds3_phase``:
   calochallenge_ds2tods3_ft from a ds2 backbone (cfm_ds2_electrons, random
   weights, written through ``save_checkpoint`` and again in the
   reference's layout, which the experiment reads), FT_TRAIN_STEPS steps at
   batch 64 on synthetic ds3 showers with the three-group optimizer (K1's
   launches exact), a profiled step, 3 steps with K1 against the plain
   attention with each group's first step moved by its own lr
   (``ft_parity_phase``, FT_TRAIN_TOL), the net's kernel twin (x_mapper in
   front of K2v) against the composed f32 net (``ft_net_hold``), a warm
   start restoring the three groups exactly, then ``sample_n`` of
   FT_SAMPLES behind a ds3 energy CFM staged and fused with K3's and K2v's
   launches exact. ``ft_calohad_phase``: calohadronic_ft from a LEMURS
   backbone (the embedders, positional frequencies and FinalLayer
   reinitialised; 606 tokens x 75 on [u | E | theta, phi, labels]),
   CALOHAD_FT_STEPS steps at batch 32 (K1 exact), then one request of BATCH
   through ``Generator`` behind a CaloHadronic energy CFM (K2v exact, the
   fixed conditions checked, the showers reversed to GeV), profiled.
17. the parallel layer (``parallel_phase``; ``vit4hep_tpu_torch/parallel/``),
   the kernels built before any rank starts. Each rank is a child of this
   script (``python3 chip_smoke.py --parallel-child <task> <dir>`` with the
   torchrun variables; CHILD_TIMEOUT seconds each, its log's tail printed
   when it fails), counts its kernel launches from 0 and hands them back
   with its results, so that the ``kernels`` line counts them (paths
   ``parallel_*``). Two ranks share cuda:0, where NCCL refuses them, so
   they run over gloo: all-reduce and broadcast take the CUDA tensors, and
   ``ppermute`` stages through host copies (``parallel/_comm.transport``,
   printed per rank). Each check is held against the same work on one rank
   in this process (PARALLEL_TOL), and the times are overhead on one card,
   not scaling. (a) ``experiments.main.main`` with ``distributed: true``
   and ``backend=gloo`` over 2 ranks trains the ds2 shape model
   (cfm_ds2_electrons, hidden 480, depth 6, 6 heads x 80, 135 tokens x 48,
   ``attn_impl: auto``: K1) PARALLEL_STEPS steps at global batch 64 (32 a
   rank, each gradient all-reduced in one flat buffer) on synthetic
   showers with ``save: true`` (the card has no PyYAML: the config is
   handed to the launcher as a dict, the experiment class is the smoke's
   ``SyntheticCaloChallenge``): its losses and validation loss against
   the one-rank run's, equal on both ranks, K1's launches exact on each,
   only rank 0's files, and its checkpoint warm-starting a one-rank
   experiment exactly, held against (b), the same launcher over NCCL as
   one rank (its all-reduces on NCCL; run first): the one-rank run; then
   on the same 2 ranks (the launcher leaves a process group it did not
   make to its caller): (c) ``model_parallel=2``: one train step of the ds2 shape
   model with K1 on 3 heads a rank (loss, the whole gradient, the
   parameters after it) and one ``sample_batch`` of PARALLEL_SAMPLE_BATCH
   through the energy model (K3) and the shape model's K2v twin on its
   gathered weights (``__graft_entry__.py:156-216``), against one rank;
   (d) ``spmd_pipeline`` over 2 stages of the full-width DiT stack (depth
   6, each rank holding its 3 blocks; batch PIPE_BATCH of 135 tokens in
   PIPE_MICRO microbatches, K1), forward and the gradients of sum(out^2)
   against the 6 blocks in sequence; (e) ``ring_attention`` over 2 ranks
   at ds3's attention shape RING_SHAPE, forward and gradients against the
   plain attention. A failed or hung rank, or a check out of its bound,
   fails the run.

The line before the last is the ``{"kernels": [...]}`` summary (per kernel:
its main-path shape's numbers, its launches by path and their sum, and its
numbers at the other shapes); the last line is ``{"ok": true, "device":
{...}}``. Needs no network, no PyYAML, no h5py, no matplotlib, no sklearn and
nothing of JAX or of the JAX package: the ds1, ds2, ds3, _tpu, nflows,
energy-cINN, family and fine-tuning configs are written out below
(tests/test_torch_chain.py, tests/test_torch_ds1.py,
tests/test_torch_cinn_configs.py, the three family test files and
tests/test_torch_finetuning.py hold them equal to the YAML files).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
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

from vit4hep_tpu_torch.data.calochallenge.transforms import apply_pipeline, build_pipeline
from vit4hep_tpu_torch.data.lemurs.datasets import ArrayEvents
from vit4hep_tpu_torch.experiments import train_state as ts
from vit4hep_tpu_torch.experiments.calochallenge import CaloChallenge
from vit4hep_tpu_torch.experiments.calochallenge_finetuning import CaloChallengeFTCFM
from vit4hep_tpu_torch.experiments.calogan import CaloGAN
from vit4hep_tpu_torch.experiments.calohadronic import CaloHadronic
from vit4hep_tpu_torch.experiments.calohadronic_finetuning import CaloHadronicFT
from vit4hep_tpu_torch.experiments.lemurs import LEMURS
from vit4hep_tpu_torch.models import finetuning as ft
from vit4hep_tpu_torch.models.vit import sampling_variant
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
from vit4hep_tpu_torch.ops.pos_embed import create_meshgrid, layer_causal_mask
from vit4hep_tpu_torch.tools import megakernel_residue
from vit4hep_tpu_torch.tools.timing import BF16_FLOPS, F32_FLOPS, card_name, time_ms, work_bound
from vit4hep_tpu_torch.utils.checkpoint import save_checkpoint
from vit4hep_tpu_torch.utils import serving
from vit4hep_tpu_torch.utils.config import Config, instantiate
from vit4hep_tpu_torch.utils.serving import Generator
from vit4hep_tpu_torch.utils.torch_migration import load_net_state_dict

SEED = 0
BATCH = 256
DS1_TRAIN_STEPS = 10  # ds1_train: shape.yaml's batch 64, iterations 800,000
DS1_SAMPLES = 1024  # ds1_train's sample_n: 1,024 of the 121,000 the spectrum gives
# the smoke's time (inside 1200 s on the slowest card machine seen, ~1.25x
# the fastest; PERF.md §2) cuts these depths: REQUESTS 3 -> 2, DS3_REQUESTS
# 2 -> 1, CINN_TRAIN_STEPS 20 -> 10 and SAMPLING_SHOWERS 2500 -> 1280 when
# the fine-tuning phases came in; CINN_TRAIN_STEPS 10 -> 6 and
# CINN_PARITY_STEPS 3 -> 2 when the serving artifacts came in; with the
# parallel phase TRAIN_STEPS 30 -> 20, the plain versions' timing trials
# 10 -> 3 (PLAIN_TRIALS), the exported chains, the plain reference
# generators and the ds3 opt-in serving paths 80 -> 8 net evals a CFM
# (COARSE_STEP), the ds2 cINN's parities and export 20 -> 5 couplings
# (CINN_CUT_BLOCKS); the profiles sum the raw kineto events, and the
# kernel phase starts before the longest builds end (LATE_SOURCES)
REQUESTS = 2
REFERENCE_BATCH = 8
# a cut RK4 step: 2 steps, 8 net evals a CFM (the served models' 0.05
# gives 80), for the exported chains (export, save and load scale with the
# graph's nodes), the plain reference generators and the ds3 opt-in
# serving paths
COARSE_STEP = 0.5
COARSE_EVALS = 8
COARSE_ODE = {"method": "rk4", "options": {"step_size": COARSE_STEP}}
TRAIN_STEPS = 20
VALIDATE_EVERY = 10
WARM_START_STEPS = 5
TRAIN_PARITY_STEPS = 3
CINN_PARITY_STEPS = 2  # the cINN parities' steps (host-bound: ~1 s a step a run)
ENERGY_STEPS = 10
CINN_TRAIN_STEPS = 6  # ds2_cinn_train: cinn/ds23.yaml's batch 64, iterations 100,000
CINN_SAMPLES = 512  # cinn_sampling's sample_n: 2 batches of 256 (n_samples 100,000)
N_EVENTS = 2560  # synthetic showers: 39 training batches of 64, 25 validation events
N_EVENTS_DS3 = 1280  # ds3 (40500 voxels): 19 training batches of 64 (cycled), 13 validation
DS3_REQUESTS = 1  # requests of the composed ds3 serving paths (fused_block: false)
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

# cinn_ds2_electrons at a cut depth, CINN_CUT_BLOCKS of its 20 couplings (a
# step is host-bound, ~70 ms a coupling): its parities and its export
CINN_CUT_BLOCKS = 5
DS2_CINN_CUT_MODEL = dict(DS2_CINN_MODEL, nblocks=CINN_CUT_BLOCKS,
                          is_spatial=[False] * CINN_CUT_BLOCKS)

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

# configs/model/cfm/cfm_ds1_{photons,pions}.yaml: the multi-section ViT (the
# patcher's grids replace num_patches: 88 / 125 tokens x 5)
_DS1_VIT = {
    "dim": 3, "condition_dim": 6, "hidden_dim": 480, "out_channels": 1, "depth": 6,
    "num_heads": 6, "mlp_ratio": 4, "attn_drop": 0.0, "proj_drop": 0.0,
    "pos_embedding_coords": "cylindrical", "temperature": 10000, "learn_pos_embed": True,
    "causal_attn": False, "checkpoint_grads": False,
    "num_patches": [[1, 8, 1], [1, 16, 2], [1, 19, 2], [1, 5, 1], [1, 5, 1]], "patch_dim": 5,
    "attn_impl": "auto", "fused_block": "sample", "compute_dtype": "float32",
}
DS1_SHAPE_MODEL = {
    "photons": {
        "_target_": "vit4hep_tpu.models.calochallenge.CaloChallengeCFM_DS1", "in_channels": 1,
        "shape": [440],
        "list_shape": [[1, 8, 5], [1, 16, 10], [1, 19, 10], [1, 5, 5], [1, 5, 5]],
        "list_edges": [40, 160, 190, 25, 25], "patch_shape": [1, 1, 5],
        "time_distribution": "uniform", "trajectory": "linear",
        "odeint_kwargs": {"method": "rk4", "options": {"step_size": 0.05}},
        "net": {"_target_": "vit4hep_tpu.models.vit.ViT", "param": _DS1_VIT},
    },
}
DS1_SHAPE_MODEL["pions"] = dict(
    DS1_SHAPE_MODEL["photons"], shape=[625],
    list_shape=[[1, 8, 5], [1, 10, 10], [1, 10, 10], [1, 5, 5], [1, 15, 10], [1, 16, 10],
                [1, 10, 5]],
    list_edges=[40, 100, 100, 25, 150, 160, 50],
    net={"_target_": "vit4hep_tpu.models.vit.ViT", "param": dict(
        _DS1_VIT, condition_dim=8,
        num_patches=[[1, 8, 1], [1, 10, 2], [1, 10, 2], [1, 5, 1], [1, 15, 2], [1, 16, 2],
                     [1, 10, 1]])})

# configs/model/cfm/cfm_ds1_{photons,pions}_energy.yaml (5 and 7 layers)
DS1_ENERGY_MODEL = {
    particle: dict(DS2_ENERGY_MODEL, shape=[n], net=dict(DS2_ENERGY_MODEL["net"], param=dict(
        DS2_ENERGY_MODEL["net"]["param"], dims_in=n, fused_group=32)))
    for particle, n in (("photons", 5), ("pions", 7))}

# configs/model/cinn/cinn_ds1_{photons,pions}.yaml: 10 couplings on the (53 / 74,
# 1, 10) grid AddAngularBins pads to, subnets of hidden 240 in 4 heads of 60
DS1_CINN_MODEL = {
    "photons": dict(
        DS2_CINN_MODEL, shape=[53, 1, 10], patch_shape=[[1, 1, 5]], nblocks=10,
        is_spatial=[False] * 10,
        vit_kwargs=dict(DS2_CINN_MODEL["vit_kwargs"], condition_dim=6, hidden_dim=240,
                        mlp_ratio=2.0)),
}
DS1_CINN_MODEL["pions"] = dict(
    DS1_CINN_MODEL["photons"], shape=[74, 1, 10],
    cinn_kwargs=dict(DS2_CINN_MODEL["cinn_kwargs"], min_bin_sizes=[0.01, 0.01]),
    vit_kwargs=dict(DS1_CINN_MODEL["photons"]["vit_kwargs"], condition_dim=8))

# data.transforms of configs/calochallenge/cfm/calochallenge_ds1_{photons,pions}.yaml,
# their _energy twins and cinn/calochallenge_ds1_{photons,pions}_noise.yaml:
# (particle, layers, ScaleTotalEnergy factor, AddAngularBins num_bins and the
# CFM's add_bins (the cINN's are 10 each), CutValues cut) by particle
_DS1 = {"photons": ("photon", 5, 0.25, [1, 10, 10, 1, 1], [5, 10, 10, 5, 5], 5.0e-7),
        "pions": ("pion", 7, 0.125, [1, 10, 10, 1, 10, 10, 1], [5, 10, 10, 5, 10, 10, 5],
                  1.0e-7)}


def _ds1_transforms(p):
    """(shape, energy, cINN) transform mappings of ds1 ``p``."""
    particle, n, factor, bins, add, cut = _DS1[p]
    xml = f"${{data_dir}}/binning_dataset_1_{p}.xml"
    norm = {"ptype": xml, "xml_file": particle}
    scale = {"e_min": 5.5452, "e_max": 15.2492}
    angular = {"ptype": xml, "xml_filename": particle, "num_bins": bins}
    logit = {"delta": 1.0e-6, "rescale": True}
    flat, grid = DS1_SHAPE_MODEL[p]["shape"][0], DS1_CINN_MODEL[p]["shape"]
    return ({"NormalizeByElayer": norm, "ScaleTotalEnergy": {"n_layers": n, "factor": factor},
             "AddAngularBins": dict(angular, add_bins=add),
             "CutValues": {"cut": cut, "n_layers": n}, "ExclusiveLogitTransform": logit,
             "GlobalStandardizeFromFile": {"model_dir": None}, "LogEnergy": {},
             "ScaleEnergy": scale, "AddFeaturesToCond": {"split_index": flat},
             "Reshape": {"shape": [1, flat]}},
            {"NormalizeByElayer": norm, "ScaleTotalEnergy": {"factor": factor, "n_layers": n},
             "SelectDims": {"start": -n, "end": 0}, "ExclusiveLogitTransform": logit,
             "StandardizeUsFromFile": {"n_us": n, "model_dir": None}, "LogEnergy": {},
             "ScaleEnergy": scale, "Reshape": {"shape": [n]}},
            {"NormalizeByElayer": norm, "ScaleTotalEnergy": {"n_layers": n, "factor": factor},
             "AddAngularBins": dict(angular, add_bins=[10] * n),
             "SelectiveUniformNoise": {"a": 1.0e-7, "b": 1.0e-6, "cut": True,
                                       "exclusions": list(range(-n, 0))},
             "ExclusiveLogitTransform": logit, "GlobalStandardizeFromFile": {"model_dir": None},
             "LogEnergy": {}, "ScaleEnergy": scale,
             "AddFeaturesToCond": {"split_index": grid[0] * grid[2]},
             "Reshape": {"shape": [1, *grid]}})


DS1_SHAPE_TRANSFORMS, DS1_ENERGY_TRANSFORMS, DS1_CINN_TRANSFORMS = (
    {p: _ds1_transforms(p)[i] for p in _DS1} for i in range(3))

# configs/model/cfm/cfm_ds2_electrons_tpu.yaml (4 heads of 120) and
# configs/model/cinn/cinn_ds2_electrons_tpu.yaml (subnets of hidden 256 in 4
# heads of 64), served through calochallenge_ds2(_noise)'s transforms
DS2_TPU_SHAPE_MODEL = dict(DS2_SHAPE_MODEL, net=dict(DS2_SHAPE_MODEL["net"], param=dict(
    DS2_SHAPE_MODEL["net"]["param"], num_heads=4)))
DS2_TPU_CINN_MODEL = dict(DS2_CINN_MODEL, vit_kwargs=dict(DS2_CINN_MODEL["vit_kwargs"],
                                                          hidden_dim=256))

# configs/model/cinn/cinn_nflows.yaml: 8 nflows couplings (two spatial) with
# ViT1D subnets of hidden 360 in 6 heads of 60 over 135 (token halves) or 270
# tokens (spatial: all tokens, 12 values); cinn_nflows_oneside.yaml: 10
# one-sided couplings, every other one spatial, 14 bins, bound 23;
# cinn_nflows_ds3.yaml: 6 couplings on ds3 in (3, 5, 2) patches: 1350 tokens
# of 30, subnets over 675 tokens in 4 heads of 90
_NFLOWS_VIT = {
    "dim": 1, "condition_dim": 46, "hidden_dim": 360, "out_channels": 1, "depth": 2,
    "num_heads": 6, "mlp_ratio": 4.0, "pos_embedding_coords": "cartesian", "temperature": 10000,
    "learn_pos_embed": True, "causal_attn": False, "checkpoint_grads": False,
}
NFLOWS_MODEL = {
    "_target_": "vit4hep_tpu.models.calochallenge.CaloChallengeCINN", "in_channels": 1,
    "shape": [45, 16, 9], "patch_shape": [[3, 8, 1]], "coupling_block": "CaloRQSplineNFlows",
    "nblocks": 8, "is_spatial": [False, False, False, True, False, False, False, True],
    "cinn_kwargs": {"num_bins": 10, "bounds_init": 4}, "vit_kwargs": _NFLOWS_VIT,
}
NFLOWS_ONESIDE_MODEL = dict(NFLOWS_MODEL, coupling_block="OneSidedCaloRQSplineNFlows",
                            nblocks=10, is_spatial=[False, True] * 5,
                            cinn_kwargs={"num_bins": 14, "bounds_init": 23})
NFLOWS_DS3_MODEL = dict(NFLOWS_MODEL, shape=[45, 50, 18], patch_shape=[[3, 5, 2]], nblocks=6,
                        is_spatial=[False] * 6, cinn_kwargs={"num_bins": 10, "bounds_init": 20},
                        vit_kwargs=dict(_NFLOWS_VIT, num_heads=4))

# configs/model/cinn/cinn_energy.yaml: 6 RQSplineNFlows couplings over the 45
# u's (halves 22 and 23), 14 bins, bound 25, MLP subnets 3 x 128
ENERGY_CINN_MODEL = {
    "_target_": "vit4hep_tpu.models.calochallenge.CaloChallengeEnergyCINN", "shape": [45],
    "coupling_block": "RQSplineNFlows", "nblocks": 6,
    "cinn_kwargs": {"num_bins": 14, "bounds_init": 25},
    "subnet_kwargs": {"n_layers": 3, "hidden_channels": [128, 128, 128], "dropout": 0.0},
}

# the CaloChallenge geometries: (layer id, alpha bins, radial bin edges) of
# each layer. ds2's edges are the dataset's; ds3's real binning file is not in
# the repository, so its 18 radial bins take synthetic edges; ds1's layers
# have the published bin counts (photons 368 voxels, pions 533) on synthetic
# radial edges
_DS2_EDGES = (0, 4, 8, 13, 19, 27, 38, 54, 80, 150)
_DS3_EDGES = (0, 2, 4, 6, 8, 10, 13, 16, 20, 24, 29, 35, 42, 50, 60, 75, 95, 120, 150)


def _edges(n_r):
    return tuple(5 * j for j in range(n_r + 1))


GEOMETRY = {
    "ds2": [(i, 16, _DS2_EDGES) for i in range(45)],
    "ds3": [(i, 50, _DS3_EDGES) for i in range(45)],
    "ds1_photons": [(0, 1, _edges(8)), (1, 10, _edges(16)), (2, 10, _edges(19)),
                    (3, 1, _edges(5)), (12, 1, _edges(5))],
    "ds1_pions": [(0, 1, _edges(8)), (1, 10, _edges(10)), (2, 10, _edges(10)),
                  (3, 1, _edges(5)), (12, 10, _edges(15)), (13, 10, _edges(16)),
                  (14, 1, _edges(10))],
}
# each geometry's particle and the names of its files under data_dir
PARTICLE = {"ds2": "electron", "ds3": "electron", "ds1_photons": "photon",
            "ds1_pions": "pion"}
XML_NAME = {"ds2": "binning_dataset_2.xml", "ds3": "binning_dataset_3.xml",
            "ds1_photons": "binning_dataset_1_photons.xml",
            "ds1_pions": "binning_dataset_1_pions.xml"}

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
# configs/training/cinn/ds23.yaml on top of default.yaml (the ds2 and ds3 cINNs)
CINN_TRAINING = dict(DS2_TRAINING, iterations=100000, batchsize=64)

# evaluation: of configs/calochallenge/cfm/calochallenge_ds2.yaml and
# calochallenge_ds2_energy.yaml
DS2_EVALUATION = {
    "eval_dataset": "2", "eval_mode": "all", "eval_cut": 0.015, "eval_labels": ["ViT-CFM"],
    "eval_p_label": "", "eval_hdf5_file": "${data_dir}/dataset_2_2.hdf5", "eval_cls_n_layer": 2,
    "eval_cls_n_hidden": 2048, "eval_cls_dropout": 0.0, "eval_cls_lr": 2e-4,
    "eval_cls_batch_size": 1000, "eval_cls_n_epochs": 50, "eval_cls_save_mem": True,
    "eval_cls_resnet_layers": 18, "eval_cls_resnet_lr": 2e-4, "eval_cls_resnet_n_epochs": 50,
}
DS1_EVALUATION = {  # calochallenge_ds1_photons.yaml
    "eval_dataset": "1-photons", "eval_mode": "all", "eval_cut": 0.015,
    "eval_labels": ["Vit-CFM"], "eval_p_label": "",
    "eval_hdf5_file": "${data_dir}/gamma_data_2.hdf5", "eval_cls_n_layer": 2,
    "eval_cls_n_hidden": 2048, "eval_cls_dropout": 0.0, "eval_cls_lr": 2e-4,
    "eval_cls_batch_size": 1000, "eval_cls_n_epochs": 100, "eval_cls_save_mem": True,
    "eval_cls_resnet_layers": 18, "eval_cls_resnet_lr": 2e-5, "eval_cls_resnet_n_epochs": 48,
}
DS2_ENERGY_EVALUATION = {
    "eval_dataset": "2", "eval_mode": "all", "eval_cut": 0.015,
    "eval_hdf5_file": "${data_dir}/dataset_2_2.hdf5", "eval_cls_n_layer": 2,
    "eval_cls_n_hidden": 512, "eval_cls_dropout": 0.0, "eval_cls_lr": 2e-4,
    "eval_cls_batch_size": 1000, "eval_cls_n_epochs": 100, "eval_cls_save_mem": True,
}
# experiment_sampling_phase's cuts of the shipped settings (its docstring)
SAMPLING_SHOWERS = 1280  # n_samples 100,000: 5 full batches of 256
EVAL_EPOCHS = 2  # eval_cls_n_epochs / eval_cls_resnet_n_epochs 50 (100 for the u's)
# sampling_parity (its docstring): one full batch of 256 and one of 44
# padded to 256
SAMPLING_CMP_SHOWERS = 300
SAMPLING_U_TOL = 1e-5
SAMPLING_SHAPE_TOL = 1e-6
SAMPLING_TOL = 1e-4
# classifier_parity: card against host, f32 both (its docstring)
CLS_GRAD_TOL = 1e-4
CLS_PARITY_TOL = 1e-4
CLS_DNN_LR = 1e-4
CLS_RESNET_LR = 1e-5

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
# K1's bf16 arm (a bf16 qkv panel, compute_dtype: bfloat16) against its
# plain versions on the same bf16 values with mm_dtype bf16 (p and ds rounded
# to bf16 before their products, f32 accumulation and statistics): K6's
# kernels on bf16 loads, so K6's bounds and their reasons hold for the f32
# results -- the summation order and exp moving a p or ds element across a
# bf16 rounding boundary, 2e-3 of the scale forward and 4e-3 backward --
# and both sides then round the context and dqkv to bf16, where an f32
# value near a rounding boundary lands one bf16 ulp apart: up to 2^-7 =
# 7.8e-3 of the scale (an element of [1, 2) has an ulp of 2^-7; the first
# card run, NVIDIA H100 80GB HBM3, 700.00 W, measured exactly such flips,
# 2^-8 and 2^-7). So 1e-2 forward and 1.2e-2 backward. The delta pre-pass
# sums the same bf16 products in f32 in another order, and the lse comes
# from f32 sums only: 1e-4.
TOL.update({"qkv_attn_fwd_bf16": 1e-2, "qkv_attn_bwd_delta_bf16": 1e-4,
            "qkv_attn_bwd_dkv_bf16": 1.2e-2, "qkv_attn_bwd_dq_bf16": 1.2e-2})
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
# cINN training from one state. A cINN's loss sums ~6480 spline
# log-derivatives through 20 couplings, and on random draws the gradient of
# its first subnets is a sum over 8640 rows of terms that nearly cancel (a
# flow near the identity), so such a tensor's relative error far exceeds its
# products': with K1 (split TF32) against the plain f32 attention the first
# subnet's embedding gradient moved by 1.9e-3 of its norm, the median tensor
# by 3e-5; with the ViT1D twin's bf16 products by 0.10, the median by 4.4e-3
# (the first card run of these paths, NVIDIA H100 80GB HBM3, 700.00 W). So a
# cINN path holds the whole gradient vector's relative L2
# ("grad_rel_l2_all") and prints its worst tensor beside it; and, as Adam
# divides each entry by its own RMS, entries at noise level flip sign, so the
# parameters are held as the update vector (update_rel), not one by one.
# K1 against the plain attention, f32 both (and remat_spline against none):
# TRAIN_TOL's loss and update bounds, the gradient vector and the grad norm
# 1e-3 (the norm, over the subnets' output layers that see the spline's
# log-derivatives, moved by 4.8e-5 to 3.7e-4 in that run); a missing or
# wrong gradient term misses by O(1).
CINN_TRAIN_TOL = {"loss": TRAIN_TOL["loss"], "grad_rel_l2_all": 1e-3, "grad_norm": 1e-3,
                  "update_rel": TRAIN_TOL["update_rel"]}
# the ViT1D twins (bf16 products) against the composed f32 subnets:
# FUSED_TRAIN_TOL, the whole gradient vector in place of each tensor
CINN_FUSED_TRAIN_TOL = {"loss": FUSED_TRAIN_TOL["loss"],
                        "grad_rel_l2_all": FUSED_TRAIN_TOL["grad_rel_l2"],
                        "grad_norm": FUSED_TRAIN_TOL["grad_norm"],
                        "update_rel": FUSED_TRAIN_TOL["update_rel"]}
# the cINN parity draws lie in [-CINN_DRAW_CLIP, CINN_DRAW_CLIP]: an nflows
# coupling passes an event through unchanged once any of its values leaves
# [-bound, bound] (4 in cinn_nflows), so a value within rounding of the bound
# may take the other branch on one of two paths that differ by rounding, and
# its event's loss jumps; the draws stay 1 inside the smallest shipped bound.
# The gate itself is held on the CPU (tests/test_torch_cinn_rest.py), and the
# serving paths sample events on both sides of it.
CINN_DRAW_CLIP = 3.0
# where a cINN's run misses CINN_TRAIN_TOL or CINN_FUSED_TRAIN_TOL, the
# reference's own sensitivity decides: its run on draws perturbed by
# CINN_PROBE_REL relative (the rounding K1's split TF32 leaves in the
# attention, ~2^-21 a product term, ~1e-6 of the output) against its run on
# the draws themselves. On random draws an nflows cINN is chaotic to
# rounding: such a perturbation moved cinn_nflows' gradient vector by
# 3.2e-2 where K1 against the plain attention moved it by 1.3e-3 (NVIDIA
# H100 80GB HBM3, 700.00 W). A kernel path within CINN_PROBE_FACTOR times
# the probe's errors moves the training no more than rounding the inputs
# would; a missing or wrong term misses by O(1).
CINN_PROBE_REL = 1e-6
CINN_PROBE_FACTOR = 10.0
K1 = "vit4hep_tpu_torch/csrc/qkv_attention.cu"
K1_BWD = "vit4hep_tpu_torch/csrc/qkv_bwd_tf32.cuh"
K1_BWD_LIB = "vit4hep_tpu_torch/csrc/qkv_attention_bwd.cu"
K1_BF16 = "vit4hep_tpu_torch/csrc/qkv_attention_bf16.cu"
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
    # K1's bf16 arm: K6's wgmma bodies on bf16 loads and stores
    "qkv_attn_fwd_bf16": (f"{K1_BF16}: qkv_fwd_bf16_kernel (the body of "
                          "vit4hep_tpu_torch/csrc/attention_wgmma.cuh)",
                          "vit4hep_tpu/ops/fused_qkv_attention.py:58, :65, :94 and :156 on a "
                          "bf16 panel"),
    "qkv_attn_bwd_delta_bf16": (f"{K1_BF16}: bwd_delta_bf16_kernel",
                                f"{K1_BWD_BODIES} on a bf16 panel"),
    "qkv_attn_bwd_dkv_bf16": (f"{K1_BF16}: qkv_bwd_dkv_bf16_kernel (the body of {K6_BWD})",
                              f"{K1_BWD_BODIES} on a bf16 panel"),
    "qkv_attn_bwd_dq_bf16": (f"{K1_BF16}: qkv_bwd_dq_bf16_kernel (the body of {K6_BWD})",
                             f"{K1_BWD_BODIES} on a bf16 panel"),
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
# K1's bf16 arm (compute_dtype: bfloat16); empty for a package without it
# (tree_compare.py runs this script's phases on an older checkout's package)
BF16 = {k: getattr(fqa, c) for k, c in (
    ("qkv_attn_fwd_bf16", "FWD_BF16"), ("qkv_attn_bwd_delta_bf16", "BWD_DELTA_BF16"),
    ("qkv_attn_bwd_dkv_bf16", "BWD_DKV_BF16"), ("qkv_attn_bwd_dq_bf16", "BWD_DQ_BF16"))
    if hasattr(fqa, c)}
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
# ds1's cINNs: 10 couplings (20 coupling sides); their subnets' 53 / 74 tokens
# take the plain attention under attn_impl auto (K1 from 128 tokens, as JAX)
CINN_PER_REQUEST.update({g: {"binned_rqs_inverse": 20, "qkv_attn_fwd": 0, "energy_decoder": 80}
                         for g in ("ds1_photons", "ds1_pions")})
# this slice's cINN paths: cinn_ds2_electrons behind the energy cINN (no K3:
# its MLP subnets and nflows spline are plain); the nflows cINNs (their
# spline is the plain nflows_rqs, as in JAX: no K4) behind the energy CFM,
# K1 in each subnet block (ds2: 16 subnets x 2 blocks at 135 and 270 tokens;
# one-sided 10 x 2; ds3 12 x 2 at 675); the ViT1D twin of cinn_ds2_electrons
# (fused_block: sample): K2v over each of the 40 subnets (depth 3: GEMM 2 +
# 4 x 3, modln 2 x 3 + 1, attention 3) and no K1
CINN_PER_REQUEST.update({
    "energy_cinn_chain": {"binned_rqs_inverse": 40, "qkv_attn_fwd": 120},
    "nflows_cinn": {"qkv_attn_fwd": 32, "energy_decoder": 80},
    "nflows_oneside_cinn": {"qkv_attn_fwd": 20, "energy_decoder": 80},
    "nflows_ds3_cinn": {"qkv_attn_fwd": 24, "energy_decoder": 80},
    "vit1d_twin_cinn": {"binned_rqs_inverse": 40, "energy_decoder": 80, "vit_gemm": 40 * 14,
                        "vit_modln": 40 * 7, "vit_attention": 40 * 3},
})

# the ViT GEMM's main-path shapes (K2v's sampling forward at batch BATCH;
# tree_compare.py times the same): tokens and patch dim by geometry, and the
# six products of a forward, (name, (K, N), epilogue)
VIT_TOKENS = {"ds2": (135, 48), "ds3": (450, 90), "ds1_photons": (88, 5), "ds1_pions": (125, 5)}
# the ds1 kernel shapes: the energy net's tokens (K3) and the cINN's spline
# rows, y (BATCH, 53 / 74 tokens x 5) (K4)
DS1_K3_TOKENS = {"ds1_photons": 5, "ds1_pions": 7}
DS1_K4_ROW = {"ds1_photons": 265, "ds1_pions": 370}


def vit_products(pdim, h=480, fdim=1920, out=None):
    """The products of a ViT forward; the final one emits ``out`` values a
    token (a ViT1D subnet's x_out x patch_dim), ``pdim`` by default."""
    return (("embed", (pdim, h), fdb.EPI_BIAS_POS), ("qkv", (h, 3 * h), fdb.EPI_BIAS),
            ("out", (h, h), fdb.EPI_GATED_RESID), ("fc1", (h, fdim), fdb.EPI_BIAS_GELU),
            ("fc2", (fdim, h), fdb.EPI_GATED_RESID), ("final", (h, out or pdim), fdb.EPI_BIAS))


# K6's and K8's ds3 shapes, qkv (batch, 450, 1440): (shape group, batch,
# layer-causal mask of (15, 5, 6), label)
K68_SHAPES = (("main", 64, False, "ds3 training shape"),
              ("ds3_serve", BATCH, False, "ds3 serving shape"),
              ("ds3_causal", 64, True, "ds3 training shape, layer-causal"),
              ("ds3_serve_causal", BATCH, True, "ds3 serving shape, layer-causal"))

# the kernel phase's shape groups: each kernel's main-path shape (ds2
# sampling; K1 at the ds2 training shape), then the others it is held at
SHAPE_GROUPS = {
    "main": "main-path shape: ds2 sampling (K3, K2v, K4), the ds2 training shape (K1, its "
            "bf16 arm, the tier), the ds3 training shape (K6, K8, K9), the ds3_long serving "
            "shape (K7: q/k/v "
            "(2, 6, 13500, 80))",
    "n450": "K1 at qkv (16, 450, 1440); K5b without a1 at x (16, 450, 480)",
    "noa1": "ds2 training shape, K5b without a1 (recomputed): x (64, 135, 480)",
    "causal_noa1": "ds2 training shape with the layer-causal mask, K5b without a1",
    "cinn": "K1 forward (f32 and the bf16 arm) at the ds2 cINN subnet, qkv (256, 135, 576)",
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
    "ds1_photons": "ds1 photons: K3 at tgt (256, 5, 128), K2v at tokens (256, 88, 5) (qkv (256, "
                   "88, 1440)), K4 at y (256, 265)",
    "ds1_pions": "ds1 pions: K3 at tgt (256, 7, 128), K2v at tokens (256, 125, 5) (qkv (256, 125, "
                 "1440)), K4 at y (256, 370)",
    "tpu": "cfm_ds2_electrons_tpu, 4 heads x 120: K2v's attention and forward at (256, 135), K1 "
           "forward and backward at qkv (64, 135, 1440)",
    "tpu_cinn": "cinn_ds2_electrons_tpu: K1 forward at the subnet's qkv (256, 135, 768), 4 heads x "
                "64",
    "tpu_ds3": "cfm_ds3_electrons_tpu, 4 heads x 120: K2v's attention and forward at (256, 450)",
    "cinn_train": "cinn_ds2_electrons training: K1 forward and backward at qkv (64, 135, 576), 4 "
                  "heads x 48; K5b, K2b, K5c and K5a at its ViT1D subnet's x (64, 135, 192), F "
                  "768, depth 3, 24-value patches, 744 outputs a token",
    "cinn_twin": "the ViT1D twin of cinn_ds2_electrons: K2v at tokens (256, 135, 24), hidden "
                 "192 in 4 heads x 48, F 768, depth 3, 744 outputs a token",
    "nflows": "cinn_nflows: K1 forward and backward at qkv (64, 135, 1080), 6 heads x 60",
    "nflows_serve": "cinn_nflows: K1 forward at the serving shape (256, 135, 1080), 6 heads x 60",
    "nflows_270": "cinn_nflows' spatial subnets: K1 forward and backward at qkv (64, 270, 1080), "
                  "6 heads x 60",
    "nflows_270_serve": "cinn_nflows' spatial subnets: K1 forward at (256, 270, 1080)",
    "nflows_ds3": "cinn_nflows_ds3: K1 forward and backward at qkv (16, 675, 1080), 4 heads x 90",
    "nflows_ds3_serve": "cinn_nflows_ds3: K1 forward at the serving shape (256, 675, 1080), 4 "
                        "heads x 90",
    "calogan": "cfm_eplus (CaloGAN): K2v at tokens (256, 84, 6) (qkv (256, 84, 1440); the embed "
               "product's K and the final one's N 6), 6 heads x 80",
    "calohad": "cfm_calohad (CaloHadronic): K2v at tokens (256, 606, 75) (qkv (256, 606, 1440); "
               "the embed product's K and the final one's N 75), 6 heads x 80",
    "calohad_tpu": "cfm_calohad_tpu: K2v's attention and forward at (256, 606), 4 heads x 120",
    "calohad_train": "CaloHadronic training: K1 forward and backward at qkv (32, 606, 1440), 6 "
                     "heads x 80",
    "ft_ds3": "calochallenge_ds2tods3_ft: K2v at tokens (256, 450, 48) after the 90 -> 48 "
              "x_mapper (qkv (256, 450, 1440); the embed product's K 48, the final one's N 90), "
              "6 heads x 80",
}


# the longest kernel builds (K8, K6, K7, K1's bf16 arm over K6's headers):
# the kernel phase starts without them
LATE_SOURCES = ("vmem_attention", "flash_qkv_attention", "flash_attention", "qkv_attention_bf16")
# trials of a plain version's timing (median): context for the kernel's,
# and the slowest calls of the smoke (the N = 13,500 plain attention)
PLAIN_TRIALS = {"reps": 3, "warmup": 1}


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
           # the plain versions (full f32, some one batch element at a time)
           # are timed as context, on fewer trials than the kernels
           "plain_ms": prev["plain_ms"] + time_ms(plain_fn, **PLAIN_TRIALS),
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


def k3_inputs(b=BATCH, n=45):
    """(K3's call, its plain version, the bytes it must move, its products'
    operations) at an energy net's sampling shape: tgt (b, n, 128) (ds2 and
    ds3: 45 tokens, ds1 photons 5, pions 7), 4 layers, 4 heads, F 512, TE
    64, head 512, inputs made from SEED."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dm, te, fdim, hn, depth = 128, 64, 512, 512, 4
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


def k3_kernel_phase(results, n=45):
    """K3 against its plain version at an energy net's sampling shape of n
    tokens, batch BATCH (45: the same for ds2 and ds3). Its products hold
    the f32 function in split TF32, so its bound is split_tf32_bound's."""
    k3, k3_plain, k3_bytes, k3_flops = k3_inputs(n=n)
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


def k2v_kernel_phase(results, n, pdim, mask=None, gemms=True, heads=6, h=480, depth=6,
                     mlp=4, out=None):
    """K2v against its plain versions at the sampling shape of n tokens x
    pdim (ds2: 135 x 48, ds3: 450 x 90, ds1 photons 88 x 5, pions 125 x
    5), batch BATCH, H ``h`` in ``heads`` heads (480 in 6 x 80; the _tpu
    ViTs 4 x 120; the ViT1D subnet of cinn_ds2_electrons 192 in 4 x 48, depth
    3, F 768, 744 = 31 x 24 outputs a token), F ``mlp`` x H, L ``depth``:
    with ``gemms`` the six product shapes of a forward
    (embed, qkv, out-proj, fc1, fc2, final; ms/plain_ms/bound_ms of vit_gemm
    add up one call at each) and the modulated LayerNorm; then the attention
    and the whole forward, with the shared ``mask`` when given."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    b, fdim = BATCH, mlp * h
    d = h // heads
    m = b * n
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    tokens = _rand(gen, b, n, pdim)
    pos = _rand(gen, n, h)
    mods = _rand(gen, b, depth, 6, h, std=0.1)
    fmod = _rand(gen, b, 2, h, std=0.1)
    products = vit_products(pdim, h, fdim, out)
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
    q, k, v = (t.contiguous() for t in qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    ker = lambda m=mask: fdb.attention(qkv, heads, d ** -0.5, m)  # noqa: E731
    pla = lambda m=mask: fdb.attention_plain(  # noqa: E731
        qkv, heads, d ** -0.5, m, torch.bfloat16)
    lib = lambda: F.scaled_dot_product_attention(q16, k16, v16, attn_mask=mask)  # noqa: E731
    a_bytes = qkv.numel() * 4 + b * n * h * 2 + (0 if mask is None else mask.numel())
    _check("vit_attention", ker(), pla(), results, ker, pla,
           work_bound(a_bytes, _attn_flops(b, heads, n, d, mask), BF16_FLOPS), lib)
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
    pla = lambda: fdb.vit_forward_reference(*va, mask, heads, d ** -0.5)  # noqa: E731
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
    return {"K1": time_ms(k1_run), "plain": time_ms(plain_run, **PLAIN_TRIALS),
            "sdpa": time_ms(sdpa_run),
            "sdpa_bwd": time_ms(sdpa_bwd),
            "bwd": sum(results[k]["ms"] for k in ("qkv_attn_bwd_delta", "qkv_attn_bwd_dkv",
                                                  "qkv_attn_bwd_dq"))}


def k1_bf16_phase(results, b, n, heads=6, d=80, backward=True):
    """K1's bf16 arm against its plain versions on the same bf16 values
    (mm_dtype bf16) at qkv (b, n, 3 * heads * d) bf16, timed beside bf16
    SDPA; with ``backward`` also the delta, dK/dV and dQ passes, then the
    layer-causal mask and a wholly masked row (untimed), and K1's forward +
    backward through autograd against bf16 SDPA's. Its bounds: bf16 bytes at
    2 B an element (lse, delta f32), the products at the bf16 peak."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + n + 1)
    bf = torch.bfloat16
    qkv = _rand(gen, b, n, 3 * heads * d).to(bf)
    scale = d ** -0.5
    out, lse = fqa.attention_fwd_bf16_kernel(qkv, heads, scale)
    out_p, lse_p = fqa.attention_fwd_plain(qkv, heads, scale, mm_dtype=bf)
    if out.dtype != bf or lse.dtype != torch.float32:
        raise PhaseError(f"qkv_attn_fwd_bf16: context {out.dtype}, lse {lse.dtype}")
    q, k, v = (t.contiguous() for t in qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    _check("qkv_attn_fwd_bf16", (out, lse), (out_p, lse_p), results,
           lambda: fqa.attention_fwd_bf16_kernel(qkv, heads, scale),
           lambda: fqa.attention_fwd_plain(qkv, heads, scale, mm_dtype=bf),
           work_bound(2 * (qkv.numel() + out.numel()) + 4 * lse.numel(),
                      _attn_flops(b, heads, n, d, None), BF16_FLOPS),
           lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    r = results["qkv_attn_fwd_bf16"]
    print(f"  qkv_attn_fwd_bf16 at qkv ({b}, {n}, {3 * heads * d}) bf16: {r['ms']:.4f} ms, bf16 "
          f"SDPA {r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), bound "
          f"{r['bound_ms']:.4f} ms", flush=True)
    if not backward:
        return None
    g = _rand(gen, b, n, heads * d).to(bf)
    hd = heads * d
    pair_flops = _attn_flops(b, heads, n, d, None) // 4
    delta = fqa.attention_bwd_delta_bf16_kernel(g, out, heads)
    _check("qkv_attn_bwd_delta_bf16", delta, fqa.delta_plain(g, out, heads), results,
           lambda: fqa.attention_bwd_delta_bf16_kernel(g, out, heads),
           lambda: fqa.delta_plain(g, out, heads),
           work_bound(2 * 2 * g.numel() + 4 * delta.numel(), 2 * g.numel(), F32_FLOPS))
    # the oracle takes the kernels' delta, rowsum(dO O) of the bf16 context
    want = fqa.attention_bwd_plain(qkv, g, lse, heads, scale, mm_dtype=bf, out=out)
    dqkv = torch.zeros_like(qkv)
    fqa.attention_bwd_dkv_bf16_kernel(qkv, g, lse, delta, heads, scale, dqkv)
    fqa.attention_bwd_dq_bf16_kernel(qkv, g, lse, delta, heads, scale, dqkv)
    small = 2 * (qkv.numel() + g.numel()) + 4 * 2 * lse.numel()  # what both passes read
    for name, cols, flops, kernel, writes in (
            ("qkv_attn_bwd_dkv_bf16", slice(hd, 3 * hd), 8 * pair_flops,
             fqa.attention_bwd_dkv_bf16_kernel, 2 * b * n * hd),
            ("qkv_attn_bwd_dq_bf16", slice(0, hd), 6 * pair_flops,
             fqa.attention_bwd_dq_bf16_kernel, b * n * hd)):
        _check(name, dqkv[..., cols], want[..., cols], results,
               lambda kernel=kernel: kernel(qkv, g, lse, delta, heads, scale, dqkv),
               lambda: fqa.attention_bwd_plain(qkv, g, lse, heads, scale, mm_dtype=bf, out=out),
               work_bound(small + 2 * writes, flops, BF16_FLOPS))
    # the layer-causal mask, and a row whose every key it closes (K1's rule:
    # the mean of V forward, each key weighing 1 backward), untimed
    mask = _causal_mask((15, 1, 9))
    dead = mask.clone()
    dead[7] = False
    for m, what in ((mask, "layer-causal mask of (15, 1, 9)"),
                    (dead, "that mask with row 7 wholly masked")):
        o_m, l_m = fqa.attention_fwd_bf16_kernel(qkv, heads, scale, m)
        o_p, l_p = fqa.attention_fwd_plain(qkv, heads, scale, m, mm_dtype=bf)
        _hold("qkv_attn_fwd_bf16", what, (o_m, l_m), (o_p, l_p))
        _hold("qkv_attn_bwd_dkv_bf16", what,
              fqa.attention_bwd_bf16_kernel(qkv, g, o_m, l_m, heads, scale, m),
              fqa.attention_bwd_plain(qkv, g, l_m, heads, scale, m, mm_dtype=bf, out=o_m))
    del mask, dead, o_m, l_m, o_p, l_p

    xk = qkv.clone().requires_grad_()
    xs = q.clone().requires_grad_(), k.clone().requires_grad_(), v.clone().requires_grad_()
    g_heads = g.reshape(b, n, heads, d).permute(0, 2, 1, 3).contiguous()

    def k1_run():
        xk.grad = None
        fqa.fused_qkv_attention(xk, heads).backward(g)

    def plain_run():
        _, lse_run = fqa.attention_fwd_plain(qkv, heads, scale, mm_dtype=bf)
        fqa.attention_bwd_plain(qkv, g, lse_run, heads, scale, mm_dtype=bf)

    def sdpa_run():
        for t in xs:
            t.grad = None
        F.scaled_dot_product_attention(*xs, scale=scale).backward(g_heads)

    sdpa_out = F.scaled_dot_product_attention(*xs, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, xs, g_heads, retain_graph=True)  # noqa: E731
    for c in (*BF16.values(), *TRAINING.values()):
        c.reset()
    k1_run()
    if fqa.FWD_BF16.launches != 1 or fqa.BWD_DQ_BF16.launches != 1 or fqa.FWD.launches:
        raise PhaseError("fused_qkv_attention on a bf16 panel did not run the bf16 arm")
    return {"K1": time_ms(k1_run), "plain": time_ms(plain_run, **PLAIN_TRIALS),
            "sdpa": time_ms(sdpa_run), "sdpa_bwd": time_ms(sdpa_bwd),
            "bwd": sum(results[k]["ms"] for k in ("qkv_attn_bwd_delta_bf16",
                                                  "qkv_attn_bwd_dkv_bf16",
                                                  "qkv_attn_bwd_dq_bf16"))}


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


def k5_kernel_phase(results, b, n, mask=None, primitives=True, save_a1=True, composites=True,
                    h=480, heads=6, fdim=1920, depth=6, pdim=48, out=None):
    """The megakernel tier's training kernels against their plain versions
    at x (b, n, h), ``heads`` heads, F ``fdim`` (ds2 training: b 64, n 135,
    h 480 in 6 heads x 80, F 1920; the cINN's ViT1D subnet: h 192 in 4 x 48,
    F 768, depth 3, 24-value patches, 744 outputs a token), with the shared
    ``mask`` when given. With ``primitives``: the training
    GEMM's two saving epilogues, the four NT and four split-K TN products of
    a block's gradient, their reduction, the three row passes and the adaLN
    reduction (ms of a name add up over its calls). Then K5b from the plain
    forward's residuals (a1 bf16 or, without ``save_a1``, recomputed; y
    bf16; lse), and with ``composites`` K2b, K5c and the whole-ViT K5a
    (``depth`` blocks, ``pdim``-value patches, ``out`` outputs a token)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50 + n)
    d, n_out = h // heads, out or pdim
    m, scale, bf = b * n, d ** -0.5, torch.bfloat16
    x, g = _rand(gen, b, n, h), _rand(gen, b, n, h)
    mod6 = _rand(gen, b, 6, h, std=0.3)
    ws = _block_weights(gen, h, fdim)
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
    va = [_rand(gen, b, n, pdim), _rand(gen, n, h), _rand(gen, b, depth, 6, h, std=0.3),
          _rand(gen, b, 2, h, std=0.3), _rand(gen, pdim, h, std=0.05), _rand(gen, h, std=0.05),
          *(torch.stack([t] * depth) for t in _block_weights(gen, h, fdim)),
          _rand(gen, h, n_out, std=0.05), _rand(gen, n_out, std=0.05)]
    ker = lambda: fdb.vit_fwd_train(*va, mask, heads, None)  # noqa: E731
    pla = lambda: fdb.vit_fwd_train_plain(*va, mask, heads, scale, mm_dtype=bf)  # noqa: E731
    out, res, lses = ker()
    pout, pres, plses = pla()
    pres = pres[:3] + (pres[3].to(bf), pres[4].to(bf))  # a1, y kept in bf16
    res_bytes = 4 * m * ((depth + 1) * h + depth * 4 * h) + 2 * m * depth * (fdim + h) + \
        4 * lses.numel()
    _check("vit_fwd_train", (out, *res, lses), (pout, *pres, plses), results, ker, pla,
           work_bound(4 * (m * pdim + n * h + b * (6 * depth + 2) * h + m * n_out)
                  + depth * wbytes + 2 * (pdim + n_out) * h + mask_bytes + res_bytes,
                  2 * m * (pdim + n_out) * h + depth * (_block_flops(m, h, fdim) + 4 * pairs * d),
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
            "plain": time_ms(lambda: run("xla"), **PLAIN_TRIALS), "sdpa": time_ms(sdpa_run)}


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

    return {"K7": time_ms(k7_run), "plain": time_ms(plain_run, **PLAIN_TRIALS),
            "sdpa": time_ms(sdpa_run)}


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
    n_ins, mufu, regs = _k4_loop(bins)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = sm_clock_mhz()
    warps = fsp.plan(1, n, 1).units * fsp.UNIT // 32
    issue = n_ins * warps / (4 * sms) / (mhz * 1e6) * 1e3
    sfu = mufu * 32 * warps / (16 * sms) / (mhz * 1e6) * 1e3
    return n_ins, mufu, issue, sfu, mhz, regs


@functools.lru_cache(maxsize=None)
def _k4_loop(bins):
    """(instructions, MUFU instructions) of the consumers' unit loop of
    ``binned_rqs_inverse_kernel<bins, false, false>`` and its (registers,
    spill bytes) from the -Xptxas -v report, or None there; read once a
    run (``cuobjdump`` over the whole library takes seconds)."""
    name = f"binned_rqs_inverse_kernelILi{bins}ELb0ELb0E"
    funcs = _cuda.sass_functions(_cuda._lib_path("binned_rqs"), addresses=True)
    ins = next(v for k, v in funcs.items() if name in k)
    body = loop_body(ins, r"^BAR\.SYNC\S* 0x1,")  # the consumers' bar.sync 1
    log = (_cuda.BUILD_DIR / "binned_rqs.log").read_text()
    regs = re.search(name + r"\S*\s+(\d+) bytes stack frame, (\d+) bytes spill stores.*?Used (\d+) "
                     r"registers", log, re.S)
    return (len(body), sum("MUFU." in i for i in body),
            (regs.group(3), regs.group(2)) if regs else None)


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


def _binning_xml(data_dir: Path, geometry: str):
    """A geometry's binning file under ``data_dir`` (XML_NAME), its layers'
    alpha x radial bins (ds2: 45 x 16 x 9 = 6480 voxels; ds3: 45 x 50 x 18
    = 40500; ds1 photons 368, pions 533)."""
    layers = [f'    <Layer id="{i}" r_edges="{",".join(str(v) for v in r_edges)}" '
              f'n_bin_alpha="{n_alpha}"/>' for i, n_alpha, r_edges in GEOMETRY[geometry]]
    (data_dir / XML_NAME[geometry]).write_text("\n".join(
        ['<Bins>', f'  <Particle name="{PARTICLE[geometry]}">', *layers, '  </Particle>',
         '</Bins>']))


def _layer_sizes(geometry: str) -> list:
    return [n_alpha * (len(r_edges) - 1) for _, n_alpha, r_edges in GEOMETRY[geometry]]


def _voxels(geometry: str) -> int:
    return sum(_layer_sizes(geometry))


def _transforms(cfg: dict, data_dir: Path, run_dir: Path):
    resolved = {name: {k: v.replace("${data_dir}", str(data_dir)) if isinstance(v, str) else v
                       for k, v in kw.items()} for name, kw in cfg.items()}
    return build_pipeline(resolved, str(run_dir))


def _with_net_param(cfg: dict, **param):
    return dict(cfg, net=dict(cfg["net"], param=dict(cfg["net"]["param"], **param)))


def _on_card(cfg: dict):
    """The model of ``cfg``, built on the card: its initial weights are
    drawn there, not on the host (every caller overwrites them, by
    ``_randomize`` or a state dict)."""
    with torch.device("cuda"):
        return instantiate(cfg).cuda()


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
    """(shape transforms, energy transforms) on a geometry (GEOMETRY's keys)
    with synthetic statistics in the run dirs under ``tmp``: one u a
    layer."""
    data_dir, shape_dir, energy_dir = tmp / "data", tmp / "shape_run", tmp / "energy_run"
    for d in (data_dir, shape_dir, energy_dir):
        d.mkdir()
    _binning_xml(data_dir, geometry)
    n_layers = len(GEOMETRY[geometry])
    rng = np.random.default_rng(SEED)
    np.save(shape_dir / "means.npy", np.float32(-9.0))
    np.save(shape_dir / "stds.npy", np.float32(4.0))
    np.save(energy_dir / "means_u.npy", rng.normal(0.0, 0.3, n_layers).astype(np.float32))
    np.save(energy_dir / "stds_u.npy", rng.uniform(0.8, 1.5, n_layers).astype(np.float32))
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


def _compare_generators(kern, plain, noise, counters, geometry, shower_tol=5e-2):
    """The kernel generator against the plain one on the same noise (its
    batch): u 1e-3 absolute, the shower in the training basis ``shower_tol``
    of its scale, layer energies in MeV (the geometry's layers) 1e-3
    relative. The plain generator must launch none of the ``counters``'
    kernels. Each chain runs once: the MeV voxels are its showers reversed
    through the shape transforms, as ``Generator.sample_showers`` does."""
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
    mev_k, mev_p = (apply_pipeline(g.shape_transforms, b.cpu().numpy()[:, 0], f.cpu().numpy(),
                                   rev=True)[0]
                    for g, b, f in ((kern, basis_k, full_k), (plain, basis_p, full_p)))
    starts = np.cumsum([0] + _layer_sizes(geometry)[:-1])
    layer_k, layer_p = (np.add.reduceat(m, starts, axis=1) for m in (mev_k, mev_p))
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
    shape_model = _on_card(shape_cfg).eval()
    energy_model = _on_card(energy_cfg).eval()
    _randomize(shape_model, gen)
    _randomize(energy_model, gen)
    return shape_model, energy_model, gen


def cfm_phase(tmp: Path, geometry, shape_cfg, energy_cfg, shape_tf_cfg, energy_tf_cfg,
              requests=REQUESTS, counters=SERVING, per_eval=CFM_PER_EVAL, batch=BATCH,
              reference=(REFERENCE_BATCH, COARSE_STEP, 5e-2)):
    """A CFM shape model (ds2, ds3, or ds2 with ``causal_attn``; or ds3
    composed with an opt-in kernel; or ds3_long) behind its energy model at
    full width: ``requests`` requests of ``batch`` with every kernel of
    ``counters`` counted on every net eval (``per_eval`` launches each, 0
    where absent), then the composed plain generator (plain attention,
    masked where the model is: ``auto`` would launch K1 from 128 tokens; no
    fused MLP) on the same noise. ``reference`` = (its batch, an RK4 step
    size for both shape models there or None for the model's, the shower
    bound); the step is COARSE_STEP by default, 8 shape evals. Energy
    stage: f32 kernel vs f32 composed -> u and layer energies agree to
    ~1e-4; shape stage: bf16 multiplicands over 8-80 evals -> 5e-2 of
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
    if step is not None and step != shape_model.ode_kwargs["step_size"]:
        ref_cfg = dict(shape_cfg, odeint_kwargs={"method": "rk4", "options": {"step_size": step}})
        kern_shape = _on_card(ref_cfg).eval()
        kern_shape.load_state_dict(shape_model.state_dict())
    plain_shape = _on_card(_with_net_param(ref_cfg, fused_block=False, attn_impl="xla",
                                           fused_mlp=False)).eval()
    plain_energy = _on_card(_with_net_param(energy_cfg, fused_block=False)).eval()
    plain_shape.load_state_dict(shape_model.state_dict())
    plain_energy.load_state_dict(energy_model.state_dict())
    noise = (torch.randn(energy_model.x_shape(nb), generator=gen, device="cuda"),
             torch.randn(shape_model.token_shape(nb), generator=gen, device="cuda"))
    _compare_generators(Generator(kern_shape, energy_model, energy_tf, shape_tf, batch=nb),
                        Generator(plain_shape, plain_energy, energy_tf, shape_tf, batch=nb),
                        noise, COMPOSED, geometry, shower_tol)
    return launches, times, generator


def _plain_cinn(cfg: dict) -> dict:
    """A shape cINN's composed plain twin: the plain attention, the composed
    subnets (no fused_block) and, for a binned coupling, the plain spline
    inverse."""
    plain = dict(cfg, vit_kwargs=dict(cfg["vit_kwargs"], attn_impl="xla", fused_block=False))
    if cfg["coupling_block"] == "CaloRQSplineFrEIA":
        plain["cinn_kwargs"] = dict(cfg["cinn_kwargs"], fused_spline=False)
    return plain


def _plain_energy(cfg: dict) -> dict:
    """An energy model's composed plain twin (the energy cINN has no kernel)."""
    return _with_net_param(cfg, fused_block=False) if "net" in cfg else cfg


def cinn_phase(tmp: Path, geometry, shape_cfg, energy_cfg, shape_tf_cfg, energy_tf_cfg,
               requests=REQUESTS, per_request=None, counters=CINN):
    """A cINN shape model (ds2: 20 coupling blocks, 40 ViT1D subnets of 135
    tokens; ds3: 10 and 20 of 225; or an nflows cINN, or the ViT1D twin)
    behind its energy model (the energy CFM, or the energy cINN) at full
    width: ``requests`` requests with ``per_request`` launches each of
    ``counters`` (CINN_PER_REQUEST[geometry] by default; 0 where absent),
    then the composed plain generator (plain spline, plain attention,
    composed subnets, plain energy decoder) on the same noise. All f32 but
    the twin's bf16 products, so the chain tolerances hold with margin."""
    shape_tf, energy_tf = _run_dirs(tmp, geometry, shape_tf_cfg, energy_tf_cfg)
    shape_model, energy_model, gen = _models(shape_cfg, energy_cfg, SEED + 5)
    print(f"  cINN shape model {shape_model.param_count()} params ({shape_cfg['nblocks']} "
          f"{shape_cfg['coupling_block']} couplings), energy model "
          f"{type(energy_model).__name__} {energy_model.param_count()} params", flush=True)
    generator = Generator(shape_model, energy_model, energy_tf, shape_tf, batch=BATCH)
    launches, times = _serve(generator, counters, _voxels(geometry), requests)
    per_request = per_request or CINN_PER_REQUEST[geometry]
    want = {k: requests * per_request.get(k, 0) for k in counters}
    if launches != want:
        raise PhaseError(f"cinn: launches {launches} on the main path, expected {want} "
                         f"({per_request} per request, {requests} requests)")
    launches = {k: v for k, v in launches.items() if v}
    print(f"  launches on the main path: {launches}", flush=True)

    plain_shape = _on_card(_plain_cinn(shape_cfg)).eval()
    plain_energy = _on_card(_plain_energy(energy_cfg)).eval()
    plain_shape.load_state_dict(shape_model.state_dict())
    plain_energy.load_state_dict(energy_model.state_dict())
    nb = REFERENCE_BATCH
    noise = (torch.randn(energy_model.x_shape(nb), generator=gen, device="cuda"),
             torch.randn(shape_model.x_shape(nb), generator=gen, device="cuda"))
    _compare_generators(Generator(shape_model, energy_model, energy_tf, shape_tf, batch=nb),
                        Generator(plain_shape, plain_energy, energy_tf, shape_tf, batch=nb),
                        noise, {**CINN, **SERVING}, geometry)
    del plain_shape, plain_energy
    return launches, times, generator


# the registered op of each counted kernel (ops/library.py): a traced
# program holds one node for each launch the live path makes
OP_COUNTER = {"energy_decoder": "energy_decoder", "vit_gemm": "vit_gemm",
              "vit_modln": "vit_modln", "vit_attention": "vit_attention",
              "binned_rqs_inverse": "binned_rqs_inverse", "qkv_attention_fwd": "qkv_attn_fwd"}
# the exported chains: (counters, launches a request, the shape model's
# config where the chain exports its own cut twin of the live one, else None)
EXPORTS = {"ds2_cfm": (SERVING, {k: COARSE_EVALS * v for k, v in CFM_PER_EVAL.items()}, None),
           "ds2_cinn": (CINN, {"binned_rqs_inverse": 2 * CINN_CUT_BLOCKS,
                               "qkv_attn_fwd": 6 * CINN_CUT_BLOCKS,
                               "energy_decoder": COARSE_EVALS}, DS2_CINN_CUT_MODEL)}


def export_phase(tmp: Path, path, generator, card, requests=REQUESTS):
    """The serving artifact of a live ``Generator`` (utils/serving): the
    chain, its CFMs' RK4 step set to COARSE_STEP for the export and for
    both runs below (a cINN chain with its shape model cut to
    CINN_CUT_BLOCKS couplings: EXPORTS), traced by ``torch.export``,
    saved, loaded into a fresh ``LoadedSampler``; the program holds the kernels' registered ops, one
    node for each launch the live path makes a request; then ``requests``
    requests of BATCH through the artifact with the counters set to 0 just
    before and read just after (exact), and the same requests (conditions,
    seeds) through the live generator: the artifact runs the same kernels
    on the same inputs in the same order, so its showers must equal the
    live ones bit for bit. Returns the artifact's launches."""
    counters, per_request, cut_shape = EXPORTS[path]
    if cut_shape is not None:  # the live chain's energy model and transforms, a cut shape model
        shape_model = _on_card(cut_shape).eval()
        _randomize(shape_model, torch.Generator(device="cuda").manual_seed(SEED + 5))
        generator = Generator(shape_model, generator.energy_model, generator.energy_transforms,
                              generator.shape_transforms, generator.batch,
                              u_position=generator.u_position,
                              energy_cond_width=generator.energy_cond_width)
    cfms = [m for m in (generator.shape_model, generator.energy_model) if hasattr(m, "ode_kwargs")]
    served = [m.ode_kwargs for m in cfms]
    for m in cfms:
        m.ode_kwargs = dict(m.ode_kwargs, step_size=COARSE_STEP)
        if m.net_evals_per_sample() != COARSE_EVALS:
            raise PhaseError(f"{path} export: {m.net_evals_per_sample()} evals at step "
                             f"{COARSE_STEP}, expected {COARSE_EVALS}")
    try:
        return _export(tmp, path, generator, card, requests, counters, per_request)
    finally:
        for m, kw in zip(cfms, served):
            m.ode_kwargs = kw


def _export(tmp, path, generator, card, requests, counters, per_request):
    t0 = time.perf_counter()
    program, header = serving.trace_generator(
        generator.shape_model, generator.energy_model, generator.energy_transforms,
        generator.shape_transforms, generator.batch, u_position=generator.u_position,
        energy_cond_width=generator.energy_cond_width, meta={"path": path})
    t_export = time.perf_counter() - t0
    nodes = sum(1 for _ in program.graph.nodes)
    ops = {}
    for n in program.graph.nodes:
        name = str(n.target)
        if n.op == "call_function" and name.startswith("vit4hep."):
            key = OP_COUNTER[name.split(".")[1]]
            ops[key] = ops.get(key, 0) + 1
    want = {k: v for k, v in per_request.items() if v}
    if ops != want:
        raise PhaseError(f"{path} export: the program holds ops {ops}, the live path launches "
                         f"{want} a request")
    t0 = time.perf_counter()
    file = tmp / f"{path}.v4h"
    file.write_bytes(serving.artifact_bytes(program, header))
    t_save = time.perf_counter() - t0
    del program
    t0 = time.perf_counter()
    artifact = serving.load_sampler(file)
    t_load = time.perf_counter() - t0
    print(f"  {path} artifact: {nodes} graph nodes, ops {ops}; export {t_export:.2f} s, save "
          f"{t_save:.2f} s, load {t_load:.2f} s, file {file.stat().st_size} bytes", flush=True)

    conds = [generator.condition(10 ** np.random.default_rng(SEED + 1 + i).uniform(3, 6, BATCH))
             for i in range(requests)]

    def run(fn):
        outs, times = [], []
        for i, cond in enumerate(conds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(fn(cond, seed=SEED + i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return outs, times

    for c in counters.values():
        c.reset()
    art_out, art_times = run(artifact)
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: requests * per_request.get(k, 0) for k in counters}
    if launches != want:
        raise PhaseError(f"{path} artifact: launches {launches}, expected {want} ({requests} "
                         "requests)")
    live_out, live_times = run(generator)
    for i, (a, b) in enumerate(zip(art_out, live_out)):
        _finite(f"{path} artifact request {i}", a.cpu().numpy())
        if a.shape != b.shape or not torch.equal(a, b):
            err = (a - b).abs().max().item() if a.shape == b.shape else float("nan")
            raise PhaseError(f"{path} artifact request {i}: differs from the live generator on "
                             f"the same seed (max abs {err:.3e})")
    rate = lambda times: BATCH * len(times) / sum(times)  # noqa: E731
    print(f"  {path} artifact: {requests} requests equal the live generator's bit for bit; "
          f"launches {launches}; artifact {rate(art_times):.2f} showers/s (requests "
          f"{[round(t, 4) for t in art_times]} s), live {rate(live_times):.2f} (requests "
          f"{[round(t, 4) for t in live_times]} s); batch {BATCH}, on {card}", flush=True)
    return launches


def _device_rows(prof):
    """(ms, count, name) of device-side events only (kernels, copies): a CPU
    op's device time repeats that of the kernels it launched. Summed from
    the raw kineto events: the same sums as ``key_averages()``, which
    builds the whole event tree first (~0.3 ms an event on the host)."""
    from torch.autograd import DeviceType

    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            ms, count = acc.get(e.name(), (0.0, 0))
            acc[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    return sorted(((ms, count, name) for name, (ms, count) in acc.items()), reverse=True)


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
    geometry (ds2: 6480 voxels, ds3: 40500, ds1 photons 368, pions 533):
    sparse exponential voxel energies summing to 0.5-0.9 of E_inc, with a
    longitudinal profile peaking in the first third of the layers. E_inc is
    10^U(3, 6) MeV, on ds1 its discrete 2^8-2^22 MeV."""
    sizes = _layer_sizes(geometry)
    rng = np.random.default_rng(seed)
    if geometry.startswith("ds1"):
        e_inc = (2.0 ** rng.integers(8, 23, (n_events, 1))).astype(np.float32)
    else:
        e_inc = (10 ** rng.uniform(3, 6, (n_events, 1))).astype(np.float32)
    n_layers = len(sizes)
    profile = np.exp(-0.5 * ((np.arange(n_layers) - n_layers * 12 / 45) / (n_layers * 8 / 45))
                     ** 2)
    vox = rng.exponential(1.0, (n_events, sum(sizes))) * (rng.random((n_events, sum(sizes)))
                                                          > 0.5)
    vox *= np.repeat(profile, sizes)[None]
    vox /= vox.sum(1, keepdims=True)
    showers = vox * e_inc * rng.uniform(0.5, 0.9, (n_events, 1))
    return e_inc, showers.astype(np.float32), np.concatenate([[0], np.cumsum(sizes)])


# compute_dtype: bfloat16 (the ViT, its ViT1D subnets and the energy net):
# the models of the bf16 path
DS2_BF16_SHAPE_MODEL = _with_net_param(DS2_SHAPE_MODEL, compute_dtype="bfloat16")
DS2_BF16_ENERGY_MODEL = _with_net_param(DS2_ENERGY_MODEL, compute_dtype="bfloat16")
DS2_BF16_CINN_MODEL = dict(DS2_CINN_CUT_MODEL,
                           vit_kwargs=dict(DS2_CINN_CUT_MODEL["vit_kwargs"],
                                           compute_dtype="bfloat16"))
# a bf16 request against the f32 request of the same weights on the same
# noise (the energy and shape stages both bf16): every Dense, LayerNorm and
# activation rounds its result to bf16 (2^-9 relative), ~60 such roundings
# a ViT eval (6 blocks of ~10) at random sign move the velocity by
# ~sqrt(60) x 2^-9 = 1.5e-2 of its scale; the ODE integrates it over t in
# [0, 1] without amplifying it (random weights of std 0.02), and the energy
# stage's u's (its net bf16 too) move the shape stage's condition alike: the
# u's and the shower in the training basis within 5e-2 of their scales (3x),
# and each must differ from f32 (a silent f32 path gives 0). The cINN's
# spline math is f32, its 5 couplings' subnets bf16: the same bound.
BF16_SERVE_TOL = 5e-2


class SyntheticCaloChallenge(CaloChallenge):
    """The port's CaloChallenge experiment with synthetic MeV showers on the
    ds2 geometry in place of the training and test files (the card's
    machine has no h5py and no dataset)."""

    geometry, n_events = "ds2", N_EVENTS

    def load_showers(self):
        return _synthetic_showers(self.n_events, SEED, self.geometry)

    def load_test_showers(self):
        return _synthetic_showers(self.n_events, SEED + 1, self.geometry)


class SyntheticCaloChallengeDS3(SyntheticCaloChallenge):
    """The same on the ds3 geometry (40500 voxels)."""

    geometry, n_events = "ds3", N_EVENTS_DS3


class SyntheticCaloChallengeDS1(SyntheticCaloChallenge):
    """The same on the ds1 photons geometry (368 voxels)."""

    geometry = "ds1_photons"


def _experiment_config(tmp: Path, model, transforms, training, model_type, train_val_frac,
                       geometry="ds2"):
    """The composed calochallenge_ds2(_energy) config (or ds3's or ds1's,
    with its model and transforms) with the run dir under ``tmp`` and the
    binning XML in ``tmp/data``."""
    ds = geometry[2:]
    return Config({
        "exp_name": f"smoke_{model_type}", "exp_type": "calochallenge", "run_name": "run",
        "base_dir": str(tmp), "data_dir": str(tmp / "data"), "seed": SEED, "debug": False,
        "warm_start_idx": None, "save": True, "use_mlflow": True, "save_source": False,
        "ema": False, "train": True, "evaluate": False, "plot": False,
        "plotting": {"loss": False}, "dtype": "float32", "model_type": model_type,
        "model": model, "training": training,
        "data": {"training_file": f"${{data_dir}}/dataset_{ds}_1.hdf5",
                 "test_file": f"${{data_dir}}/dataset_{ds}_2.hdf5",
                 "particle_type": PARTICLE[geometry],
                 "xml_filename": f"${{data_dir}}/{XML_NAME[geometry]}",
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


def bf16_train_phase(tmp: Path, card):
    """The ds2 shape model with compute_dtype bfloat16 (and the experiment's
    dtype bfloat16, which it logs) trained TRAIN_STEPS steps at full width
    through the CaloChallenge experiment: its attention goes through K1's
    bf16 arm, forward and backward, and never K1's f32 kernels."""
    training = dict(DS2_SHAPE_TRAINING, iterations=TRAIN_STEPS,
                    validate_every_n_steps=VALIDATE_EVERY)
    cfg = _experiment_config(tmp, DS2_BF16_SHAPE_MODEL, DS2_SHAPE_TRANSFORMS, training, "shape",
                             [0.99, 0.01])
    cfg.exp_name = "smoke_bf16"
    cfg.dtype = "bfloat16"
    exp = SyntheticCaloChallenge(cfg, device="cuda")
    counters = {**BF16, **TRAINING}
    for c in counters.values():
        c.reset()
    exp()
    launches = {k: c.launches for k, c in counters.items()}
    _check_training(exp, "bf16_train")
    steps = len(exp.train_loss)
    val_batches = len(exp.val_loss) * exp._val_iterator.batches_per_epoch
    want = {k: 0 for k in TRAINING}
    want.update({"qkv_attn_fwd_bf16": 6 * (steps + val_batches),
                 "qkv_attn_bwd_delta_bf16": 6 * steps, "qkv_attn_bwd_dkv_bf16": 6 * steps,
                 "qkv_attn_bwd_dq_bf16": 6 * steps})
    if steps != TRAIN_STEPS or launches != want or exp.dtype != torch.bfloat16:
        raise PhaseError(f"bf16_train: {steps} steps, launches {launches}, expected {want}; "
                         f"dtype {exp.dtype}")
    steady = exp.step_times[2:]
    print(f"  {steps} steps, loss {exp.train_loss[0]:.4f} -> {exp.train_loss[-1]:.4f}, val "
          f"{exp.val_loss}; launches {launches}", flush=True)
    print(f"bf16_train: {steps / exp.train_seconds:.3f} steps/s over the whole train() loop; "
          f"step interior {len(steady) / sum(steady):.3f} steps/s steady (steps 3-{steps}); "
          f"batch {int(exp.cfg.training.batchsize)}; on {card}", flush=True)
    return {k: v for k, v in launches.items() if v}


def _bf16_against_f32(what, gen16, shape_cfg, energy_cfg, noise):
    """One request of the bf16 generator against the f32 generator of the
    same weights on the same noise and condition: the u's and the shower
    within BF16_SERVE_TOL of their scales, the shower not equal (the u's are
    where the energy model is f32 in both)."""
    shape32, energy32 = _on_card(shape_cfg).eval(), _on_card(energy_cfg).eval()
    shape32.load_state_dict(gen16.shape_model.state_dict())
    energy32.load_state_dict(gen16.energy_model.state_dict())
    gen32 = Generator(shape32, energy32, gen16.energy_transforms, gen16.shape_transforms,
                      batch=noise[0].shape[0])
    cond = gen16.condition(10 ** np.random.default_rng(SEED).uniform(3, 6, noise[0].shape[0]))
    basis16, full16 = gen16.generate(cond, noise=noise)
    basis32, full32 = gen32.generate(cond, noise=noise)
    _finite(what, basis16.cpu().numpy(), full16.cpu().numpy())
    errs = [_rel_err(a, b) for a, b in ((full16, full32), (basis16, basis32))]
    print(f"  {what} against f32 (same weights and noise): u max_abs_err {errs[0][0]:.3e} "
          f"(scale {errs[0][1]:.3g}), shower max_abs_err {errs[1][0]:.3e} (scale "
          f"{errs[1][1]:.3g}); bound {BF16_SERVE_TOL:g} x scale, the shower's not 0", flush=True)
    if not (all(e <= BF16_SERVE_TOL * sc for e, sc in errs) and errs[1][0] > 0):
        raise PhaseError(f"{what}: the bf16 request against f32 is off its bound (or equal)")
    del shape32, energy32, gen32


def bf16_serving_phase(tmp: Path, card):
    """One ds2 CFM request (both models bf16, 80 evals each: K2v and K3) and
    one ds2 cINN request (its CINN_CUT_BLOCKS couplings' subnets bf16: K1's
    bf16 arm forward and K4) at full width, each against the f32 request of
    the same weights. Returns {path: launches}."""
    launches = {}
    counters = {**SERVING, **BF16, **TRAINING}
    (tmp / "cfm").mkdir()
    shape_tf, energy_tf = _run_dirs(tmp / "cfm", "ds2", DS2_SHAPE_TRANSFORMS,
                                    DS2_ENERGY_TRANSFORMS)
    shape16, energy16, gen = _models(DS2_BF16_SHAPE_MODEL, DS2_BF16_ENERGY_MODEL, SEED)
    generator = Generator(shape16, energy16, energy_tf, shape_tf, batch=BATCH)
    evals = shape16.net_evals_per_sample()
    got, times = _serve(generator, counters, _voxels("ds2"), 1)
    want = {k: evals * CFM_PER_EVAL.get(k, 0) for k in counters}
    if got != want:
        raise PhaseError(f"bf16_cfm: launches {got}, expected {want}")
    launches["bf16_cfm"] = {k: v for k, v in got.items() if v}
    print(f"bf16_cfm: {BATCH / times[0]:.2f} showers/s (one request of {BATCH}, {evals} evals "
          f"a model, {times[0]:.4f} s); launches {launches['bf16_cfm']}; on {card}", flush=True)
    noise = (torch.randn(energy16.x_shape(BATCH), generator=gen, device="cuda"),
             torch.randn(shape16.token_shape(BATCH), generator=gen, device="cuda"))
    _bf16_against_f32("bf16_cfm", generator, DS2_SHAPE_MODEL, DS2_ENERGY_MODEL, noise)
    del shape16, energy16, generator
    torch.cuda.empty_cache()

    (tmp / "cinn").mkdir()
    shape_tf, energy_tf = _run_dirs(tmp / "cinn", "ds2", DS2_CINN_TRANSFORMS,
                                    DS2_ENERGY_TRANSFORMS)
    counters = {**CINN, **BF16}
    cinn16, energy, gen = _models(DS2_BF16_CINN_MODEL, DS2_ENERGY_MODEL, SEED + 5)
    generator = Generator(cinn16, energy, energy_tf, shape_tf, batch=BATCH)
    got, times = _serve(generator, counters, _voxels("ds2"), 1)
    want = {k: 0 for k in counters}
    want.update({"binned_rqs_inverse": 2 * CINN_CUT_BLOCKS, "energy_decoder": 80,
                 "qkv_attn_fwd_bf16": 6 * CINN_CUT_BLOCKS})
    if got != want:
        raise PhaseError(f"bf16_cinn: launches {got}, expected {want}")
    launches["bf16_cinn"] = {k: v for k, v in got.items() if v}
    print(f"bf16_cinn: {BATCH / times[0]:.2f} showers/s (one request of {BATCH}, "
          f"{CINN_CUT_BLOCKS} couplings, {times[0]:.4f} s); launches {launches['bf16_cinn']}; "
          f"on {card}", flush=True)
    noise = (torch.randn(energy.x_shape(BATCH), generator=gen, device="cuda"),
             torch.randn(cinn16.x_shape(BATCH), generator=gen, device="cuda"))
    _bf16_against_f32("bf16_cinn", generator, DS2_CINN_CUT_MODEL, DS2_ENERGY_MODEL, noise)
    return launches


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


def _train_run(model, draws, loss, training, counters):
    """The gradients of ``model`` at ``draws[0]``, then TRAIN_PARITY_STEPS
    train steps of it (``training``'s optimizer and clipping) on ``draws``:
    (gradients, the steps' metrics, the parameters after, the launches of
    ``counters`` in the steps)."""
    grads = torch.autograd.grad(loss(model, draws[0]), list(model.parameters()))
    state = ts.create_train_state(model, Config(training), use_ema=False)
    step = ts.make_train_step(lambda *d: loss(model, d), clip_grad_norm=training["clip_grad_norm"])
    before = {k: c.launches for k, c in counters.items()}
    metrics = [step(state, d) for d in draws]
    counts = {k: c.launches - before[k] for k, c in counters.items()}
    if any(m["skipped"] for m in metrics):
        raise PhaseError("parity: a step was skipped")
    return grads, metrics, dict(model.named_parameters()), counts


def _deviation(run, ref, names, init):
    """How far ``run`` (a _train_run) is from ``ref``: the gradients'
    relative L2 by tensor (the worst, and of the whole vector), the loss and
    grad norm relative (the worst step), the largest parameter difference
    and the update vector's relative error after the steps. Returns (worst,
    the gradients' relative L2 by tensor name)."""
    (ga, ma, pa, _), (gb, mb, pb, _) = run, ref
    rel = {n: ((a - b).norm() / b.norm()).item() for n, a, b in zip(names, ga, gb)
           if b.norm() > 0}
    worst = {"grad_rel_l2": max(rel.values()),
             "grad_rel_l2_all": math.sqrt(sum((a - b).norm().item() ** 2 for a, b in zip(ga, gb))
                                          / sum(b.norm().item() ** 2 for b in gb))}
    for key in ("loss", "grad_norm"):
        worst[key] = max(abs(float(x[key]) - float(y[key])) / abs(float(y[key]))
                         for x, y in zip(ma, mb))
    du = torch.cat([(pa[n] - init[n]).flatten() for n in pb])
    dc = torch.cat([(pb[n] - init[n]).flatten() for n in pb])
    worst["update_rel"] = ((du - dc).norm() / dc.norm()).item()
    worst["param_abs"] = max((pa[n] - pb[n]).abs().max().item() for n in pb)
    return worst, rel


def parity_phase(label, cfg, ref_cfg, batch, counters, want, tol=FUSED_TRAIN_TOL,
                 training=DS2_SHAPE_TRAINING, data_shape=None, steps=TRAIN_PARITY_STEPS):
    """The model of ``cfg`` against the one of ``ref_cfg`` from one state:
    per parameter tensor the relative L2 of the gradients of one batch, then
    ``steps`` train steps of each (``training``'s optimizer and
    clipping) on the same random batches and draws (x ~ N(0, 1), c ~ U(0,
    1); a CFM's t ~ U(0, 1) and x_0 ~ N(0, 1); a cINN's x clipped to
    CINN_DRAW_CLIP), held to ``tol`` (of the loss, the gradients' relative
    L2, the grad norm, the largest parameter difference and the update
    vector's relative error, the keys it has). For a cINN whose run misses
    a bound, the reference model's own sensitivity decides (the rounding
    probe, CINN_PROBE_REL): a third run, the reference on the draws
    perturbed by CINN_PROBE_REL relative, against the reference; each
    error may then reach CINN_PROBE_FACTOR times the probe's. The first
    model's steps must launch ``want`` of each of ``counters``. A batch's x
    is drawn in ``data_shape`` where the model's loss takes another layout
    than its ``x_shape`` (LEMURS's (B, H, W, L)). Returns (worst errors,
    launches)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    fused = _on_card(cfg)
    _randomize(fused, gen)
    init = {k: v.clone() for k, v in fused.state_dict().items()}
    shape = fused.x_shape(batch)
    cfm = fused.model_type == "cfm"
    clip = math.inf if cfm else CINN_DRAW_CLIP
    t_shape = (batch,) + (1,) * (len(shape) - 1)
    draws = [(torch.randn(data_shape or shape, generator=gen, device="cuda").clamp(-clip, clip),
              torch.rand((batch, fused.condition_dim), generator=gen, device="cuda"),
              *((torch.rand(t_shape, generator=gen, device="cuda"),
                 torch.randn(shape, generator=gen, device="cuda")) if cfm else ()))
             for _ in range(steps)]
    loss = lambda model, d: (model.batch_loss(d[0], d[1], t=d[2], x_0=d[3]) if cfm  # noqa: E731
                             else model.batch_loss(*d))
    names = [n for n, _ in fused.named_parameters()]

    def reference(draws):
        model = _on_card(ref_cfg)
        model.load_state_dict(init)
        return _train_run(model, draws, loss, training, counters)

    run = _train_run(fused, draws, loss, training, counters)
    ref = reference(draws)
    worst, rel = _deviation(run, ref, names, init)
    counts = run[3]
    if counts != want:
        raise PhaseError(f"parity ({label}): launches {counts}, expected {want}")
    same = all(torch.equal(run[2][n], ref[2][n]) for n in ref[2])
    bounds = dict(tol)
    ok = all(worst[k] <= bounds[k] for k in tol)
    probe = None
    if not ok and not cfm:
        perturbed = [(d[0] * (1 + CINN_PROBE_REL * torch.randn(d[0].shape, generator=gen,
                                                               device="cuda")), *d[1:])
                     for d in draws]
        probe, _ = _deviation(reference(perturbed), ref, names, init)
        bounds = {k: max(tol[k], CINN_PROBE_FACTOR * probe[k]) for k in tol}
        ok = all(worst[k] <= bounds[k] for k in tol)
    del run, ref
    worst_name = max(rel, key=rel.get)
    print(f"  {label}, batch {batch}: gradient rel L2 worst {worst['grad_rel_l2']:.3e} "
          f"({worst_name}), median {float(np.median(list(rel.values()))):.3e}, of the whole "
          f"vector {worst['grad_rel_l2_all']:.3e}; "
          f"{steps} steps: loss rel {worst['loss']:.3e}, grad_norm rel "
          f"{worst['grad_norm']:.3e}, param max abs {worst['param_abs']:.3e}"
          f"{' (equal bit for bit)' if same else ''}, update rel {worst['update_rel']:.3e} "
          f"(bounds {tol}) {'ok' if ok and probe is None else 'FAILED' if not ok else ''}",
          flush=True)
    if probe is not None:
        print(f"  rounding probe (the reference on draws x (1 + {CINN_PROBE_REL:g} N(0, 1))): "
              + ", ".join(f"{k} {probe[k]:.3e}" for k in tol)
              + f"; bounds max(tol, {CINN_PROBE_FACTOR:g} x probe): "
              + ", ".join(f"{k} {bounds[k]:.3e}" for k in tol) + f" {'ok' if ok else 'FAILED'}",
              flush=True)
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
    """A few steps of the ds2 energy experiment; returns the experiment."""
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
    return exp


def _finite(what, *arrays):
    for a in arrays:
        if not np.isfinite(a).all():
            raise PhaseError(f"{what}: non-finite values")


def _experiment_samples(exp, label, card, counters=SERVING):
    """``exp.sample_n()`` with the ``counters`` set to 0 just before and
    read just after: (samples, conditions, launches, seconds)."""
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, cond = exp.sample_n()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    n = int(exp.cfg.n_samples)
    bs = int(exp.cfg.training.batchsize_sample)
    print(f"  {label}: {n} showers in {seconds:.3f} s = {n / seconds:.2f} showers/s (host "
          f"clock, {-(-n // bs)} batches of {bs}, the host transforms included; on {card})",
          flush=True)
    return samples, cond, launches, seconds


class _EnergyRunInMemory:
    """The energy run's config from its experiment in memory (the card's
    machine has no PyYAML to read ``config.yaml``)."""

    energy_cfg = None  # the energy experiment's config

    def energy_run_config(self):
        return Config(self.energy_cfg.to_container(resolve=False))


class SamplingCaloChallenge(_EnergyRunInMemory, SyntheticCaloChallenge):
    """The smoke's shape experiment for sampling behind an energy run in
    memory."""


def _scaled_err(got, want):
    """max |got - want| over max |want|."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def sampling_parity(exp, card):
    """The fused chain against the staged path on the same per-batch noise
    (drawn on the card) and the same SAMPLING_CMP_SHOWERS energies (one numpy
    seed), the last batch padded:

    - the conditions [u | E_inc]: the staged path maps the energy run's u's
      through the host transforms in numpy, the fused chain through their
      device twins in f32: SAMPLING_U_TOL of scale;
    - the fused chain's showers against the staged shape stage
      (``_sample_in_batches``) on the fused chain's conditions and the same
      shape noise: the same kernels on the same rows, SAMPLING_SHAPE_TOL of
      scale;
    - the showers of the two paths end to end: SAMPLING_TOL of scale. The
      conditions' f32 rounding reaches K2v's bf16 products, where it moves
      a product's input across a bf16 rounding boundary now and then; the
      ODE carries that on, but over 80 evals it stays far below bf16's own
      2^-9 (4e-6 of scale on an NVIDIA H100 80GB HBM3 at 700.00 W).

    Neither run counts on the main path."""
    n0, fused0 = exp.cfg.n_samples, exp.cfg.get("fused_generation", False)
    n, bs = SAMPLING_CMP_SHOWERS, int(exp.cfg.training.batchsize_sample)
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    shapes = [getattr(m, "token_shape", lambda b: None)(bs) or m.x_shape(bs)  # a CFM's tokens
              for m in (exp.energy_model, exp.model)]
    noise = tuple([torch.randn(shape, generator=g, device="cuda") for _ in range(-(-n // bs))]
                  for shape in shapes)
    exp.cfg.n_samples, out = n, {}
    for fused in (False, True):
        exp.cfg.fused_generation = fused
        np.random.seed(SEED + 11)
        out[fused] = exp.sample_n(noise=noise)
        if exp.last_sampling_fused != fused:
            raise PhaseError(f"sampling parity: fused_generation {fused}, but the "
                             f"{'fused' if exp.last_sampling_fused else 'staged'} path ran")
    (staged, c_staged), (fused, c_fused) = out[False], out[True]
    shape_stage = exp._sample_in_batches(exp.model, c_fused, bs, noise[1])
    exp.cfg.n_samples, exp.cfg.fused_generation = n0, fused0
    errs = {"conditions": _scaled_err(c_fused, c_staged),
            "fused vs staged shape stage": _scaled_err(fused, shape_stage),
            "showers end to end": _scaled_err(fused, staged)}
    print(f"sampling parity, fused chain vs staged path, {n} showers on the same noise (max "
          f"error over scale): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; on {card}", flush=True)
    _finite("sampling parity", staged, fused, shape_stage)
    if fused.shape != staged.shape or c_fused.shape != c_staged.shape:
        raise PhaseError(f"sampling parity: fused {fused.shape} / {c_fused.shape}, staged "
                         f"{staged.shape} / {c_staged.shape}")
    if errs["conditions"] > SAMPLING_U_TOL:
        raise PhaseError(f"sampling parity: the fused chain's conditions are "
                         f"{errs['conditions']:.3e} of scale from the staged path's (bound "
                         f"{SAMPLING_U_TOL})")
    if errs["fused vs staged shape stage"] > SAMPLING_SHAPE_TOL:
        raise PhaseError(f"sampling parity: the fused chain's showers are "
                         f"{errs['fused vs staged shape stage']:.3e} of scale from the staged "
                         f"shape stage on the same conditions (bound {SAMPLING_SHAPE_TOL})")
    if errs["showers end to end"] > SAMPLING_TOL:
        raise PhaseError(f"sampling parity: the fused chain's showers are "
                         f"{errs['showers end to end']:.3e} of scale from the staged path's "
                         f"(bound {SAMPLING_TOL})")


def classifier_parity(card):
    """cls-low's DNN (2 layers of 2048 on 1 + 6480 inputs) and cls-resnet's
    ResNet18 on (45, 16, 9) at calochallenge_ds2.yaml's widths, from one
    initial state on the card (cuBLAS, cuDNN's Conv3d) and on the host
    (torch's own kernels: ``train_classifier`` turns oneDNN off there), f32
    both (TF32 off):

    - the loss gradient of the initial state on a batch of 32, each
      parameter's to CLS_GRAD_TOL of its scale (f32 sums in another order);
    - ``train_classifier`` for one epoch of 4 steps (120 events at batch 32,
      the ragged tail wrapped): the best state's logits of all 160 events,
      and the ResNet's BatchNorm running statistics, to CLS_PARITY_TOL of
      their scale. Adam moves every parameter by ~lr in the direction of
      its gradient's sign, so a gradient ~0 moves by ~lr whichever sign
      rounding gives it, and the parameters are not compared one by one.
      On an NVIDIA H100 80GB HBM3 at 700.00 W the DNN's logits part by
      ~4e-7 at CLS_DNN_LR. ResNet18's Conv3d weight gradients are sums of
      ~30,000 terms a batch whose rounding (9e-6 of scale) flips the sign
      of near-zero entries, and each flipped step moves the next
      gradients, so the spread compounds: on that card its logits part by
      1.5e-3 after 4 steps at lr 1e-4 and by 1.2e-6 at 1e-5 (the
      gradient's own rounding), so it trains at CLS_RESNET_LR.

    Also warms cuBLAS and cuDNN up before the evaluation's classifiers are
    timed."""
    import copy

    from vit4hep_tpu_torch.evaluation import classifiers as cls

    rng = np.random.default_rng(SEED + 13)
    n_in = 1 + _voxels("ds2")
    labels = (rng.random(160) > 0.5).astype(np.float32)
    data = rng.normal(size=(160, n_in)).astype(np.float32) + 0.1 * labels[:, None]
    data = np.concatenate([data, labels[:, None]], axis=1)
    for name, optimizer, lr, build in (
            ("DNN 2 x 2048", "Adam", CLS_DNN_LR,
             lambda g: cls.DNN(2, 2048, 0.0, n_in, generator=g)),
            ("ResNet18", "AdamW", CLS_RESNET_LR,
             lambda g: cls.generate_model(18, img_shape=(45, 16, 9), generator=g))):
        init = build(torch.Generator().manual_seed(SEED)).state_dict()
        models = {}
        for dev in ("cuda", "cpu"):
            models[dev] = build(None).to(dev)
            models[dev].load_state_dict(init)
        x = torch.from_numpy(data[:32, :-1])
        y = torch.from_numpy(data[:32, -1])
        grads = {}
        for dev, m in models.items():
            m.train()
            with torch.backends.mkldnn.flags(enabled=dev != "cpu"):
                loss = F.binary_cross_entropy_with_logits(m(x.to(dev)).squeeze(-1), y.to(dev))
                loss.backward()
            grads[dev] = {k: p.grad.detach().cpu().numpy() for k, p in m.named_parameters()}
        grad_err, worst = max((_scaled_err(grads["cuda"][k], g), k)
                              for k, g in grads["cpu"].items())
        if not grad_err <= CLS_GRAD_TOL:
            raise PhaseError(f"classifier parity, {name}: the card's gradient of {worst} is "
                             f"{grad_err:.3e} of scale from the host's (bound {CLS_GRAD_TOL})")
        cfg = cls.ClassifierConfig(lr=lr, batch_size=32, n_epochs=1, optimizer=optimizer)
        out = {}
        for dev in ("cuda", "cpu"):
            models[dev].load_state_dict(init)
            t0 = time.perf_counter()
            best, apply_fn = cls.train_classifier(models[dev], data[:120], data[120:], cfg,
                                                  device=dev)
            out[dev] = (apply_fn(data), {k: v.cpu().numpy() for k, v in best["state"].items()
                                         if k.endswith(("running_mean", "running_var"))})
            if dev == "cuda":
                card_s = time.perf_counter() - t0  # apply_fn's logits are on the host
        logit_err = _scaled_err(out["cuda"][0], out["cpu"][0])
        stats = {k: _scaled_err(out["cuda"][1][k], v) for k, v in out["cpu"][1].items()}
        print(f"classifier parity, {name}, lr {lr:g} (card vs host, max error over scale): "
              f"gradient {grad_err:.3e}, logits {logit_err:.3e}, BatchNorm statistics "
              f"{max(stats.values(), default=0.0):.3e}; {card_s:.2f} s on {card}",
              flush=True)
        err, worst = max([(logit_err, "the logits")] + [(v, k) for k, v in stats.items()])
        if not err <= CLS_PARITY_TOL:
            raise PhaseError(f"classifier parity, {name}: {worst} on the card are {err:.3e} of "
                             f"scale from the host's (bound {CLS_PARITY_TOL})")


def experiment_sampling_phase(shape_cfg, energy_exp, card):
    """Sampling and evaluation through the experiment on the card, on the
    run dirs of ds2_train (``model_run0.pt``) and energy:

    1. ``sample_n`` of the ds2 shape model behind the energy run, staged
       (``sample_us``: the energy stage, its u's through the host
       transforms, the shape stage) and then fused (``fused_generation``):
       (SAMPLING_SHOWERS, 1, 45, 16, 9) finite showers and (., 46)
       conditions, the padding of the last batch cut; K3 80 launches and
       K2v CFM_PER_EVAL x 80 per batch on each path, and the path that
       ran the one asked for; showers/s; the fused chain held against the
       staged path on the same noise (``sampling_parity``); then
       ``to_mev``, the inverse pipeline of ``plot``, to MeV voxels;
    2. the classifiers' training on the card held against the host's
       (``classifier_parity``), then the evaluation core at
       calochallenge_ds2.yaml's ``evaluation:`` widths, generated against
       synthetic showers of another seed:
       ``all-cls`` (cls-low and cls-high, a DNN with 2 layers of 2048;
       cls-resnet, ResNet18 on (45, 16, 9)) and ``fpd`` (FPD/KPD at
       10,000-sample draws, float64 on the card); then the energy run's
       ``eval_ui_dists`` (a DNN with 2 layers of 512 on the 45 u's) on
       its own SAMPLING_SHOWERS samples. Every AUC, JSD and FPD/KPD must be
       finite.

    Cut from the shipped settings: n_samples 100,000 -> SAMPLING_SHOWERS
    (time); classifier epochs 50 (100 for the u's) -> EVAL_EPOCHS (time);
    the reference is synthetic, not a Geant4 file (no dataset here); no
    plots (no matplotlib here) and no HDF5 writes (no h5py here). Returns
    {path: launches}."""
    from vit4hep_tpu_torch.evaluation.ugr_evaluation import evaluate_showers
    from vit4hep_tpu_torch.evaluation.us_evaluation import eval_ui_dists

    cfg = Config(shape_cfg.to_container(resolve=False))
    cfg.train = False  # a warm start from model_run0.pt
    cfg.sample_us, cfg.n_samples = True, SAMPLING_SHOWERS
    cfg.energy_model = energy_exp.cfg.run_dir
    cfg.evaluation = dict(DS2_EVALUATION, eval_cls_n_epochs=EVAL_EPOCHS,
                          eval_cls_resnet_n_epochs=EVAL_EPOCHS)
    exp = SamplingCaloChallenge(cfg, device="cuda")
    exp.energy_cfg = energy_exp.cfg
    exp()
    if next(exp.model.parameters()).device.type != "cuda":
        raise PhaseError("experiment sampling: the shape model is not on the card")
    n, bs = SAMPLING_SHOWERS, int(exp.cfg.training.batchsize_sample)
    batches = -(-n // bs)
    grid, voxels = (45, 16, 9), _voxels("ds2")
    evals = exp.model.net_evals_per_sample()
    want = {k: batches * evals * per for k, per in CFM_PER_EVAL.items()}
    launches, rates = {}, {}
    for path, fused in (("experiment_sampling", False), ("experiment_sampling_fused", True)):
        exp.cfg.fused_generation = fused
        samples, cond, got, seconds = _experiment_samples(exp, path, card)
        if samples.shape != (n, 1, *grid) or cond.shape != (n, 46):
            raise PhaseError(f"{path}: samples {samples.shape}, conditions {cond.shape}, "
                             f"expected {(n, 1, *grid)} and ({n}, 46): padding not cut?")
        _finite(path, samples, cond)
        if next(exp.energy_model.parameters()).device.type != "cuda":
            raise PhaseError(f"{path}: the energy model is not on the card")
        # sample_n falls back to the staged path when the fused chain cannot
        # be built: the launches alone would not tell the two apart
        if exp.last_sampling_fused != fused:
            raise PhaseError(f"{path}: fused_generation {fused}, but the "
                             f"{'fused' if exp.last_sampling_fused else 'staged'} path ran")
        if got != want:
            raise PhaseError(f"{path}: launches {got}, expected {want} ({batches} batches x "
                             f"{evals} evals x CFM_PER_EVAL)")
        launches[path], rates[path] = got, n / seconds
        print(f"  launches on the main path: {got}", flush=True)
    sampling_parity(exp, card)
    mev, e_inc = exp.to_mev(samples, cond)
    _finite("to_mev", mev, e_inc)
    if mev.shape != (n, voxels) or e_inc.shape != (n, 1) or (mev < 0).any():
        raise PhaseError(f"to_mev: showers {mev.shape}, energies {e_inc.shape}, min {mev.min()}")
    print(f"experiment sampling: staged {rates['experiment_sampling']:.2f} showers/s, fused "
          f"{rates['experiment_sampling_fused']:.2f}; MeV showers {mev.shape}, mean total "
          f"energy {mev.sum(1).mean():.1f} MeV; on {card}", flush=True)

    classifier_parity(card)
    ref_e, ref_showers, _ = _synthetic_showers(n, SEED + 7)
    # all-cls twice: the first run's seconds hold one-time costs at the
    # evaluation's shapes; the second run's are the classifiers' own
    for mode, run in (("all-cls", " (first run)"), ("all-cls", " (second run)"), ("fpd", "")):
        exp.cfg.evaluation.eval_mode = mode
        results = evaluate_showers(mev, e_inc, ref_showers, ref_e, exp.cfg, device="cuda")
        for key, r in results.items():
            scores = [r["auc"], r["jsd"]] if "auc" in r else [r["value"], r["error"]]
            if not np.isfinite(scores).all():
                raise PhaseError(f"evaluation {key}: {r}")
            shown = (f"AUC {r['auc']:.4f}, JSD {r['jsd']:.4f}" if "auc" in r
                     else f"{r['value'] * 1e3:.4f} +- {r['error'] * 1e3:.4f} (x10^3)")
            print(f"  {key}{run}: {shown} in {r['seconds']:.2f} s; on {card}", flush=True)
        if mode == "all-cls" and set(results) != {"cls-low", "cls-high", "cls-resnet"}:
            raise PhaseError(f"all-cls ran {sorted(results)}")

    energy_exp.cfg.n_samples = n
    energy_exp.cfg.evaluation = dict(DS2_ENERGY_EVALUATION, eval_cls_n_epochs=EVAL_EPOCHS)
    for c in SERVING.values():
        c.reset()
    u_samples, u_cond = energy_exp.sample_n()
    if SERVING["energy_decoder"].launches != batches * evals:
        raise PhaseError(f"energy sample_n: {SERVING['energy_decoder'].launches} K3 launches, "
                         f"expected {batches * evals}")
    us, ref_us = energy_exp.energy_us(u_samples, u_cond)
    _finite("energy_us", us, ref_us)
    t0 = time.perf_counter()
    _, auc, jsd = eval_ui_dists(us, ref_us, energy_exp.cfg, device="cuda")
    if not np.isfinite([auc, jsd]).all():
        raise PhaseError(f"eval_ui_dists: AUC {auc}, JSD {jsd}")
    print(f"  u's DNN (eval_ui_dists, {us.shape[1]} u's): AUC {auc:.4f}, JSD {jsd:.4f} in "
          f"{time.perf_counter() - t0:.2f} s; on {card}", flush=True)
    return launches


class DS1SamplingCaloChallenge(SamplingCaloChallenge, SyntheticCaloChallengeDS1):
    """The ds1 shape experiment for sampling: ds1's incident energies (the
    log2-spaced spectrum, shuffled by numpy's global generator) cut to
    DS1_SAMPLES."""

    def generate_Einc_ds1(self, sample_multiplier=1000):
        return super().generate_Einc_ds1(-(-DS1_SAMPLES // 121))[:DS1_SAMPLES]


def ds1_train_phase(tmp: Path, card):
    """ds1 photons through the experiment on synthetic ds1 showers (368
    voxels; the card's machine has no dataset): the energy model
    (cfm_ds1_photons_energy, 5 u's) ENERGY_STEPS steps at batch 256; the
    shape model (cfm_ds1_photons at full width: 88 tokens x 5, hidden 480,
    depth 6) DS1_TRAIN_STEPS steps at batch 64, its attention the plain one
    (88 tokens: attn_impl auto takes K1 from 128, as JAX), so no kernel
    launches there; then, warm-started from model_run0.pt, ``sample_n`` of
    DS1_SAMPLES showers on ds1's discrete incident energies, staged (u's
    from the energy run), with K3 and K2v counted exactly (4 batches of
    256, CFM_PER_EVAL per eval); ``to_mev`` through AddAngularBins' reverse
    to (DS1_SAMPLES, 368) MeV voxels; and the evaluation core of
    ``eval_sample`` at calochallenge_ds1_photons.yaml's widths against
    synthetic ds1 showers of another seed: the high-level features and the
    ``all-cls`` DNNs (cls-low, cls-high; ds1 has no ResNet test) for one
    epoch. Cut from the shipped settings: training steps, n_samples
    (121,000), classifier epochs (100). Returns {path: launches}."""
    from vit4hep_tpu_torch.evaluation.ugr_evaluation import evaluate_showers

    (tmp / "data").mkdir()
    _binning_xml(tmp / "data", "ds1_photons")
    training = dict(DS2_ENERGY_TRAINING, iterations=ENERGY_STEPS,
                    validate_every_n_steps=ENERGY_STEPS // 2)
    energy_exp = SyntheticCaloChallengeDS1(_experiment_config(
        tmp, DS1_ENERGY_MODEL["photons"], DS1_ENERGY_TRANSFORMS["photons"], training, "energy",
        [0.9999, 0.0001], "ds1_photons"), device="cuda")
    energy_exp()
    _check_training(energy_exp, "ds1 energy")

    training = dict(DS2_SHAPE_TRAINING, iterations=DS1_TRAIN_STEPS,
                    validate_every_n_steps=DS1_TRAIN_STEPS // 2)
    cfg = _experiment_config(tmp, DS1_SHAPE_MODEL["photons"], DS1_SHAPE_TRANSFORMS["photons"],
                             training, "shape", [0.99, 0.01], "ds1_photons")
    cfg.evaluation = dict(DS1_EVALUATION, eval_mode="all-cls", eval_cls_n_epochs=1)
    exp = SyntheticCaloChallengeDS1(cfg, device="cuda")
    for c in COMPOSED.values():
        c.reset()
    exp()
    train_launches = {k: c.launches for k, c in COMPOSED.items()}
    _check_training(exp, "ds1_train")
    if any(train_launches.values()):
        raise PhaseError(f"ds1_train: kernel launches {train_launches} on a plain-attention path")
    if next(exp.model.parameters()).device.type != "cuda":
        raise PhaseError("ds1_train: the shape model is not on the card")
    steady = exp.step_times[2:]
    print(f"  energy: {len(energy_exp.train_loss)} steps of batch 256; shape: "
          f"{len(exp.train_loss)} steps of batch 64, loss {exp.train_loss[0]:.4f} -> "
          f"{exp.train_loss[-1]:.4f}, {len(steady) / sum(steady):.2f} steps/s steady; on {card}",
          flush=True)

    scfg = Config(exp.cfg.to_container(resolve=False))
    scfg.train, scfg.sample_us, scfg.energy_model = False, True, energy_exp.cfg.run_dir
    scfg.n_samples = DS1_SAMPLES  # sample_n takes ds1's spectrum instead; the count printed
    sexp = DS1SamplingCaloChallenge(scfg, device="cuda")
    sexp.energy_cfg = energy_exp.cfg
    sexp()
    np.random.seed(SEED)
    samples, cond, launches, _ = _experiment_samples(sexp, "ds1_sampling", card)
    bs = int(sexp.cfg.training.batchsize_sample)
    evals = sexp.model.net_evals_per_sample()
    want = {k: -(-DS1_SAMPLES // bs) * evals * per for k, per in CFM_PER_EVAL.items()}
    if launches != want:
        raise PhaseError(f"ds1_sampling: launches {launches}, expected {want}")
    if samples.shape != (DS1_SAMPLES, 1, 440) or cond.shape != (DS1_SAMPLES, 6) \
            or sexp.last_sampling_fused:
        raise PhaseError(f"ds1_sampling: samples {samples.shape}, conditions {cond.shape}, "
                         f"fused {sexp.last_sampling_fused}")
    _finite("ds1_sampling", samples, cond)
    mev, e_inc = sexp.to_mev(samples, cond)
    _finite("ds1 to_mev", mev, e_inc)
    spectrum = 2.0 ** np.arange(8, 23)
    if mev.shape != (DS1_SAMPLES, _voxels("ds1_photons")) or (mev < 0).any() \
            or not np.isin(np.round(np.log2(e_inc)), np.log2(spectrum)).all():
        raise PhaseError(f"ds1 to_mev: showers {mev.shape}, min {mev.min()}, energies "
                         f"{np.unique(e_inc)[:20]}")
    print(f"  launches on the main path: {launches}; MeV showers {mev.shape}, mean total energy "
          f"{mev.sum(1).mean():.1f} MeV", flush=True)

    ref_e, ref_showers, _ = _synthetic_showers(DS1_SAMPLES, SEED + 7, "ds1_photons")
    results = evaluate_showers(mev, e_inc, ref_showers, ref_e, sexp.cfg, device="cuda")
    if set(results) != {"cls-low", "cls-high"}:
        raise PhaseError(f"ds1 all-cls ran {sorted(results)}")
    for key, r in results.items():
        if not np.isfinite([r["auc"], r["jsd"]]).all():
            raise PhaseError(f"ds1 evaluation {key}: {r}")
        print(f"  {key}: AUC {r['auc']:.4f}, JSD {r['jsd']:.4f} in {r['seconds']:.2f} s; on "
              f"{card}", flush=True)
    return {"ds1_train": {k: v for k, v in train_launches.items() if v}, "ds1_sampling": launches}


# ---------------------------------------------------------------------------
# the rest of the cINN: its training, the energy cINN, the nflows couplings,
# the ViT1D twins
# ---------------------------------------------------------------------------
def cinn_train_launches(subnets, depth, steps, val_batches):
    """K1's launches when a cINN of ``subnets`` ViT1D subnets of ``depth``
    blocks (each block's attention on K1) trains ``steps`` steps and runs
    ``val_batches`` likelihood batches without gradients."""
    n = dict.fromkeys(TRAINING, subnets * depth * steps)
    n["qkv_attn_fwd"] = subnets * depth * (steps + val_batches)
    return n


def cinn_fused_launches(variant, subnets=40, depth=3, steps=CINN_PARITY_STEPS):
    """The launches of a cINN's train steps whose ViT1D subnets run the
    megakernel tier: fused_launches of one subnet, times the subnets."""
    return {k: subnets * v for k, v in fused_launches(variant, steps, 0, depth).items()}


# the cINN parity paths from one state: (path, label, model config, the
# reference's, tolerance, counters, launches of the first model's steps)
def _vit_kw(cfg: dict, **kw) -> dict:
    """A shape cINN's config with ``kw`` in its subnets' ``vit_kwargs``."""
    return dict(cfg, vit_kwargs=dict(cfg["vit_kwargs"], **kw))


_TWIN = functools.partial(_vit_kw, DS2_CINN_MODEL)
_PLAIN_ATTN = functools.partial(_vit_kw, attn_impl="xla")
_CUT_TWIN = functools.partial(_vit_kw, DS2_CINN_CUT_MODEL)
CINN_PARITY = [
    ("cinn_train_parity", f"cinn_ds2_electrons ({CINN_CUT_BLOCKS} couplings), K1 against the "
     "plain attention", DS2_CINN_CUT_MODEL, _PLAIN_ATTN(DS2_CINN_CUT_MODEL), CINN_TRAIN_TOL,
     TRAINING, cinn_train_launches(2 * CINN_CUT_BLOCKS, 3, CINN_PARITY_STEPS, 0)),
    ("cinn_remat_parity", f"cinn_ds2_electrons ({CINN_CUT_BLOCKS} couplings), remat_spline: "
     "true against false",
     dict(DS2_CINN_CUT_MODEL, cinn_kwargs=dict(DS2_CINN_MODEL["cinn_kwargs"], remat_spline=True)),
     DS2_CINN_CUT_MODEL, CINN_TRAIN_TOL, TRAINING,
     cinn_train_launches(2 * CINN_CUT_BLOCKS, 3, CINN_PARITY_STEPS, 0)),
    ("nflows_parity", "cinn_nflows, K1 against the plain attention", NFLOWS_MODEL,
     _PLAIN_ATTN(NFLOWS_MODEL), CINN_TRAIN_TOL, TRAINING,
     cinn_train_launches(16, 2, CINN_PARITY_STEPS, 0)),
    ("nflows_oneside_parity", "cinn_nflows_oneside, K1 against the plain attention",
     NFLOWS_ONESIDE_MODEL, _PLAIN_ATTN(NFLOWS_ONESIDE_MODEL), CINN_TRAIN_TOL, TRAINING,
     cinn_train_launches(10, 2, CINN_PARITY_STEPS, 0)),
    ("vit1d_fused_parity", f"cinn_ds2_electrons ({CINN_CUT_BLOCKS} couplings), fused_block: "
     "true against composed (K1)", _CUT_TWIN(fused_block=True), DS2_CINN_CUT_MODEL,
     CINN_FUSED_TRAIN_TOL, FUSED_TRAINING,
     cinn_fused_launches("true", subnets=2 * CINN_CUT_BLOCKS)),
    ("vit1d_nostack_parity", f"cinn_ds2_electrons ({CINN_CUT_BLOCKS} couplings), fused_block: "
     "true, fused_stack: false against composed (K1)",
     _CUT_TWIN(fused_block=True, fused_stack=False), DS2_CINN_CUT_MODEL, CINN_FUSED_TRAIN_TOL,
     FUSED_TRAINING, cinn_fused_launches("nostack", subnets=2 * CINN_CUT_BLOCKS)),
]
# device-time groups of a cINN train step
CINN_TRAIN_GROUPS = [("K1 forward", _is_k1_fwd), ("K1 backward", _is_k1_bwd),
                     ("cuBLAS products", _is_gemm)]


def cinn_train_phase(tmp: Path, card):
    """cinn_ds2_electrons (20 couplings, 40 ViT1D subnets of hidden 192,
    depth 3, 4 heads x 48 over 135 tokens; 90.7 M params) trained
    CINN_TRAIN_STEPS steps at full width through the experiment with
    training/cinn/ds23 (batch 64, AdamW lr 1e-4 wd 0.1, cosine,
    clip_grad_norm 1000), validating every VALIDATE_EVERY, on synthetic ds2
    showers through calochallenge_ds2_noise's transforms. K1's counters and
    K4's are set to 0 just before and read just after: K1's forward on every
    subnet block of every step and validation batch, its backward on every
    block of every step, and no K4 (the likelihood direction runs the
    composed spline). Every loss and grad norm finite, no step skipped,
    ``model_run0.pt`` written; steps/s; one step profiled. Returns
    (launches, the experiment)."""
    training = dict(CINN_TRAINING, iterations=CINN_TRAIN_STEPS,
                    validate_every_n_steps=min(VALIDATE_EVERY, CINN_TRAIN_STEPS))
    cfg = _experiment_config(tmp, DS2_CINN_MODEL, DS2_CINN_TRANSFORMS, training, "shape",
                             [0.99, 0.01])
    cfg.exp_name = "smoke_cinn"
    exp = SyntheticCaloChallenge(cfg, device="cuda")
    counters = {**TRAINING, "binned_rqs_inverse": fsp.INVERSE}
    for c in counters.values():
        c.reset()
    exp()
    launches = {k: c.launches for k, c in counters.items()}
    _check_training(exp, "cinn train")
    steps = len(exp.train_loss)
    val_batches = len(exp.val_loss) * exp._val_iterator.batches_per_epoch
    want = {**cinn_train_launches(40, 3, steps, val_batches), "binned_rqs_inverse": 0}
    if steps != CINN_TRAIN_STEPS or launches != want:
        raise PhaseError(f"cinn train: {steps} steps, launches {launches}, expected {want}")
    if not (Path(exp.cfg.run_dir) / "models" / "model_run0.pt").exists():
        raise PhaseError("cinn train: model_run0.pt missing from the run dir")
    steady = exp.step_times[2:]
    print(f"  {steps} steps, {len(exp.val_loss)} validations ({val_batches} batches): loss "
          f"{exp.train_loss[0]:.4f} -> {exp.train_loss[-1]:.4f}, val {exp.val_loss}", flush=True)
    print(f"  launches on the main path: {launches}", flush=True)
    print(f"ds2_cinn_train: {steps / exp.train_seconds:.3f} steps/s over the whole train() loop, "
          f"{len(steady) / sum(steady):.3f} steady step interior (steps 3-{steps}); batch "
          f"{int(cfg.training.batchsize)}; on {card}", flush=True)
    print("ds2_cinn_train profile: one train step", flush=True)
    train_profile_phase(exp, card, groups=CINN_TRAIN_GROUPS)
    return {k: v for k, v in launches.items() if v}, exp


def energy_cinn_phase(tmp: Path, card):
    """cinn_energy (6 nflows couplings over the 45 u's, MLPs 3 x 128)
    trained ENERGY_STEPS steps as a ``model_type: energy`` experiment
    (calochallenge_ds2_energy with model=cinn/cinn_energy: cfm/energy's
    batch 256), which fits ``means_u.npy``/``stds_u.npy``; no kernel on its
    path, so no launch of any. Returns the experiment."""
    training = dict(DS2_ENERGY_TRAINING, iterations=ENERGY_STEPS,
                    validate_every_n_steps=ENERGY_STEPS // 2)
    cfg = _experiment_config(tmp, ENERGY_CINN_MODEL, DS2_ENERGY_TRANSFORMS, training, "energy",
                             [0.9999, 0.0001])
    cfg.exp_name = "smoke_energy_cinn"
    exp = SyntheticCaloChallenge(cfg, device="cuda")
    counters = {**COMPOSED, **FUSED_TRAINING, "binned_rqs_inverse": fsp.INVERSE}
    for c in counters.values():
        c.reset()
    exp()
    _check_training(exp, "energy cinn")
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    if launched or type(exp.model).__name__ != "CaloChallengeEnergyCINN":
        raise PhaseError(f"energy cinn: {type(exp.model).__name__}, launches {launched}")
    steady = exp.step_times[2:]
    print(f"  {type(exp.model).__name__} {exp.model.param_count()} params: "
          f"{len(exp.train_loss)} steps of batch 256, loss {exp.train_loss[0]:.4f} -> "
          f"{exp.train_loss[-1]:.4f}, {len(steady) / sum(steady):.2f} steps/s steady; on {card}",
          flush=True)
    return exp


def cinn_sampling_phase(shape_cfg, energy_exp, card):
    """The all-cINN chain through the experiment: ``sample_n`` of
    CINN_SAMPLES showers of the ds2_cinn_train run (warm-started from
    ``model_run0.pt``) behind the energy-cINN run, staged (``sample_us``)
    and fused (``fused_generation``), each with K4 40 and K1 120 launches a
    batch and nothing else (the energy cINN has no kernel), the path that
    ran the one asked for, finite showers and conditions of their shapes;
    then the fused chain against the staged path on the same noise
    (``sampling_parity``). Returns {path: launches}."""
    cfg = Config(shape_cfg.to_container(resolve=False))
    cfg.train = False
    cfg.sample_us, cfg.n_samples = True, CINN_SAMPLES
    cfg.energy_model = energy_exp.cfg.run_dir
    cfg.evaluation = dict(DS2_EVALUATION)  # sample_n reads eval_dataset "2"
    exp = SamplingCaloChallenge(cfg, device="cuda")
    exp.energy_cfg = energy_exp.cfg
    exp()
    bs = int(exp.cfg.training.batchsize_sample)
    batches = -(-CINN_SAMPLES // bs)
    counters = {**CINN, **SERVING}
    want = {k: batches * CINN_PER_REQUEST["energy_cinn_chain"].get(k, 0) for k in counters}
    launches = {}
    for path, fused in (("cinn_sampling", False), ("cinn_sampling_fused", True)):
        exp.cfg.fused_generation = fused
        samples, cond, got, _ = _experiment_samples(exp, path, card, counters)
        if samples.shape != (CINN_SAMPLES, 1, 45, 16, 9) or cond.shape != (CINN_SAMPLES, 46):
            raise PhaseError(f"{path}: samples {samples.shape}, conditions {cond.shape}")
        _finite(path, samples, cond)
        if exp.last_sampling_fused != fused or \
                type(exp.energy_model).__name__ != "CaloChallengeEnergyCINN":
            raise PhaseError(f"{path}: fused {exp.last_sampling_fused}, energy model "
                             f"{type(exp.energy_model).__name__}")
        if got != want:
            raise PhaseError(f"{path}: launches {got}, expected {want}")
        launches[path] = {k: v for k, v in got.items() if v}
        print(f"  launches on the main path: {launches[path]}", flush=True)
    sampling_parity(exp, card)
    return launches


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


# ---------------------------------------------------------------------------
# the other families: CaloGAN, LEMURS, CaloHadronic
# ---------------------------------------------------------------------------
# configs/model/cfm_calogan/cfm_eplus.yaml
CALOGAN_SHAPE_MODEL = {
    "_target_": "vit4hep_tpu.models.calogan.CaloGANCFM",
    "in_channels": 1,
    "shape": [504],
    "list_shape": [[1, 96, 3], [1, 12, 12], [1, 6, 12]],
    "list_edges": [288, 144, 72],
    "list_patch_shape": [[1, 6, 1], [1, 2, 3], [1, 2, 3]],
    "time_distribution": "uniform",
    "trajectory": "linear",
    "odeint_kwargs": {"method": "rk4", "options": {"step_size": 0.05}},
    "net": {"_target_": "vit4hep_tpu.models.vit.ViT",
            "param": {"dim": 3, "condition_dim": 4, "hidden_dim": 480, "out_channels": 1,
                      "depth": 6, "num_heads": 6, "mlp_ratio": 4, "attn_drop": 0.0,
                      "proj_drop": 0.0, "pos_embedding_coords": "cylindrical",
                      "temperature": 10000, "learn_pos_embed": True, "causal_attn": False,
                      "checkpoint_grads": False, "num_patches": [[1, 16, 3], [1, 6, 4], [1, 3, 4]],
                      "patch_dim": 6, "fused_block": "sample", "compute_dtype": "float32"}},
}
# configs/model/cfm_calohad/cfm_calohad.yaml and its _tpu variant (4 heads)
CALOHAD_SHAPE_MODEL = dict(
    _with_net_param(CALOGAN_SHAPE_MODEL, condition_dim=59, num_patches=[[2, 3, 5], [16, 6, 6]],
                    patch_dim=75),
    _target_="vit4hep_tpu.models.calohadronic.CaloHadCFM", shape=[45450],
    list_shape=[[10, 15, 15], [48, 30, 30]], list_edges=[2250, 43200],
    list_patch_shape=[[5, 5, 3], [3, 5, 5]])
CALOHAD_TPU_MODEL = _with_net_param(CALOHAD_SHAPE_MODEL, num_heads=4)
# configs/model/cfm_lemurs/cfm_lemurs.yaml: cfm_ds2_electrons' ViT on 53 conditions
LEMURS_SHAPE_MODEL = dict(DS2_SHAPE_MODEL, _target_="vit4hep_tpu.models.lemurs.LEMURSCFM",
                          net=dict(DS2_SHAPE_MODEL["net"], param={
                              k: v for k, v in dict(DS2_SHAPE_MODEL["net"]["param"],
                                                    condition_dim=53).items()
                              if k != "attn_impl"}))
# configs/model/cfm_{calogan,lemurs,calohad}/*_energy.yaml: the energy
# transformer composed (no fused_block: no K3, as in JAX)
_FAMILY_ENERGY_NET = {"dim_embedding": 64, "nhead": 4, "num_encoder_layers": 4,
                      "num_decoder_layers": 4, "dim_feedforward": 512, "dropout": 0.0,
                      "activation": "relu"}


def _family_energy(n_us, dims_c, embeds):
    param = {"dims_in": n_us, "dims_c": dims_c, **_FAMILY_ENERGY_NET, "embeds": embeds,
             "encode_t_scale": 30, **({} if embeds else {"encode_t_dim": 64})}
    return {"_target_": "vit4hep_tpu.models.cfm.CFM", "shape": [n_us],
            "time_distribution": "uniform", "trajectory": "linear",
            "odeint_kwargs": {"method": "rk4", "options": {"step_size": 0.05}},
            "net": {"_target_": "vit4hep_tpu.models.energy_transformer.ParallelTransformer",
                    "param": param}}


CALOGAN_ENERGY_MODEL = _family_energy(3, 1, True)
LEMURS_ENERGY_MODEL = _family_energy(45, 3, False)
CALOHAD_ENERGY_MODEL = _family_energy(58, 1, False)

# data.transforms of calogan.yaml / calogan_eplus_energy.yaml, lemurs.yaml /
# lemurs_energy_*.yaml, calohadronic.yaml / calohadronic_energy.yaml
_GAN_COMMON = {"NormalizeLayerEnergyGAN": {},
               "ExclusiveLogitTransformGAN": {"delta": 1.0e-6, "rescale": False}}
_GAN_COND = {"LogEnergyGAN": {}, "ScaleEnergyGAN": {"e_min": 6.907755, "e_max": 13.81551}}
CALOGAN_SHAPE_TRANSFORMS = {**_GAN_COMMON,
                            "GlobalStandardizeFromFileGAN": {"model_dir": None, "eps": 1.0e-10},
                            **_GAN_COND}
CALOGAN_ENERGY_TRANSFORMS = {**_GAN_COMMON, "GlobalStandardizeFromFileGAN": {"model_dir": None},
                             **_GAN_COND}
_LEMURS_LOGIT = {"LEMURSExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True}}
LEMURS_SHAPE_TRANSFORMS = {"LEMURSNormalizeByElayer": {}, "LEMURSCutValues": {"cut": 1.0e-7},
                           **_LEMURS_LOGIT, "LEMURSGlobalStandardizeFromFile": {"model_dir": None},
                           "LEMURSPreprocessConds": {}}
LEMURS_ENERGY_TRANSFORMS = {"LEMURSNormalizeByElayer": {}, **_LEMURS_LOGIT,
                            "LEMURSStandardizeUsFromFile": {"n_us": 45, "model_dir": None},
                            "LEMURSPreprocessConds": {}}
_HAD_HEAD = {"SumPool3dDownScale": {}, "CaloHadNormalizeByElayer": {},
             "CaloHadCutValues": {"cut": 1.0e-7},
             "CaloHadExclusiveLogitTransform": {"delta": 1.0e-6, "rescale": True}}
_HAD_TAIL = {"CaloHadPreprocessConds": {},
             "Reshape": {"dict_shape": {"ecal": [10, 15, 15], "hcal": [48, 30, 30]}}}
CALOHAD_SHAPE_TRANSFORMS = {**_HAD_HEAD, "CaloHadGlobalStandardizeFromFile": {"model_dir": None},
                            **_HAD_TAIL}
CALOHAD_ENERGY_TRANSFORMS = {**_HAD_HEAD,
                             "CaloHadStandardizeUsFromFile": {"n_us": 58, "model_dir": None},
                             **_HAD_TAIL}
# the evaluation: of calogan.yaml, lemurs.yaml and calohadronic.yaml
_CLS = {"eval_cls_n_layer": 2, "eval_cls_n_hidden": 2048, "eval_cls_dropout": 0.0,
        "eval_cls_lr": 2e-4, "eval_cls_batch_size": 1000, "eval_cls_save_mem": True}
CALOGAN_EVALUATION = {"eval_dataset": "CaloGAN", "eval_mode": "low-level",
                      "eval_hdf5_file": "${data_dir}/full_cls_eplus.hdf5", **_CLS,
                      "eval_cls_n_epochs": 100}
LEMURS_EVALUATION = {
    "eval_labels": ["ViT-CFM"], "eval_p_label": "", "eval_dataset": "2",
    "eval_energy_bin": ["1e3", "1e5"], "eval_theta_bin": [0.87, 2.27], "eval_phi_bin": None,
    "eval_mode": "all", "eval_cut": 0.015,
    "eval_hdf5_file": "${data_dir}/lemurs/LEMURS_Par04SiW_gamma_100kEvents_1GeV1TeV_GPSflat_"
                      "part10.h5", **_CLS, "eval_cls_n_epochs": 50, "eval_cls_resnet_layers": 18,
    "eval_cls_resnet_lr": 2e-4, "eval_cls_resnet_n_epochs": 50}
CALOHAD_EVALUATION = {
    "label": "ViT", "eval_dataset": "1-photons", "eval_mode": "all", "eval_cut": 0.015,
    "eval_hdf5_file": "${data_dir}/calohadronic/pions_ECAL+HCAL_10-90GeV_10_test.hdf5", **_CLS,
    "eval_cls_n_epochs": 100, "eval_cls_resnet_layers": 18, "eval_cls_resnet_lr": 2e-5,
    "eval_cls_resnet_n_epochs": 48}
# configs/training/cfm/shape_lemurs.yaml and shape_calohadronic.yaml on default.yaml
LEMURS_TRAINING = dict(DS2_TRAINING, iterations=2000000, batchsize=64, weight_decay=1e-5)
CALOHAD_TRAINING = dict(DS2_TRAINING, iterations=1200000, batchsize=32, weight_decay=1e-5)

LEMURS_DETECTORS = ("Par04SiW", "Par04SciPb", "ODD", "FCCeeCLD", "FCCeeALLEGRO")
LEMURS_GRID = (9, 16, 45)  # (H, W, L) of a LEMURS event
CALOHAD_ECAL_RAW, CALOHAD_HCAL = (30, 180, 180), (48, 30, 30)
# each family: its experiment, models, transform chains, training, the
# smoke's synthetic events (training, test: per detector for LEMURS) and its
# energy run's batch (cfm/energy.yaml's 256; CaloHadronic's cut to 64, its
# test events: a raw event is 4 MB)
FAMILIES = {
    "calogan": dict(exp=CaloGAN, shape=CALOGAN_SHAPE_MODEL, energy=CALOGAN_ENERGY_MODEL,
                    shape_tf=CALOGAN_SHAPE_TRANSFORMS, energy_tf=CALOGAN_ENERGY_TRANSFORMS,
                    training=DS2_SHAPE_TRAINING, evaluation=CALOGAN_EVALUATION,
                    events=(1280, 512), energy_batch=256, n_us=3),
    "lemurs": dict(exp=LEMURS, shape=LEMURS_SHAPE_MODEL, energy=LEMURS_ENERGY_MODEL,
                   shape_tf=LEMURS_SHAPE_TRANSFORMS, energy_tf=LEMURS_ENERGY_TRANSFORMS,
                   training=LEMURS_TRAINING, evaluation=LEMURS_EVALUATION,
                   events=(256, 256), energy_batch=256, n_us=45),
    "calohadronic": dict(exp=CaloHadronic, shape=CALOHAD_SHAPE_MODEL, energy=CALOHAD_ENERGY_MODEL,
                         shape_tf=CALOHAD_SHAPE_TRANSFORMS, energy_tf=CALOHAD_ENERGY_TRANSFORMS,
                         training=CALOHAD_TRAINING, evaluation=CALOHAD_EVALUATION,
                         events=(96, 64), energy_batch=64, n_us=58),
}
FAMILY_TRAIN_STEPS = 10
FAMILY_ENERGY_STEPS = 5
FAMILY_SAMPLES = 512  # families_sampling's sample_n: 2 batches of 256 (n_samples 50,000-100,000)
# the serving paths' launches per net eval: K2v only (the family energy nets
# run composed)
FAMILY_PER_EVAL = {k: v for k, v in CFM_PER_EVAL.items() if k != "energy_decoder"}


def _shower_fractions(rng, n, *shape):
    """Sparse exponential voxel weights of (n, *shape) f32, each event
    summing to 1."""
    w = rng.standard_exponential((n, *shape), dtype=np.float32)
    w *= rng.random((n, *shape), dtype=np.float32) > 0.5
    return w / w.reshape(n, -1).sum(1).reshape(n, *([1] * len(shape)))


def family_events(family, n, seed):
    """Synthetic raw events in the family's layout (the card's machine has
    no dataset and no h5py): CaloGAN's three layers (n, 3, 96), (n, 12, 12),
    (n, 12, 6) in GeV with E_inc ~ U(1, 100) GeV; LEMURS's E (10^U(3, 6)
    MeV), theta, phi and showers (n, 9, 16, 45) in MeV; CaloHadronic's E ~
    U(10, 90) GeV, raw ECal (n, 30, 180, 180) and HCal (n, 48, 30, 30).
    Each event deposits 0.5-0.9 of its incident energy."""
    rng = np.random.default_rng(seed)
    frac = rng.uniform(0.5, 0.9, (n, 1)).astype(np.float32)
    if family == "calogan":
        e = rng.uniform(1, 100, (n, 1)).astype(np.float32)
        split = rng.dirichlet((3.0, 5.0, 1.0), n).astype(np.float32) * e * frac
        return {"energy": e, **{f"layer_{i}": _shower_fractions(rng, n, *s)
                                * split[:, i, None, None]
                                for i, s in enumerate(((3, 96), (12, 12), (12, 6)))}}
    if family == "lemurs":
        e = (10 ** rng.uniform(3, 6, (n, 1))).astype(np.float32)
        return {"incident_energy": e,
                "incident_theta": rng.uniform(0.87, 2.27, (n, 1)).astype(np.float32),
                "incident_phi": rng.uniform(-np.pi, np.pi, (n, 1)).astype(np.float32),
                "showers": _shower_fractions(rng, n, *LEMURS_GRID) * (e * frac)[:, :, None, None]}
    e = rng.uniform(10, 90, (n, 1)).astype(np.float32)
    split = rng.uniform(0.2, 0.6, (n, 1)).astype(np.float32) * e * frac
    return {"energy": e,
            "ecal": _shower_fractions(rng, n, *CALOHAD_ECAL_RAW) * split[:, :, None, None],
            "hcal": _shower_fractions(rng, n, *CALOHAD_HCAL)
            * (e * frac - split)[:, :, None, None]}


class SyntheticCaloGAN(_EnergyRunInMemory, CaloGAN):
    """CaloGAN on synthetic events in place of the training and test files."""

    def load_showers(self):
        return family_events("calogan", FAMILIES["calogan"]["events"][0], SEED)

    def load_test_showers(self):
        return family_events("calogan", FAMILIES["calogan"]["events"][1], SEED + 1)


class _SyntheticLazyFamily(_EnergyRunInMemory):
    """LEMURS or CaloHadronic on synthetic events held in memory
    (``ArrayEvents``) in place of the lazy HDF5 reader: each label of a
    split's file dict gets its own events; a split's warm-up events are its
    first label's."""

    family = None

    def open_events(self, files_dict):
        n_train, n_test = FAMILIES[self.family]["events"]
        train = files_dict is self.hdf5_dict_train
        events = {label: family_events(self.family, n_train if train else n_test,
                                       SEED + (0 if train else 100) + i)
                  for i, label in enumerate(files_dict)}
        self._first_events = getattr(self, "_first_events", {})
        self._first_events[train] = next(iter(events.values()))
        return ArrayEvents(events)

    def warmup_events(self, files_dict):
        return dict(self._first_events[files_dict is self.hdf5_dict_train])


class SyntheticLEMURS(_SyntheticLazyFamily, LEMURS):
    family = "lemurs"


class SyntheticCaloHadronic(_SyntheticLazyFamily, CaloHadronic):
    family = "calohadronic"


SYNTHETIC = {"calogan": SyntheticCaloGAN, "lemurs": SyntheticLEMURS,
             "calohadronic": SyntheticCaloHadronic}


def _family_data(family, model_type):
    """The ``data:`` section of the family's shipped experiment config."""
    energy = model_type == "energy"
    transforms = FAMILIES[family]["energy_tf" if energy else "shape_tf"]
    if family == "calogan":
        return {"training_file": "${data_dir}/train_eplus.hdf5",
                "test_file": "${data_dir}/test_eplus.hdf5", "bin_edges": [0, 288, 432, 504],
                "return_us": energy, "transforms": transforms}
    if family == "lemurs":
        detectors = ("ODD",) if energy else LEMURS_DETECTORS
        return {"xml_filename": "${data_dir}/binning_dataset_2.xml", "return_us": energy,
                "native_cache": None, "max_files_per_worker": 10 if energy else 40,
                "num_classes": 5, "gen_Einc": ["1e3", "1e6"], "gen_theta": [0.87, 2.27],
                "gen_phi": None, "gen_label_vector": [0, 0, 0, 0, 1] if energy else [1, 0, 0, 0, 0],
                "training_file_dict": {d: [f"${{data_dir}}/lemurs/{d}_train.h5"]
                                       for d in detectors},
                "test_file_dict": {d: [f"${{data_dir}}/lemurs/{d}_test.h5"] for d in detectors},
                "transforms": transforms}
    return {"return_us": energy, "native_cache": None, "max_files_per_worker": 5,
            "training_file_dict": {"CaloHad": ["${data_dir}/calohadronic/train.hdf5"]},
            "test_file_dict": {"CaloHad": ["${data_dir}/calohadronic/test.hdf5"]},
            "train_val_frac": [0.99, 0.01], "transforms": transforms}


def family_config(tmp: Path, family, model_type, steps, model=None, native_cache=None):
    """The family's composed experiment config (shape or energy run) with
    the run dir under ``tmp``, ``steps`` training steps validating twice;
    ``native_cache`` a directory for the lazy families' record caches."""
    f = FAMILIES[family]
    energy = model_type == "energy"
    training = dict(DS2_ENERGY_TRAINING, batchsize=f["energy_batch"]) if energy \
        else f["training"]
    return Config({
        "exp_name": f"smoke_{family}_{model_type}", "exp_type": family, "run_name": "run",
        "base_dir": str(tmp), "data_dir": str(tmp / "data"), "seed": SEED, "debug": False,
        "warm_start_idx": None, "save": True, "use_mlflow": True, "save_source": False,
        "ema": False, "train": True, "evaluate": False, "plot": False,
        "plotting": {"loss": False}, "dtype": "float32", "model_type": model_type,
        "sample_us": False, "finetuning": False, "n_samples": FAMILY_SAMPLES,
        "model": model or f["energy" if energy else "shape"],
        "training": dict(training, iterations=steps, validate_every_n_steps=max(1, steps // 2)),
        "data": dict(_family_data(family, model_type),
                     **({} if native_cache is None else {"native_cache": str(native_cache)})),
        "evaluation": dict(f["evaluation"]),
    })


def _family_view(family, cfg, transforms):
    """The family's experiment object without a run: its condition draws
    (``draw_conditions``, ``sampling_conditions``) and the inverse of its
    transform chain (``to_showers``) over ``transforms``."""
    exp = object.__new__(FAMILIES[family]["exp"])
    exp.cfg, exp.transforms = cfg, transforms
    return exp


def _family_run_dirs(tmp: Path, family):
    """(shape transforms, energy transforms) of the family with synthetic
    statistics in run dirs under ``tmp``: a scalar mean/std for the global
    standardizations, one per u for the energy runs' per-u ones."""
    f = FAMILIES[family]
    build = f["exp"].pipeline
    shape_dir, energy_dir = tmp / "shape_run", tmp / "energy_run"
    for d in (shape_dir, energy_dir):
        d.mkdir()
        np.save(d / "means.npy", np.float32(-9.0))
        np.save(d / "stds.npy", np.float32(4.0))
    rng = np.random.default_rng(SEED)
    np.save(energy_dir / "means_u.npy", rng.normal(0.0, 0.3, f["n_us"]).astype(np.float32))
    np.save(energy_dir / "stds_u.npy", rng.uniform(0.8, 1.5, f["n_us"]).astype(np.float32))
    return build(f["shape_tf"], str(shape_dir)), build(f["energy_tf"], str(energy_dir))


def _check_showers(what, data, family):
    """The physical showers of ``to_showers``: finite, non-negative, of the
    family's shapes."""
    keys = {"calogan": ("layer_0", "layer_1", "layer_2"), "lemurs": ("showers",),
            "calohadronic": ("ecal", "hcal")}[family]
    for k in keys:
        _finite(f"{what} {k}", data[k])
        if (np.asarray(data[k]) < 0).any():
            raise PhaseError(f"{what}: negative {k} voxels")
    return sum(int(np.prod(np.shape(data[k])[1:])) for k in keys)


def family_serving_phase(tmp: Path, family, shape_cfg, card, requests=REQUESTS, profile=True):
    """A family's two-stage chain at full width and depth (the shape CFM
    behind its energy CFM, through ``utils/serving.Generator`` with the
    family's condition layout) answering ``requests`` requests of BATCH: the
    conditions drawn and transformed as the experiment's ``sample_n`` does,
    the showers reversed to physical units through the family's transforms
    (``to_showers``). K2v's launches exact (FAMILY_PER_EVAL a net eval; the
    energy net composed: no K3); the kernel generator against the composed
    plain one on the same noise (REFERENCE_BATCH; u's 1e-3, showers 5e-2 of
    scale, as cfm_phase); with ``profile`` one more request under
    torch.profiler. Returns (launches, seconds a request)."""
    (tmp / "data").mkdir()
    shape_tf, energy_tf = _family_run_dirs(tmp, family)
    view = _family_view(family, family_config(tmp, family, "shape", 1), shape_tf)
    shape_model, energy_model, gen = _models(shape_cfg, FAMILIES[family]["energy"], SEED)
    evals = shape_model.net_evals_per_sample()
    layout = dict(u_position=view.u_position, energy_cond_width=view.energy_cond_width)
    generator = Generator(shape_model, energy_model, energy_tf, shape_tf, BATCH, **layout)
    print(f"  shape model {shape_model.param_count()} params ({shape_model.token_shape(1)[1:]} "
          f"tokens x patch, {shape_model.net.cfg.num_heads} heads), energy model "
          f"{energy_model.param_count()} params, condition {layout}", flush=True)

    def request(i, batch=BATCH, gen_obj=generator, noise=None):
        cond = view.sampling_conditions(view.draw_conditions(
            batch, np.random.default_rng(SEED + 1 + i)))
        shower, full = gen_obj.generate(cond, seed=SEED + i, noise=noise)
        t_host = time.perf_counter()
        data = view.to_showers(shower.cpu().numpy(), full.cpu().numpy())
        return shower, full, data, time.perf_counter() - t_host

    for c in SERVING.values():
        c.reset()
    times, host = [], []
    for i in range(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, data, host_s = request(i)
        times.append(time.perf_counter() - t0)
        host.append(host_s)
        voxels = _check_showers(f"{family} request {i}", data, family)
        print(f"  request {i}: {BATCH} showers of {voxels} voxels in {times[-1]:.3f} s (the "
              f"inverse transforms on the host {host_s:.3f} s)", flush=True)
    launches = {k: c.launches for k, c in SERVING.items()}
    want = {k: requests * evals * FAMILY_PER_EVAL.get(k, 0) for k in SERVING}
    if launches != want:
        raise PhaseError(f"{family} serving: launches {launches}, expected {want}")
    launches = {k: v for k, v in launches.items() if v}
    print(f"  launches on the main path: {launches}", flush=True)

    plain_shape = _on_card(_with_net_param(shape_cfg, fused_block=False, attn_impl="xla")).eval()
    plain_energy = _on_card(FAMILIES[family]["energy"]).eval()
    plain_shape.load_state_dict(shape_model.state_dict())
    plain_energy.load_state_dict(energy_model.state_dict())
    nb = REFERENCE_BATCH
    noise = (torch.randn(energy_model.x_shape(nb), generator=gen, device="cuda"),
             torch.randn(shape_model.token_shape(nb), generator=gen, device="cuda"))
    kern = Generator(shape_model, energy_model, energy_tf, shape_tf, nb, **layout)
    plain = Generator(plain_shape, plain_energy, energy_tf, shape_tf, nb, **layout)
    basis_k, full_k, _, _ = request(0, nb, kern, noise)
    before = {k: c.launches for k, c in COMPOSED.items()}
    basis_p, full_p, _, _ = request(0, nb, plain, noise)
    if {k: c.launches for k, c in COMPOSED.items()} != before:
        raise PhaseError(f"{family}: the plain reference generator launched a kernel")
    u_err = (full_k - full_p).abs().max().item()
    s_err, s_scale = _rel_err(basis_k, basis_p)
    print(f"  reference (batch {nb}, composed plain nets, same noise): conditions max_abs_err "
          f"{u_err:.3e} (bound 1e-3), shower max_abs_err {s_err:.3e} (bound 5e-2 x scale "
          f"{s_scale:.3g})", flush=True)
    if not (u_err <= 1e-3 and s_err <= 5e-2 * s_scale):
        raise PhaseError(f"{family}: kernel generator disagrees with the composed plain one")
    del plain_shape, plain_energy, kern, plain

    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        # device events only: the composed energy net's ~100 host ops a net
        # eval make a CPU trace slow to reduce
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            request(requests)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _device_rows(prof)
        busy_ms = sum(r[0] for r in rows)
        print(f"  torch.profiler ({card}): one request, wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.4f}; "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in _grouped(rows, CFM_GROUPS).items()),
              flush=True)
    steady = times[1:] or times
    print(f"{family} serving: {BATCH * len(steady) / sum(steady):.2f} showers/s steady (first "
          f"request excluded), {BATCH * len(times) / sum(times):.2f} over all {len(times)}; "
          f"requests {[round(t, 4) for t in times]} s, the host inverse "
          f"{[round(t, 4) for t in host]} s; batch {BATCH}; on {card}", flush=True)
    del generator, shape_model, energy_model
    torch.cuda.empty_cache()
    return launches, times


def family_train_phase(tmp: Path, family, card):
    """The family's energy model FAMILY_ENERGY_STEPS steps, then its shape
    model FAMILY_TRAIN_STEPS steps at full width and the shipped batch
    (CaloGAN 64, LEMURS 64, CaloHadronic 32) through the experiment's
    ``train()`` on synthetic events in the family's raw layout (the
    transforms fitted on them, CaloHadronic's ECal sum-pooled from 30x180x180
    on the host in each batch). K1's launches exact: 6 forwards a step and
    a validation batch, 6 of each backward kernel a step (LEMURS's 135 and
    CaloHadronic's 606 tokens; none for CaloGAN's 84: the plain attention
    under ``auto``, as in JAX). One step profiled (device busy beside the
    host clock), and the collator's host seconds for one batch.
    CaloHadronic's runs read their events from record caches
    (``data.native_cache``, written from the events in memory by
    ``data/native_cache.py``; ``cache_phase`` holds their batches against
    the events'). Returns (K1 launches, the shape experiment, the energy
    experiment)."""
    data = tmp / "data"
    data.mkdir(exist_ok=True)
    _binning_xml(data, "ds2")  # LEMURS's evaluation features
    cls = SYNTHETIC[family]
    cache = tmp / "cache" if family in CACHE_FAMILIES else None
    energy_exp = cls(family_config(tmp, family, "energy", FAMILY_ENERGY_STEPS,
                                   native_cache=cache), device="cuda")
    energy_exp()
    _check_training(energy_exp, f"{family} energy")
    exp = cls(family_config(tmp, family, "shape", FAMILY_TRAIN_STEPS, native_cache=cache),
              device="cuda")
    for c in TRAINING.values():
        c.reset()
    exp()
    launches = {k: c.launches for k, c in TRAINING.items()}
    _check_training(exp, f"{family} shape")
    steps = len(exp.train_loss)
    val_batches = len(exp.val_loss) * exp._val_iterator.batches_per_epoch
    k1 = exp.model.token_shape(1)[1] >= 128
    want = {k: 6 * (steps + (val_batches if k == "qkv_attn_fwd" else 0)) * k1 for k in TRAINING}
    if steps != FAMILY_TRAIN_STEPS or launches != want:
        raise PhaseError(f"{family} train: {steps} steps, K1 launches {launches}, expected {want}")
    batch = int(exp.cfg.training.batchsize)
    steady = exp.step_times[2:]
    fed = [s + f for s, f in zip(steady, exp.fetch_times[2:])]
    collate = ""
    if hasattr(exp.val_dataset, "read_indices"):  # the lazy families collate each batch
        t0 = time.perf_counter()
        exp._val_iterator.collator(*exp.val_dataset.read_indices(np.arange(batch)))
        collate = (f"; the collator {time.perf_counter() - t0:.3f} s for a batch of {batch} on "
                   "the host")
    print(f"  energy: {len(energy_exp.train_loss)} steps of batch "
          f"{int(energy_exp.cfg.training.batchsize)}; shape: {steps} steps of batch {batch}, "
          f"{len(exp.val_loss)} validations ({val_batches} batches), loss "
          f"{exp.train_loss[0]:.4f} -> {exp.train_loss[-1]:.4f}", flush=True)
    print(f"{family} train: {steps / exp.train_seconds:.3f} steps/s over the whole train() loop, "
          f"{len(steady) / sum(steady):.3f} steady step interior, {len(fed) / sum(fed):.3f} "
          f"steady with each step's batch fetch{collate}; K1 launches "
          f"{ {k: v for k, v in launches.items() if v} }; on {card}", flush=True)
    train_profile_phase(exp, card)
    if cache is not None:
        cache_phase(exp, card)
    return {k: v for k, v in launches.items() if v}, exp, energy_exp


CACHE_FAMILIES = ("calohadronic",)


def cache_phase(exp, card, fetches=3):
    """The record caches a lazy family's run trained from (``data/
    native_cache.py``, built from the events in memory with the host's C++
    compiler): both splits' batches gathered from the caches equal the
    events' own (``ArrayEvents``, made again), bit for bit, classes
    included; the seconds of ``fetches`` gathers of a training batch, and of
    gather and collator, from each."""
    batch = int(exp.cfg.training.batchsize)
    rng = np.random.default_rng(SEED)
    plains = {}
    for split, files in (("train", exp.hdf5_dict_train), ("validation", exp.hdf5_dict_test)):
        cached = exp.train_dataset if split == "train" else exp.val_dataset
        if getattr(cached, "_native_cache", None) is None:
            raise PhaseError(f"cache: the {split} split does not read from a record cache")
        plain = plains[split] = exp.open_events(files)
        idx = rng.permutation(len(plain))[:batch]
        (got, got_cls), (want, want_cls) = cached.read_indices(idx), plain.read_indices(idx)
        if not np.array_equal(got_cls, want_cls) or got.keys() != want.keys() or not all(
                got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want):
            raise PhaseError(f"cache: a {split} batch differs from the events'")
    collator = exp._val_iterator.collator
    times = {}
    for name, ds in (("cache", exp.train_dataset), ("events in memory", plains["train"])):
        gather, fetch = [], []
        for i in range(fetches):
            idx = np.random.default_rng(SEED + i).permutation(len(ds))[:batch]
            t0 = time.perf_counter()
            read = ds.read_indices(idx)
            t1 = time.perf_counter()
            collator(*read)
            gather.append(t1 - t0)
            fetch.append(time.perf_counter() - t0)
        times[name] = (min(gather), min(fetch))
    print(f"  cache: batches of both splits equal the events' bit for bit; a batch of {batch}: "
          + ", ".join(f"{k} gather {g:.4f} s, gather and collate {f:.3f} s"
                      for k, (g, f) in times.items())
          + f" (best of {fetches}, host); {exp.train_dataset._native_cache.n_records} records of "
          f"{exp.train_dataset._native_cache.record_size} bytes; on {card}", flush=True)


# the autoregressive energy net at its defaults (models/ar_transformer.py:
# shape 45, 64 wide, 4 heads, 2 + 2 layers, RK4 step 0.05 a dimension); no
# shipped config names it
AR_STEPS = 5
AR_TRAIN_BATCH = 256


def ar_phase(card):
    """``ARtransformer`` at its defaults on the card: AR_STEPS train steps
    (cfm/energy.yaml's optimizer) on synthetic u-vectors, then one batch of
    BATCH sampled, 45 dimensions one after another, each a 1-D RK4 solve of
    80 evals; the samples finite and of the model's shape, the draws
    repeatable from a seed."""
    from vit4hep_tpu_torch.models.ar_transformer import ARtransformer

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.device("cuda"):
        model = ARtransformer({})
    d = model.cfg.dims_in
    draws = [(torch.rand(AR_TRAIN_BATCH, d, generator=gen, device="cuda"),
              torch.rand(AR_TRAIN_BATCH, 1, generator=gen, device="cuda"))
             for _ in range(AR_STEPS)]
    state = ts.create_train_state(model, Config(DS2_ENERGY_TRAINING), use_ema=False)
    step = ts.make_train_step(lambda x, c: model.batch_loss(x, c, gen),
                              clip_grad_norm=DS2_ENERGY_TRAINING["clip_grad_norm"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(state, batch)["loss"]) for batch in draws]
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    _finite("ar train loss", np.asarray(losses))
    cond = torch.rand(BATCH, 1, generator=gen, device="cuda")
    t0 = time.perf_counter()
    sample = model.sample_batch(cond, torch.Generator(device="cuda").manual_seed(SEED + 1))
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    again = model.sample_batch(cond[:8], torch.Generator(device="cuda").manual_seed(SEED + 2))
    if tuple(sample.shape) != (BATCH, d) or not torch.equal(
            again, model.sample_batch(cond[:8],
                                      torch.Generator(device="cuda").manual_seed(SEED + 2))):
        raise PhaseError(f"ar: samples of shape {tuple(sample.shape)} (expected {(BATCH, d)}), "
                         "or draws that do not repeat from a seed")
    _finite("ar samples", sample.cpu().numpy())
    print(f"ar: ARtransformer defaults ({model.param_count()} params, {d} dims, "
          f"{model.net_evals_per_sample()} subnet evals a sample): {AR_STEPS} train steps of "
          f"batch {AR_TRAIN_BATCH} in {t_train:.3f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"one batch of {BATCH} sampled in {t_sample:.3f} s ({BATCH / t_sample:.2f} "
          f"samples/s); on {card}", flush=True)


def family_parity_phase(family, batch):
    """3 train steps of the family's shape model with K1 (``attn_impl:
    auto``) against the plain attention (``xla``) from one state, TRAIN_TOL
    (``parity_phase``), every K1 kernel on every block of every step."""
    cfg = FAMILIES[family]["shape"]
    data_shape = (batch, *LEMURS_GRID) if family == "lemurs" else None
    return parity_phase(f"{family}, K1 against the plain attention", cfg,
                        _with_net_param(cfg, attn_impl="xla"), batch, TRAINING,
                        {k: 6 * TRAIN_PARITY_STEPS for k in TRAINING}, TRAIN_TOL,
                        FAMILIES[family]["training"], data_shape)


def family_sampling_phase(family, exp, energy_exp, card):
    """``sample_n`` of FAMILY_SAMPLES showers of the trained shape run
    (warm-started from ``model_run0.pt``) on the energy run's u's, staged
    (``sample_us``) and through the fused chain (``fused_generation``) on
    the same conditions and noise: K2v's launches exact on each path, the
    path that ran the one asked for, the fused chain held against the
    staged path (conditions SAMPLING_U_TOL, showers SAMPLING_TOL of scale);
    then ``plot``'s inverse (``to_showers``) and its evaluation on arrays
    against the synthetic test events (one classifier epoch; CaloGAN's DNN
    on the 504 voxels, LEMURS's all-cls, CaloHadronic's feature DNN; no
    plots, no HDF5). Returns {path: launches}."""
    cfg = Config(exp.cfg.to_container(resolve=False))
    cfg.train, cfg.sample_us, cfg.energy_model = False, True, energy_exp.cfg.run_dir
    cfg.evaluation = dict(cfg.evaluation, eval_mode="all-cls", eval_cls_n_epochs=1,
                          eval_cls_resnet_n_epochs=1)
    sexp = SYNTHETIC[family](cfg, device="cuda")
    sexp.energy_cfg = energy_exp.cfg
    sexp()
    sexp._energy_model_for_cfg()
    n, bs = FAMILY_SAMPLES, int(sexp.cfg.training.batchsize_sample)
    batches = -(-n // bs)
    evals = sexp.model.net_evals_per_sample()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    noise = tuple([torch.randn(shape, generator=g, device="cuda") for _ in range(batches)]
                  for shape in (sexp.energy_model.x_shape(bs), sexp.model.token_shape(bs)))
    conditions = sexp.draw_conditions(n, np.random.default_rng(SEED + 13))
    want = {k: batches * evals * FAMILY_PER_EVAL.get(k, 0) for k in SERVING}
    out, launches = {}, {}
    for fused in (False, True):
        path = f"{family}_sampling{'_fused' if fused else ''}"
        sexp.cfg.fused_generation = fused
        for c in SERVING.values():
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[fused] = sexp.sample_n(noise=noise, conditions=conditions)
        seconds = time.perf_counter() - t0
        got = {k: c.launches for k, c in SERVING.items()}
        if sexp.last_sampling_fused != fused:
            raise PhaseError(f"{path}: fused_generation {fused}, but the "
                             f"{'fused' if sexp.last_sampling_fused else 'staged'} path ran")
        if got != want:
            raise PhaseError(f"{path}: launches {got}, expected {want}")
        _finite(path, *out[fused])
        launches[path] = {k: v for k, v in got.items() if v}
        print(f"  {path}: {n} showers in {seconds:.3f} s = {n / seconds:.2f} showers/s (host "
              f"clock, {batches} batches of {bs}, the host transforms included; on {card}); "
              f"launches {launches[path]}", flush=True)
    (staged, c_staged), (fused, c_fused) = out[False], out[True]
    errs = {"conditions": _scaled_err(c_fused, c_staged), "showers": _scaled_err(fused, staged)}
    print(f"  {family} fused chain vs staged path on the same noise (max error over scale): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    if errs["conditions"] > SAMPLING_U_TOL or errs["showers"] > SAMPLING_TOL:
        raise PhaseError(f"{family} sampling parity: {errs} (bounds {SAMPLING_U_TOL}, "
                         f"{SAMPLING_TOL})")

    from vit4hep_tpu_torch.evaluation.calogan import evaluate_calogan, reference_showers
    from vit4hep_tpu_torch.evaluation.calohadronic import evaluate_calohad
    from vit4hep_tpu_torch.evaluation.lemurs import evaluate_lemurs

    data = sexp.to_showers(staged, c_staged)
    voxels = _check_showers(f"{family} to_showers", data, family)
    t0 = time.perf_counter()
    if family == "calogan":
        ref = family_events(family, n, SEED + 7)
        scores = {"low-level": evaluate_calogan(
            np.concatenate([data[f"layer_{i}"] for i in range(3)], axis=1),
            reference_showers(ref), sexp.cfg, device="cuda")[1:]}
    elif family == "lemurs":
        ref = family_events(family, n, SEED + 7)
        results = evaluate_lemurs(data["showers"], data["incident_energy"],
                                  data["incident_theta"], data["incident_phi"], ref, sexp.cfg,
                                  device="cuda")
        scores = {k: (r["auc"], r["jsd"]) for k, r in results.items()}
        if set(scores) != {"cls-low", "cls-high", "cls-resnet"}:
            raise PhaseError(f"lemurs all-cls ran {sorted(scores)}")
    else:
        ref = family_events(family, 64, SEED + 7)
        scores = {"features": evaluate_calohad(data["ecal"], data["hcal"], data["energy"], ref,
                                               sexp.cfg, device="cuda", draw=False)[1:]}
    seconds = time.perf_counter() - t0
    for key, (auc, jsd) in scores.items():
        if not np.isfinite([auc, jsd]).all():
            raise PhaseError(f"{family} evaluation {key}: AUC {auc}, JSD {jsd}")
    print(f"  {family} plot's evaluation on arrays ({n} showers of {voxels} voxels): "
          + ", ".join(f"{k} AUC {a:.4f} JSD {j:.4f}" for k, (a, j) in scores.items())
          + f" in {seconds:.2f} s; on {card}", flush=True)
    del sexp
    torch.cuda.empty_cache()
    return launches


# the family paths of main(): (path, family, shape model, requests, profiled)
FAMILY_SERVING = (("calogan_serving", "calogan", CALOGAN_SHAPE_MODEL, REQUESTS, True),
                  ("lemurs_serving", "lemurs", LEMURS_SHAPE_MODEL, REQUESTS, True),
                  ("calohad_serving", "calohadronic", CALOHAD_SHAPE_MODEL, REQUESTS, True),
                  ("calohad_tpu_serving", "calohadronic", CALOHAD_TPU_MODEL, 1, False))
# (family, the batch of its K1 parity, 0 for none: CaloGAN's 84 tokens take
# the plain attention)
FAMILY_TRAIN = (("calogan", 0), ("lemurs", 64), ("calohadronic", 32))


# ---------------------------------------------------------------------------
# cross-dataset fine-tuning: calochallenge_ds2tods3_ft, calohadronic_ft
# ---------------------------------------------------------------------------
# the finetuning: blocks of configs/calochallenge/finetuning/calochallenge_ds2tods3_ft.yaml
# and configs/calohadronic/calohadronic_ft.yaml (the backbone's config is handed
# in from memory: backbone_run_config)
DS2TODS3_FINETUNING = {
    "backbone_cfg": "./runs/CaloChallenge/calochallenge_ds2/config_0.yaml", "backbone_lr": 1e-4,
    "head_lr": 5e-4, "embedder_lr": 5e-4, "map_x_embedding": True, "map_c_embedding": False,
    "reinitialize_x_embedding": True, "reinitialize_c_embedding": False,
    "reinitialize_pos_embedding": True, "reinitialize_final_layer": True, "interpolate": True}
CALOHAD_FINETUNING = dict(
    DS2TODS3_FINETUNING, backbone_cfg="./runs/lemurs_all/lemurs_00000/config_1.yaml",
    map_x_embedding=False, reinitialize_c_embedding=True, interpolate=False)
LEMURS_CONDITIONS = {"gen_theta": 0.5, "gen_phi": 0.5, "gen_label": [0.2, 0.2, 0.2, 0.2, 0.2]}
# data.transforms of calochallenge_ds2tods3_ft.yaml: calochallenge_ds3.yaml's,
# the standardization fitted with the zeros
DS2TODS3_TRANSFORMS = dict(DS3_SHAPE_TRANSFORMS, GlobalStandardizeFromFile={
    "model_dir": None, "exclude_zeros": False})
# configs/model/cfm_calohad/cfm_calohad_ft.yaml: cfm_calohad on 66 conditions
# [58 u's | E | theta, phi, 5 labels]; the data.transforms of calohadronic_ft.yaml
CALOHAD_FT_MODEL = _with_net_param(CALOHAD_SHAPE_MODEL, condition_dim=66)
CALOHAD_FT_TRANSFORMS = {**CALOHAD_SHAPE_TRANSFORMS, "AddLEMURSConditions": {
    "theta": "${gen_theta}", "phi": "${gen_phi}", "label": "${gen_label}"}}
# the fine-tune parity: TRAIN_TOL's reasoning, its parameter bound (half of one
# step's lr) taken per group at the group's own lr (5e-4 for the head and the
# embedders: a key bias's noise moves 5x as far there)
FT_PARAM_TOL = TRAIN_TOL["param_abs"] / DS2_SHAPE_TRAINING["lr"]
FT_TRAIN_TOL = {"loss": TRAIN_TOL["loss"], "param_abs_over_lr": FT_PARAM_TOL,
                "update_rel": TRAIN_TOL["update_rel"]}
FT_TRAIN_STEPS = 10  # ds2tods3_ft: cfm/shape.yaml's batch 64 (iterations 800,000)
FT_SAMPLES = 512  # ds2tods3_ft's sample_n: 2 batches of 256 (n_samples 100,000)
CALOHAD_FT_STEPS = 5  # calohadronic_ft: shape_calohadronic.yaml's batch 32 (1,200,000)


class _BackboneInMemory:
    """The backbone run's config from memory (the card's machine has no
    PyYAML to read its ``config_<idx>.yaml``)."""

    backbone_cfg_mem = None

    def backbone_run_config(self):
        return Config(self.backbone_cfg_mem.to_container(resolve=False))


class SyntheticFTDS3(_BackboneInMemory, _EnergyRunInMemory, CaloChallengeFTCFM,
                     SyntheticCaloChallengeDS3):
    """calochallenge_ds2tods3_ft on synthetic ds3 showers."""


class SyntheticCaloHadronicFT(_BackboneInMemory, _SyntheticLazyFamily, CaloHadronicFT):
    """calohadronic_ft on synthetic CaloHadronic events."""

    family = "calohadronic"


def backbone_run(tmp: Path, name, model_cfg, seed):
    """A backbone run at full width with random weights from ``seed``: its
    config (run dir, run 0, the model) and ``models/model_run0.pt`` written
    through ``save_checkpoint``, and the same weights in the reference's
    layout (``module.net.`` prefixes, the positional grids as buffers) in a
    second run dir. Returns (the port run's config, the reference run's,
    the net's weights on the host)."""
    run, ref = tmp / f"{name}_run", tmp / f"{name}_reference"
    model = _on_card(model_cfg)
    _randomize(model, torch.Generator(device="cuda").manual_seed(seed))
    cfg = Config({"exp_name": name, "exp_type": "calochallenge", "run_name": "run",
                  "run_dir": str(run), "run_idx": 0, "ema": False, "model": model_cfg})
    save_checkpoint(run / "models" / "model_run0.pt",
                    ts.create_train_state(model, Config(DS2_SHAPE_TRAINING), False))
    weights = {k: v.detach().cpu().clone() for k, v in model.net.state_dict().items()}
    sd = {f"module.net.{k}": v for k, v in weights.items()}
    grids = create_meshgrid(tuple(tuple(g) for g in model_cfg["net"]["param"]["num_patches"]))
    sd.update({f"module.net.{k}": torch.from_numpy(g)
               for k, g in zip(("pos_z", "pos_y", "pos_x"), grids)})
    (ref / "models").mkdir(parents=True)
    torch.save({"model": sd, "optimizer": {}, "scheduler": {}, "ema": None},
               ref / "models" / "model_run0.pt")
    ref_cfg = Config(cfg.to_container(resolve=False))
    ref_cfg.run_dir = str(ref)
    for label, c, migrated in (("port", cfg, False), ("reference", ref_cfg, True)):
        got, was = load_net_state_dict(c.model, Path(c.run_dir) / "models" / "model_run0.pt")
        if was != migrated or got.keys() != weights.keys() or \
                not all(torch.equal(got[k].cpu(), v) for k, v in weights.items()):
            raise PhaseError(f"{name}: the {label} checkpoint does not read back bit for bit")
    del model
    return cfg, ref_cfg, weights


def energy_run(tmp: Path, geometry, model_cfg, transforms):
    """An energy run dir of the geometry: its config, ``model_run0.pt`` with
    random weights (through ``save_checkpoint``) and u statistics; the
    config is handed to the shape experiment in memory."""
    cfg = _experiment_config(tmp, model_cfg, transforms, DS2_ENERGY_TRAINING, "energy",
                             [0.9999, 0.0001], geometry)
    run = tmp / f"energy_{geometry}"
    cfg.run_dir, cfg.run_idx = str(run), 0
    model = _on_card(model_cfg)
    _randomize(model, torch.Generator(device="cuda").manual_seed(SEED + 23))
    save_checkpoint(run / "models" / "model_run0.pt",
                    ts.create_train_state(model, Config(DS2_ENERGY_TRAINING), False))
    rng = np.random.default_rng(SEED)
    n_layers = len(GEOMETRY[geometry])
    np.save(run / "means_u.npy", rng.normal(0.0, 0.3, n_layers).astype(np.float32))
    np.save(run / "stds_u.npy", rng.uniform(0.8, 1.5, n_layers).astype(np.float32))
    return cfg


def _groups_moved(state, before, wd):
    """Each group's largest parameter change in the first step over its own
    lr: Adam's first update is lr x g / (|g| + eps) (+ lr x wd x p), so the
    largest entry of a group with gradients well above eps moves by its lr
    up to the decay term. Raises unless every group's ratio lies in [0.99,
    1 + wd x max |p| + 0.01]."""
    ratios = []
    for group, lr in zip(state.optimizer.param_groups, state.schedule.base_lrs):
        moved = max((p.detach() - before[id(p)]).abs().max().item() for p in group["params"])
        top = max(before[id(p)].abs().max().item() for p in group["params"])
        ratios.append(moved / lr)
        if not 0.99 <= ratios[-1] <= 1 + wd * top + 0.01:
            raise PhaseError(f"fine-tuning: a group of lr {lr:g} moved {moved:.3e} in its first "
                             f"step ({ratios[-1]:.3f} x its lr)")
    return ratios


def ft_parity_phase(exp):
    """TRAIN_PARITY_STEPS steps of the fine-tune model with K1 (attn_impl
    auto) against the f32 plain attention (xla), from the trained run's
    state, each with the three-group optimizer of the run's config, on the
    same batches and (t, x_0): FT_TRAIN_TOL; K1's four kernels on every
    block of every step; each group's first step moved by its own lr.
    Returns (worst errors, K1 launches)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    init = {k: v.detach().clone() for k, v in exp.model.state_dict().items()}
    tcfg = exp.cfg.training
    models, states, steps = {}, {}, {}
    for impl in ("auto", "xla"):
        model = copy.deepcopy(exp.model)
        for block in model.net.blocks:
            block.attn.attn_impl = impl
        models[impl] = model
        states[impl] = ts.create_train_state(model, tcfg, False, ft.ft_param_groups(
            model.net, tcfg, exp.cfg.finetuning))
        steps[impl] = ts.make_train_step(
            lambda x, c, t, x_0, model=model: model.batch_loss(x, c, t=t, x_0=x_0),
            clip_grad_norm=float(tcfg.clip_grad_norm))
    layers, energy = exp.train_dataset.layers, exp.train_dataset.energy
    worst, ratios = {"loss": 0.0}, None
    for c in TRAINING.values():
        c.reset()
    for i in range(TRAIN_PARITY_STEPS):
        sl = slice(64 * i, 64 * (i + 1))
        x = torch.as_tensor(layers[sl], device="cuda")
        c = torch.as_tensor(energy[sl], device="cuda")
        t = torch.rand((64, 1, 1, 1, 1), generator=gen, device="cuda")
        x_0 = torch.randn(x.shape, generator=gen, device="cuda")
        before = {id(p): p.detach().clone() for p in states["auto"].params} if i == 0 else None
        m = {impl: steps[impl](states[impl], (x, c, t, x_0)) for impl in steps}
        if before is not None:
            ratios = _groups_moved(states["auto"], before, float(tcfg.weight_decay))
        rel = abs(float(m["auto"]["loss"]) - float(m["xla"]["loss"])) / abs(float(m["xla"]["loss"]))
        worst["loss"] = max(worst["loss"], rel)
    launches = {k: c.launches for k, c in TRAINING.items()}
    if launches != {k: 6 * TRAIN_PARITY_STEPS for k in TRAINING}:
        raise PhaseError(f"fine-tune parity: K1 launches {launches}, expected 6 blocks x "
                         f"{TRAIN_PARITY_STEPS} steps of each kernel")
    pk, pp = (dict(models[i].named_parameters()) for i in ("auto", "xla"))
    lr_of = {id(p): lr for g, lr in zip(states["xla"].optimizer.param_groups,
                                        states["xla"].schedule.base_lrs) for p in g["params"]}
    worst["param_abs_over_lr"] = max((pk[n] - pp[n]).abs().max().item() / lr_of[id(pp[n])]
                                     for n in pp)
    du = torch.cat([(pk[n] - init[n]).flatten() for n in pp])
    dp = torch.cat([(pp[n] - init[n]).flatten() for n in pp])
    worst["update_rel"] = ((du - dp).norm() / dp.norm()).item()
    ok = all(worst[k] <= FT_TRAIN_TOL[k] for k in FT_TRAIN_TOL)
    print(f"  {TRAIN_PARITY_STEPS} steps, three groups (lr {states['auto'].schedule.base_lrs}), "
          f"K1 vs the plain attention: loss rel {worst['loss']:.3e}, param max abs over its "
          f"group's lr {worst['param_abs_over_lr']:.3e}, update rel {worst['update_rel']:.3e} "
          f"(bounds {FT_TRAIN_TOL}) {'ok' if ok else 'FAILED'}; first step's largest change over "
          f"each group's lr "
          f"(backbone, head, embedder): {[round(r, 4) for r in ratios]}", flush=True)
    if not ok:
        raise PhaseError("fine-tune parity: K1 training disagrees with the plain attention")
    del models, states
    return worst, launches


def ft_net_hold(exp, n=8):
    """The fine-tune net's kernel twin (x_mapper 90 -> 48 in front of K2v,
    K2v's embedding product K 48, its final product N 90) against the
    composed f32 net (attn_impl xla) on the same tokens: K2v's whole-forward
    bound (TOL["fused_vit_forward"]), untimed and off the main path."""
    net = exp.model.net
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    tokens = torch.randn(n, 450, net.cfg.in_patch_dim, generator=gen, device="cuda")
    t = torch.rand(n, 1, generator=gen, device="cuda")
    c = torch.rand(n, net.cfg.condition_dim, generator=gen, device="cuda")
    plain = copy.deepcopy(net)
    plain.cfg = dataclasses.replace(net.cfg, fused_block=False)
    for block in plain.blocks:
        block.attn.attn_impl = "xla"
    with torch.no_grad():
        twin = sampling_variant(net)
        _hold("fused_vit_forward", f"the fine-tune net (x_mapper {net.cfg.in_patch_dim} -> "
              f"{net.cfg.patch_dim}, final {net.cfg.out_patch_dim}) at tokens ({n}, 450, "
              f"{net.cfg.in_patch_dim})", twin(tokens, t, c), plain(tokens, t, c))
    del plain, twin


def ft_ds3_phase(tmp: Path, card):
    """calochallenge_ds2tods3_ft through the experiment at full width: a ds2
    backbone (cfm_ds2_electrons, random weights) read from its reference-
    layout copy, the fine-tune net (x_mapper 90 -> 48, the backbone's
    embedder reinitialised as the config says, the FinalLayer back to 90)
    trained FT_TRAIN_STEPS steps at batch 64 on synthetic ds3 showers (K1's
    launches exact), held against the plain attention (``ft_parity_phase``)
    and its net's kernel twin against the composed net (``ft_net_hold``);
    then a warm start restores the three groups and ``sample_n`` draws
    FT_SAMPLES showers behind a ds3 energy CFM (random weights), staged and
    fused, K3's and K2v's launches exact and the path that ran the one asked
    for. Returns {path: launches}."""
    data = tmp / "data"
    data.mkdir(exist_ok=True)
    _binning_xml(data, "ds3")
    bb_cfg, ref_cfg, bb_weights = backbone_run(tmp, "ds2_backbone", DS2_SHAPE_MODEL, SEED + 21)
    energy_cfg = energy_run(tmp, "ds3", DS3_ENERGY_MODEL, DS3_ENERGY_TRANSFORMS)
    training = dict(DS2_SHAPE_TRAINING, iterations=FT_TRAIN_STEPS,
                    validate_every_n_steps=FT_TRAIN_STEPS // 2)
    cfg = _experiment_config(tmp, DS3_SHAPE_MODEL, DS2TODS3_TRANSFORMS, training, "shape",
                             [0.99, 0.01], "ds3")
    cfg.exp_type, cfg.exp_name = "calochallenge_ft_cfm", "smoke_ds2tods3_ft"
    cfg.finetuning = dict(DS2TODS3_FINETUNING)
    cfg.sample_us, cfg.n_samples, cfg.energy_model = True, FT_SAMPLES, energy_cfg.run_dir
    cfg.evaluation = {"eval_dataset": "3"}
    exp = SyntheticFTDS3(cfg, device="cuda")
    exp.backbone_cfg_mem, exp.energy_cfg = ref_cfg, energy_cfg
    for c in TRAINING.values():
        c.reset()
    exp()
    launches = {"ds2tods3_ft_train": {k: c.launches for k, c in TRAINING.items()}}
    _check_training(exp, "ds2tods3_ft")
    net = exp.model.net
    shapes = (net.cfg.in_patch_dim, net.cfg.patch_dim, net.cfg.out_patch_dim)
    if shapes != (90, 48, 90) or exp.state.schedule.base_lrs != [1e-4, 5e-4, 5e-4]:
        raise PhaseError(f"ds2tods3_ft: net (in, patch, out) {shapes}, group lrs "
                         f"{exp.state.schedule.base_lrs}")
    if net.x_mapper.weight.device.type != "cuda":
        raise PhaseError("ds2tods3_ft: the net is not on the card")
    steps = len(exp.train_loss)
    val_batches = len(exp.val_loss) * exp._val_iterator.batches_per_epoch
    want = {"qkv_attn_fwd": 6 * (steps + val_batches), "qkv_attn_bwd_delta": 6 * steps,
            "qkv_attn_bwd_dkv": 6 * steps, "qkv_attn_bwd_dq": 6 * steps}
    if steps != FT_TRAIN_STEPS or launches["ds2tods3_ft_train"] != want:
        raise PhaseError(f"ds2tods3_ft: {steps} steps, K1 launches "
                         f"{launches['ds2tods3_ft_train']}, expected {want}")
    steady = exp.step_times[2:]
    print(f"  backbone {sum(v.numel() for v in bb_weights.values())} params (read from its "
          f"reference-layout copy); fine-tune net {exp.model.param_count()} params, x_mapper "
          f"{shapes[0]} -> {shapes[1]}, out {shapes[2]}; {steps} steps, {len(exp.val_loss)} "
          f"validations: loss {exp.train_loss[0]:.4f} -> {exp.train_loss[-1]:.4f}; K1 launches "
          f"{launches['ds2tods3_ft_train']}", flush=True)
    print(f"ds2tods3_ft train: {steps / exp.train_seconds:.3f} steps/s over the whole train() "
          f"loop, {len(steady) / sum(steady):.3f} steady step interior (steps 3-{steps}); batch "
          f"{int(cfg.training.batchsize)}; on {card}", flush=True)
    train_profile_phase(exp, card)
    _, launches["ds2tods3_ft_parity"] = ft_parity_phase(exp)
    ft_net_hold(exp)
    torch.cuda.empty_cache()

    # a warm start of the fine-tune run: the three groups restored exactly
    run = Path(exp.cfg.run_dir)
    saved = torch.load(run / "models" / "model_run0.pt", map_location="cpu", weights_only=True)
    cfg1 = Config(exp.cfg.to_container(resolve=False))
    cfg1.train = False
    del exp
    sexp = SyntheticFTDS3(cfg1, device="cuda")
    sexp.backbone_cfg_mem, sexp.energy_cfg = ref_cfg, energy_cfg
    sexp()
    state = sexp.state
    same = (state.step == saved["step"] == FT_TRAIN_STEPS
            and state.schedule.base_lrs == saved["schedule"]["base_lrs"] == [1e-4, 5e-4, 5e-4]
            and all(torch.equal(v.cpu(), saved["model"][k])
                    for k, v in sexp.model.state_dict().items())
            and all(torch.equal(m[key].cpu(), s[key])
                    for m, s in zip(state.optimizer.state_dict()["state"].values(),
                                    saved["optimizer"]["state"].values())
                    for key in ("exp_avg", "exp_avg_sq")))
    if not same:
        raise PhaseError("ds2tods3_ft warm start: the restored state differs from model_run0.pt")
    print("  warm start: the three groups' moments, lrs and schedule restored exactly", flush=True)

    n, bs = FT_SAMPLES, int(sexp.cfg.training.batchsize_sample)
    batches = -(-n // bs)
    evals = sexp.model.net_evals_per_sample()
    want = {k: batches * evals * per for k, per in CFM_PER_EVAL.items()}
    rates = {}
    for path, fused in (("ds2tods3_ft_sampling", False), ("ds2tods3_ft_sampling_fused", True)):
        sexp.cfg.fused_generation = fused
        samples, cond, got, seconds = _experiment_samples(sexp, path, card)
        if samples.shape != (n, 1, 45, 50, 18) or cond.shape != (n, 46):
            raise PhaseError(f"{path}: samples {samples.shape}, conditions {cond.shape}")
        _finite(path, samples, cond)
        if sexp.last_sampling_fused != fused:
            raise PhaseError(f"{path}: fused_generation {fused}, but the "
                             f"{'fused' if sexp.last_sampling_fused else 'staged'} path ran")
        if got != want:
            raise PhaseError(f"{path}: launches {got}, expected {want} ({batches} batches x "
                             f"{evals} evals x CFM_PER_EVAL)")
        launches[path], rates[path] = got, n / seconds
        print(f"  launches on the main path: {got}", flush=True)
    mev, _ = sexp.to_mev(samples, cond)
    _finite("ds2tods3_ft to_mev", mev)
    print(f"ds2tods3_ft sampling: staged {rates['ds2tods3_ft_sampling']:.2f} showers/s, fused "
          f"{rates['ds2tods3_ft_sampling_fused']:.2f} (host clock, {n} showers); MeV showers "
          f"{mev.shape}; on {card}", flush=True)
    del sexp
    torch.cuda.empty_cache()
    return launches


def ft_calohad_phase(tmp: Path, card):
    """calohadronic_ft from a LEMURS backbone (cfm_lemurs, random weights):
    the embedders, the positional frequencies and the FinalLayer
    reinitialised (606 tokens x 75, 66 conditions), CALOHAD_FT_STEPS steps
    at batch 32 through the experiment on synthetic events (K1's launches
    exact), then one request of BATCH through ``utils/serving.Generator``
    behind a CaloHadronic energy CFM (random weights): the conditions [u |
    E | theta, phi, label], K2v's launches exact, the showers reversed to
    GeV; the request again under torch.profiler for its device busy time.
    Returns {path: launches}."""
    data = tmp / "data"
    data.mkdir(exist_ok=True)
    bb_cfg, _, _ = backbone_run(tmp, "lemurs_backbone", LEMURS_SHAPE_MODEL, SEED + 29)
    cfg = family_config(tmp, "calohadronic", "shape", CALOHAD_FT_STEPS, model=CALOHAD_FT_MODEL)
    cfg.exp_type, cfg.exp_name = "calohadronic_ft", "smoke_calohadronic_ft"
    cfg.finetuning = dict(CALOHAD_FINETUNING)
    for k, v in LEMURS_CONDITIONS.items():
        cfg[k] = v
    cfg.data.transforms = dict(CALOHAD_FT_TRANSFORMS)
    exp = SyntheticCaloHadronicFT(cfg, device="cuda")
    exp.backbone_cfg_mem = bb_cfg
    for c in TRAINING.values():
        c.reset()
    exp()
    got = {k: c.launches for k, c in TRAINING.items()}
    _check_training(exp, "calohadronic_ft")
    steps = len(exp.train_loss)
    val_batches = len(exp.val_loss) * exp._val_iterator.batches_per_epoch
    want = {k: 6 * (steps + (val_batches if k == "qkv_attn_fwd" else 0)) for k in TRAINING}
    if steps != CALOHAD_FT_STEPS or got != want:
        raise PhaseError(f"calohadronic_ft: {steps} steps, K1 launches {got}, expected {want}")
    net = exp.model.net
    if (exp.model.token_shape(1)[1:], net.cfg.condition_dim) != ((606, 75), 66):
        raise PhaseError(f"calohadronic_ft: tokens {exp.model.token_shape(1)}, conditions "
                         f"{net.cfg.condition_dim}")
    steady = exp.step_times[2:]
    fed = [s + f for s, f in zip(steady, exp.fetch_times[2:])]
    print(f"calohadronic_ft train: {steps} steps of batch {int(exp.cfg.training.batchsize)}, loss "
          f"{exp.train_loss[0]:.4f} -> {exp.train_loss[-1]:.4f}; {steps / exp.train_seconds:.3f} "
          f"steps/s over the whole train() loop, {len(steady) / sum(steady):.3f} steady step "
          f"interior, {len(fed) / sum(fed):.3f} with each step's batch fetch; K1 launches {got}; "
          f"on {card}", flush=True)
    launches = {"calohad_ft_train": got}

    f = FAMILIES["calohadronic"]
    energy_dir = tmp / "calohad_energy_run"
    energy_dir.mkdir()
    rng = np.random.default_rng(SEED)
    np.save(energy_dir / "means_u.npy", rng.normal(0.0, 0.3, f["n_us"]).astype(np.float32))
    np.save(energy_dir / "stds_u.npy", rng.uniform(0.8, 1.5, f["n_us"]).astype(np.float32))
    energy_tf = CaloHadronic.pipeline(f["energy_tf"], str(energy_dir))
    energy_model = _on_card(f["energy"]).eval()
    _randomize(energy_model, torch.Generator(device="cuda").manual_seed(SEED + 31))
    exp.model.eval()
    generator = Generator(exp.model, energy_model, energy_tf, exp.transforms, BATCH,
                          u_position=exp.u_position, energy_cond_width=exp.energy_cond_width)
    cond = exp.sampling_conditions(exp.draw_conditions(BATCH, np.random.default_rng(SEED + 3)))
    evals = exp.model.net_evals_per_sample()

    def request():
        shower, full = generator.generate(cond, seed=SEED)
        return exp.to_showers(shower.cpu().numpy(), full.cpu().numpy()), full

    for c in SERVING.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data_out, full = request()
    seconds = time.perf_counter() - t0
    got = {k: c.launches for k, c in SERVING.items()}
    want = {k: evals * FAMILY_PER_EVAL.get(k, 0) for k in SERVING}
    if got != want:
        raise PhaseError(f"calohadronic_ft serving: launches {got}, expected {want}")
    voxels = _check_showers("calohadronic_ft request", data_out, "calohadronic")
    extra = np.tile(np.float32([0.5, 0.5] + [0.2] * 5), (BATCH, 1))
    if full.shape != (BATCH, 66) or not np.array_equal(full[:, 59:].cpu().numpy(), extra):
        raise PhaseError(f"calohadronic_ft serving: conditions {tuple(full.shape)}, their last "
                         "columns not the fixed LEMURS conditions")
    launches["calohad_ft_serving"] = {k: v for k, v in got.items() if v}
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    print(f"  launches on the main path: {launches['calohad_ft_serving']}; torch.profiler: one "
          f"request, wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in _grouped(rows, CFM_GROUPS).items()),
          flush=True)
    print(f"calohadronic_ft serving: one request of {BATCH} showers of {voxels} voxels in "
          f"{seconds:.3f} s = {BATCH / seconds:.2f} showers/s (first request, the host inverse "
          f"included); on {card}", flush=True)
    del exp, generator, energy_model
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------------------
# the parallel layer (parallel/): data parallelism through the launcher,
# NCCL, tensor parallelism, the GPipe pipeline and ring attention, each in
# child processes (ranks) of this script on the one card
# ---------------------------------------------------------------------------
PARALLEL_STEPS = 10  # the launcher runs: shape.yaml's batch 64 (the global one)
PARALLEL_SAMPLE_BATCH = 256  # the TP sample: batchsize_sample
PIPE_BATCH, PIPE_MICRO = 4, 2  # the pipeline: 2 stages of 3 blocks, 2 microbatches
RING_SHAPE = (8, 6, 450, 80)  # ds3's attention: B 8, 6 heads, 450 tokens, 80
CHILD_TIMEOUT = 300  # seconds a rank may take (the build is done before)
# the checks of the phase, each a one-rank run on the same card against the
# ranks' (f32 both sides; the ranks run the same kernels on parts of the same
# work, so they differ by summation order only: a row-parallel product
# summed as two halves and an all-reduce, a gradient averaged over two
# halves of the batch):
# - losses per step within TRAIN_TOL's 1e-4 relative, the gradients of the
#   TP step within 1e-4 relative L2 over the whole vector, its parameters
#   within TRAIN_TOL's param_abs and update_rel;
# - the TP sample (the gathered weights are the one-rank weights bit for
#   bit, through the same K3 and K2v) within 1e-5 of its scale;
# - the pipeline (the same K1 and cuBLAS products on microbatches of 2)
#   within 1e-4 of the output's scale and 1e-3 relative L2 per block's
#   gradient (through up to 6 blocks);
# - ring attention (f32 products, the softmax online over 2 blocks) within
#   1e-5 of the output's scale and 1e-4 relative L2 for each gradient.
PARALLEL_TOL = {"loss": TRAIN_TOL["loss"], "grad_rel_l2": 1e-4,
                "param_abs": TRAIN_TOL["param_abs"], "update_rel": TRAIN_TOL["update_rel"],
                "sample": 1e-5, "pipe_out": 1e-4, "pipe_grad_rel_l2": 1e-3, "ring_out": 1e-5,
                "ring_grad_rel_l2": 1e-4}
COUNTERS = {**COMPOSED, **FUSED_TRAINING, "binned_rqs_inverse": fsp.INVERSE}


def _counts():
    return {k: c.launches for k, c in COUNTERS.items() if c.launches}


def _reset():
    for c in COUNTERS.values():
        c.reset()


def _parallel_config(tmp: Path):
    """ds2 shape training at full width on synthetic showers (train_phase's
    config at PARALLEL_STEPS steps, validating after the last)."""
    training = dict(DS2_SHAPE_TRAINING, iterations=PARALLEL_STEPS,
                    validate_every_n_steps=PARALLEL_STEPS)
    (tmp / "data").mkdir(parents=True, exist_ok=True)
    _binning_xml(tmp / "data", "ds2")
    # 64 validation events: one batch of 64, whole on one rank and on two
    cfg = _experiment_config(tmp, DS2_SHAPE_MODEL, DS2_SHAPE_TRANSFORMS, training, "shape",
                             [0.975, 0.025])
    cfg.distributed = True
    return cfg


def _rel_l2(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _scaled(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _flat(tensors):
    return torch.cat([t.detach().float().reshape(-1).cpu() for t in tensors])


def _tp_inputs():
    """The TP step's batch (x, c, t, x_0) at the ds2 training shape, and the
    sample's noise, from a seeded generator on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    x = torch.randn((64, 1, 45, 16, 9), generator=gen, device="cuda")
    c = torch.rand((64, 46), generator=gen, device="cuda")
    t = torch.rand((64, 1, 1, 1, 1), generator=gen, device="cuda")
    x_0 = torch.randn(x.shape, generator=gen, device="cuda")
    b = PARALLEL_SAMPLE_BATCH
    e_cond = torch.rand((b, 1), generator=gen, device="cuda")
    e_noise = torch.randn((b, 45), generator=gen, device="cuda")
    s_noise = torch.randn((b, 135, 48), generator=gen, device="cuda")
    return (x, c, t, x_0), (e_cond, e_noise, s_noise)


def _tp_models():
    """The ds2 shape model (random weights from a seed, as every rank and
    the one-rank reference draw them) and its energy model."""
    shape_model = _on_card(DS2_SHAPE_MODEL)
    energy_model = _on_card(DS2_ENERGY_MODEL).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    _randomize(shape_model, gen)
    _randomize(energy_model, gen)
    return shape_model, energy_model


def _tp_run(mesh=None):
    """The TP checks' work on this rank (or on one): the gradient of the
    step's loss (whole), one train step (its metrics, the whole parameters
    after it, its ms and K1's launches) and one sample of the energy and
    shape models (K3, K2v: the gathered weights)."""
    from vit4hep_tpu_torch.parallel import mesh as mesh_lib
    from vit4hep_tpu_torch.parallel.sharding_rules import gather_state_dict, shard_tree

    shape_model, energy_model = _tp_models()
    state = ts.create_train_state(shape_model, Config(DS2_SHAPE_TRAINING), use_ema=False)
    if mesh is not None:
        state = mesh_lib.shard_state(state, mesh)
    batch, (e_cond, e_noise, s_noise) = _tp_inputs()
    loss = shape_model.batch_loss(batch[0], batch[1], t=batch[2], x_0=batch[3])
    grads = torch.autograd.grad(loss, state.params)
    with torch.no_grad():
        whole = _flat(g if getattr(p, "tp_shard", None) is None else p.tp_shard.gather(g)
                      for g, p in zip(grads, state.params))
    step = ts.make_train_step(
        lambda x, c, t, x_0: shape_model.batch_loss(x, c, t=t, x_0=x_0),
        clip_grad_norm=DS2_SHAPE_TRAINING["clip_grad_norm"], mesh=mesh)
    _reset()
    metrics = step(state, batch)
    step_launches = _counts()
    params = _flat(gather_state_dict(state)["model"].values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)  # the second step, timed
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    sampler, _ = _tp_models()
    if mesh is not None:
        shard_tree(sampler, mesh)
    sampler.eval()
    _reset()
    u = energy_model.sample_batch(e_cond, x_T=e_noise)
    showers = sampler.sample_batch(torch.cat([u, e_cond], 1), x_T=s_noise)
    torch.cuda.synchronize()
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "grads": whole, "params": params, "step_ms": step_ms,
            "step_launches": step_launches, "sample_launches": _counts(),
            "u": u.cpu(), "showers": showers.cpu(),
            "local_qkv": tuple(shape_model.net.blocks[0].attn.qkv.weight.shape)}


def _dit_blocks(indices):
    """The full-width DiT blocks ``indices`` of a depth-6 stack (hidden 480,
    6 heads x 80, attn_impl auto), each with its own random weights drawn
    on the host from one seeded stream, on the card."""
    from vit4hep_tpu_torch.models.vit import DiTBlock

    gen = torch.Generator().manual_seed(SEED + 51)
    shapes = {k: v.shape for k, v in DiTBlock(480, 6, 4.0, "auto").state_dict().items()}
    blocks = {}
    for i in range(6):  # every block's draws, so that each block's weights are the same
        sd = {k: 0.02 * torch.randn(shape, generator=gen) for k, shape in shapes.items()}
        if i in indices:
            blocks[i] = DiTBlock(480, 6, 4.0, "auto")
            blocks[i].load_state_dict(sd)
            blocks[i].cuda()
    return blocks


def _pipe_inputs():
    gen = torch.Generator().manual_seed(SEED + 52)
    x = torch.randn((PIPE_BATCH, 135, 480), generator=gen).cuda()
    c = torch.randn((PIPE_BATCH, 480), generator=gen).cuda()
    return x, c


def _ring_inputs():
    gen = torch.Generator().manual_seed(SEED + 53)
    return [torch.randn(RING_SHAPE, generator=gen).cuda() for _ in range(3)]


def _pipe_run(group, rank):
    """This rank's stage of the 6-block stack through spmd_pipeline:
    (output, {block: its gradients of sum(out^2)}, ms, launches)."""
    from vit4hep_tpu_torch.parallel.pipeline import spmd_pipeline, stack_stage_params

    mine = list(range(3 * rank, 3 * rank + 3))
    blocks = _dit_blocks(mine)
    module = blocks[mine[0]]
    per_block = [{n: p for n, p in blocks[i].named_parameters()} for i in mine]

    def block_fn(p, xx, cc):
        return torch.func.functional_call(module, p, (xx, cc))

    x, c = _pipe_inputs()
    mb = PIPE_BATCH // PIPE_MICRO
    for warm in (True, False):  # the second pass is timed and counted
        for b in blocks.values():
            b.zero_grad(set_to_none=True)
        stage = {k: v[0] for k, v in stack_stage_params(per_block, 1).items()}
        _reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = spmd_pipeline(block_fn, stage, x.reshape(PIPE_MICRO, mb, 135, 480),
                            c.reshape(PIPE_MICRO, mb, 480), group=group).reshape(x.shape)
        (out ** 2).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    grads = {i: _flat(p.grad for p in blocks[i].parameters()) for i in mine}
    return out.detach().cpu(), grads, ms, _counts()


def _ring_run(group):
    """ring_attention at RING_SHAPE: (output, gradients of sum(out^2), ms)."""
    from vit4hep_tpu_torch.parallel.sequence_parallel import ring_attention

    q, k, v = (t.requires_grad_() for t in _ring_inputs())
    for _ in range(2):  # the second pass is timed
        q.grad = k.grad = v.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring_attention(q, k, v, group)
        (out ** 2).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return out.detach().cpu(), [t.grad.cpu() for t in (q, k, v)], ms


def parallel_child(task: str, out: Path) -> int:
    """One rank of the parallel checks (``RANK``, ``WORLD_SIZE``,
    ``MASTER_*`` in the environment) over ``task``'s backend ("nccl": the
    launcher run; "gloo": the launcher run, then, with 2 ranks, the TP
    step and sample, the pipeline and the ring); writes its results to
    ``out/<task>_rank<r>.pt``."""
    import torch.distributed as dist

    from vit4hep_tpu_torch.experiments import main as launcher
    from vit4hep_tpu_torch.parallel import _comm
    from vit4hep_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = {"nccl": None, "gloo": "gloo"}[task]
    rank, world, device = mesh_lib.init_distributed(backend, "cuda")
    res = {"rank": rank, "device": str(device), "backend": dist.get_backend(),
           "transport": _comm.transport(dist.group.WORLD, device)}
    # the launcher on this process group (it leaves the group to its caller)
    cfg = _parallel_config(out / task)
    _reset()
    exp = launcher.main([f"backend={backend}"] if backend else [], device="cuda", cfg=cfg,
                        experiment_cls=SyntheticCaloChallenge)
    res["dp"] = dict(launches=_counts(), train_loss=exp.train_loss, val_loss=exp.val_loss,
                     skipped=exp.skipped, step_times=exp.step_times, save=exp.cfg.save,
                     run_dir=exp.cfg.run_dir, grid=exp.mesh.shape,
                     cfg=exp.cfg.to_container(resolve=False),
                     allreduce_bytes=4 * (sum(p.numel() for p in exp.state.params) + 1))
    del exp
    torch.cuda.empty_cache()
    if world > 1:
        mesh = mesh_lib.create_mesh(model_parallel=world)
        res["grid"] = mesh.shape
        res["tp"] = _tp_run(mesh)
        if rank:  # the whole gradients and parameters are rank 0's too
            res["tp"].update(grads=None, params=None)
        res["pipe"] = _pipe_run(dist.group.WORLD, rank)
        res["ring"] = _ring_run(dist.group.WORLD)
    dist.destroy_process_group()
    torch.save(res, out / f"{task}_rank{rank}.pt")
    return 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(task: str, world: int, out: Path):
    """``world`` children of this script, ranks of one process group on the
    card (cuda:0), running ``task``; each must end within CHILD_TIMEOUT
    seconds. Returns their results by rank."""
    import os

    port, procs = _free_port(), []
    t0 = time.perf_counter()
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world))
        log = open(out / f"{task}_rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                        "--parallel-child", task, str(out)],
                                       env=env, stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    try:
        for r, (p, _) in enumerate(procs):
            left = CHILD_TIMEOUT - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} still running after {CHILD_TIMEOUT} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            failed.append(f"rank {r} exit {p.returncode}:\n"
                          + (out / f"{task}_rank{r}.log").read_text()[-3000:])
    if failed:
        raise PhaseError(f"parallel {task}: " + "\n".join(failed))
    print(f"  {task}: {world} rank(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    return [torch.load(out / f"{task}_rank{r}.pt", weights_only=False) for r in range(world)]


def _hold_par(what, err, bound):
    ok = err <= bound
    print(f"  {what}: {err:.3e} (bound {bound:g}) {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def _steady_ms(step_times):
    steady = step_times[2:] or step_times
    return 1e3 * sum(steady) / len(steady)


def parallel_phase(tmp: Path, card):
    """(b) the launcher over NCCL as one rank; then 2 gloo ranks on the
    card: (a) the launcher's data-parallel run, held against (b), and on
    the same ranks tensor parallelism (a train step and a sample), the
    pipeline and ring attention, each against its one-rank run in this
    process. Returns the ranks' launches by path (summed over ranks)."""
    t_phase = time.perf_counter()
    launches, ok = {}, True

    print("parallel (b): the launcher with distributed=true, 1 rank over NCCL: the one-rank "
          "run that (a) is held against", flush=True)
    (res1,) = _ranks("nccl", 1, tmp)
    one = dict(res1["dp"], device=res1["device"], backend=res1["backend"])
    steps, vb = len(one["train_loss"]), len(one["val_loss"])
    want_each = {"qkv_attn_fwd": 6 * (steps + vb), "qkv_attn_bwd_delta": 6 * steps,
                 "qkv_attn_bwd_dkv": 6 * steps, "qkv_attn_bwd_dq": 6 * steps}
    print(f"  rank 0: {one['device']}, backend {one['backend']}, grid {one['grid']}, K1 launches "
          f"{one['launches']}; loss {one['train_loss'][0]:.5f} -> {one['train_loss'][-1]:.5f}, "
          f"val {one['val_loss']}", flush=True)
    if one["backend"] != "nccl" or one["launches"] != want_each or any(one["skipped"]) or \
            not all(math.isfinite(v) for v in one["train_loss"] + one["val_loss"]):
        raise PhaseError(f"parallel (b): backend {one['backend']}, launches {one['launches']} "
                         f"(expected {want_each}), skipped {one['skipped']}, losses "
                         f"{one['train_loss']}")
    launches["parallel_nccl"] = one["launches"]
    print(f"  (b) step {_steady_ms(one['step_times']):.2f} ms with its NCCL all-reduce of "
          f"{one['allreduce_bytes']:,} bytes a step (steady, steps 3-{steps}); on {card}",
          flush=True)

    print("parallel (a), (c)-(e): 2 ranks on cuda:0 over gloo: (a) the launcher with "
          "distributed=true backend=gloo, ds2 shape model at full width, global batch 64; then "
          "model_parallel=2: a TP train step and sample, the pipeline, ring attention", flush=True)
    ranks = _ranks("gloo", 2, tmp)
    dp = [dict(r["dp"], rank=r["rank"]) for r in ranks]
    for r in ranks:
        print(f"  rank {r['rank']}: {r['device']}, backend {r['backend']}, ppermute transport "
              f"{r['transport']}; (a) grid {r['dp']['grid']}, save {r['dp']['save']}, K1 "
              f"launches {r['dp']['launches']}; (c)-(e) grid {r['grid']}, qkv weight held "
              f"{r['tp']['local_qkv']} of (1440, 480)", flush=True)
    r0, r1 = dp
    if any(r["launches"] != want_each for r in dp):
        raise PhaseError(f"parallel (a): K1 launches {[r['launches'] for r in dp]}, expected "
                         f"{want_each} on each")
    launches["parallel_dp"] = {k: r0["launches"][k] + r1["launches"][k] for k in want_each}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["train_loss"], one["train_loss"]))
    ok &= _hold_par(f"(a) {steps} steps' losses, 2 ranks against 1 (rel)", loss_rel,
                    PARALLEL_TOL["loss"])
    val_rel = abs(r0["val_loss"][-1] - one["val_loss"][-1]) / abs(one["val_loss"][-1])
    ok &= _hold_par("(a) validation loss, 2 ranks against 1 (rel)", val_rel,
                    PARALLEL_TOL["loss"])
    ok &= _hold_par("(a) rank 1's losses against rank 0's (abs)",
                    max(abs(a - b) for a, b in zip(r0["train_loss"] + r0["val_loss"],
                                                   r1["train_loss"] + r1["val_loss"])), 0.0)
    if any(r0["skipped"]) or not all(math.isfinite(v) for v in r0["train_loss"]):
        raise PhaseError("parallel (a): a skipped step or a non-finite loss")
    run2, run1 = Path(r0["run_dir"]), Path(one["run_dir"])
    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*"))  # noqa: E731
    if not r0["save"] or r1["save"] or files(run2) != files(run1):
        raise PhaseError(f"parallel (a): rank 0 must write the run dir alone: save "
                         f"{r0['save']}/{r1['save']}, files {files(run2)} vs {files(run1)}")
    saved = torch.load(run2 / "models" / "model_run0.pt", map_location="cpu", weights_only=True)
    cfg_w = Config(r0["cfg"])
    cfg_w.train, cfg_w.distributed = False, False
    warm = SyntheticCaloChallenge(cfg_w, device="cuda")
    warm()
    same = warm.state.step == steps and all(
        torch.equal(v.cpu(), saved["model"][k]) for k, v in warm.model.state_dict().items())
    print(f"  (a) rank 0 wrote {len(files(run2))} files, rank 1 none; the 2-rank checkpoint "
          f"warm-starts a 1-rank experiment at step {warm.state.step}: "
          f"{'exact' if same else 'DIFFERS'}", flush=True)
    ok &= same
    ms1, ms2 = _steady_ms(one["step_times"]), _steady_ms(r0["step_times"])
    print(f"  (a) overhead, not scaling (two ranks share one card over gloo, host-staged): "
          f"per-step all-reduce {r0['allreduce_bytes']:,} bytes (26,042,528 f32 gradients and "
          f"the loss); step {ms1:.2f} ms on 1 rank (NCCL), {ms2:.2f} ms on 2 ranks of batch 32 "
          f"(steady, steps 3-{steps}); on {card}", flush=True)
    del warm
    torch.cuda.empty_cache()

    ref = _tp_run()
    tp0, tp1 = (r["tp"] for r in ranks)
    want_step = {"qkv_attn_fwd": 6, "qkv_attn_bwd_delta": 6, "qkv_attn_bwd_dkv": 6,
                 "qkv_attn_bwd_dq": 6}
    per = {k: 80 * v for k, v in CFM_PER_EVAL.items()}
    if any(t["step_launches"] != want_step or t["sample_launches"] != per for t in (tp0, tp1)):
        raise PhaseError(f"parallel (c): launches {[t['step_launches'] for t in (tp0, tp1)]}, "
                         f"{[t['sample_launches'] for t in (tp0, tp1)]}; expected {want_step}, "
                         f"{per}")
    launches["parallel_tp_step"] = {k: 2 * v for k, v in want_step.items()}
    launches["parallel_tp_sample"] = {k: 2 * v for k, v in per.items()}
    ok &= _hold_par("(c) TP step loss against 1 rank (rel)",
                 abs(tp0["loss"] - ref["loss"]) / abs(ref["loss"]), PARALLEL_TOL["loss"])
    ok &= _hold_par("(c) TP gradients against 1 rank (rel L2, all 26,042,528)",
                 _rel_l2(tp0["grads"], ref["grads"]), PARALLEL_TOL["grad_rel_l2"])
    ok &= _hold_par("(c) TP parameters after the step (max abs)",
                 (tp0["params"] - ref["params"]).abs().max().item(), PARALLEL_TOL["param_abs"])
    init = _flat(_tp_models()[0].state_dict().values())
    ok &= _hold_par("(c) TP update against 1 rank (rel L2)",
                 _rel_l2(tp0["params"] - init, ref["params"] - init), PARALLEL_TOL["update_rel"])
    ok &= _hold_par("(c) TP sample, energy u's through K3 (scaled)", _scaled(tp0["u"], ref["u"]),
                 PARALLEL_TOL["sample"])
    ok &= _hold_par("(c) TP sample, showers through the gathered K2v (scaled)",
                 max(_scaled(t["showers"], ref["showers"]) for t in (tp0, tp1)),
                 PARALLEL_TOL["sample"])
    print(f"  (c) overhead, not scaling: the second train step {ref['step_ms']:.2f} ms on 1 "
          f"rank, {tp0['step_ms']:.2f} / {tp1['step_ms']:.2f} ms on 2 TP ranks (K1 on 3 heads a "
          f"rank; 24 all-reduces of (64, 135, 480) f32 a step, host-staged by gloo); on {card}",
          flush=True)

    blocks = _dit_blocks(range(6))
    x, c = _pipe_inputs()
    params = [list(blocks[i].parameters()) for i in range(6)]
    for _ in range(2):  # the second pass is timed
        for b in blocks.values():
            b.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = x
        for i in range(6):
            h = blocks[i](h, c)
        (h ** 2).sum().backward()
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
    (out0, g0, ms0, l0), (out1, g1, ms1, l1) = (r["pipe"] for r in ranks)
    want_pipe = {"qkv_attn_fwd": 3 * (PIPE_MICRO + 1), "qkv_attn_bwd_delta": 3 * (PIPE_MICRO + 1),
                 "qkv_attn_bwd_dkv": 3 * (PIPE_MICRO + 1), "qkv_attn_bwd_dq": 3 * (PIPE_MICRO + 1)}
    if l0 != want_pipe or l1 != want_pipe:
        raise PhaseError(f"parallel (d): launches {l0}, {l1}; expected {want_pipe} a rank")
    launches["parallel_pipe"] = {k: 2 * v for k, v in want_pipe.items()}
    ok &= _hold_par("(d) pipeline output, 2 stages x 3 blocks against the 6 in sequence (scaled)",
                 max(_scaled(o, h.detach().cpu()) for o in (out0, out1)), PARALLEL_TOL["pipe_out"])
    ok &= _hold_par("(d) pipeline gradients per block (worst rel L2)",
                 max(_rel_l2(g, _flat(p.grad for p in params[i]))
                     for g_r in (g0, g1) for i, g in g_r.items()),
                 PARALLEL_TOL["pipe_grad_rel_l2"])
    print(f"  (d) forward + backward (the second pass): {seq_ms:.2f} ms in sequence on 1 rank, "
          f"{ms0:.2f} / {ms1:.2f} ms through {PIPE_MICRO + 1} ticks on 2 stages (overhead, not "
          f"scaling); on {card}", flush=True)
    del blocks, params, h
    torch.cuda.empty_cache()

    q, k, v = (t.requires_grad_() for t in _ring_inputs())
    for _ in range(2):  # the second pass is timed
        q.grad = k.grad = v.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = attn.xla_attention(q, k, v)
        (plain ** 2).sum().backward()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    (ro0, rg0, rms0), (ro1, rg1, rms1) = (r["ring"] for r in ranks)
    ok &= _hold_par(f"(e) ring attention at {RING_SHAPE}, 2 ranks, against the plain attention "
                 "(scaled)", max(_scaled(o, plain.detach().cpu()) for o in (ro0, ro1)),
                 PARALLEL_TOL["ring_out"])
    ok &= _hold_par("(e) ring gradients of q, k, v (worst rel L2)",
                 max(_rel_l2(g, t.grad.cpu()) for rg in (rg0, rg1) for g, t in zip(rg, (q, k, v))),
                 PARALLEL_TOL["ring_grad_rel_l2"])
    print(f"  (e) forward + backward (the second pass): plain {plain_ms:.2f} ms on 1 rank, ring "
          f"{rms0:.2f} / {rms1:.2f} ms on 2 ranks (overhead, not scaling); on {card}",
          flush=True)
    del q, k, v, plain
    torch.cuda.empty_cache()
    if not ok:
        raise PhaseError("parallel: a rank disagrees with its one-rank run")
    print(f"parallel: (a)-(e) in {time.perf_counter() - t_phase:.1f} s; on {card}", flush=True)
    return launches


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

    def stamp(what):  # the smoke's clock at the end of each group of phases
        print(f"[smoke {time.perf_counter() - t0:.1f} s] {what} done", flush=True)

    # every nvcc starts now; the first kernel phases wait only for their own
    # libraries while K6's, K8's and K7's (the longest builds) go on
    _cuda.start()
    try:
        compiled = _cuda.finish([n for n in _cuda.SOURCES if n not in LATE_SOURCES])
        print(f"build: {time.perf_counter() - t0:.2f} s for the first kernels "
              f"({compiled or 'all current'})", flush=True)

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
        print("K1 vs plain, ds2 training shape with the layer-causal mask of (15, 1, 9)",
              flush=True)
        k1_ms["ds2 training shape, masked"] = k1_kernel_phase(groups["causal"], 64, 135, mask=mask)
        print("K5 tier vs plain, ds2 training shape: x (64, 135, 480), 6 heads x 80, F 1920: "
              "the training GEMM epilogues, NT and split-K TN products, row passes, K5b (a1 "
              "saved), K2b, K5c, K5a", flush=True)
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
    finally:
        late = _cuda.finish()
    print(f"build: the rest ready at {time.perf_counter() - t0:.2f} s ({late or 'all current'}; "
          "built during the phases above)", flush=True)
    mask3 = _causal_mask((15, 5, 6))
    for group, b, causal, label in K68_SHAPES:
        print(f"K6 (flash_qkv_attention) and K8 (vmem_attention) vs plain, {label}: qkv ({b}, "
              f"450, 1440) f32, 6 heads x 80", flush=True)
        k1_ms[f"K6/K8, {label}"] = k68_kernel_phase(groups[group], b, 450,
                                                    mask=mask3 if causal else None)
        torch.cuda.empty_cache()
    print("K1's bf16 arm vs its bf16 plain versions, ds2 training shape: qkv (64, 135, 1440) "
          "bf16, 6 heads x 80", flush=True)
    k1_ms["bf16 arm, ds2 training shape"] = k1_bf16_phase(groups["main"], 64, 135)
    print("K1's bf16 arm forward vs plain, ds2 cINN subnet shape: qkv (256, 135, 576) bf16, 4 "
          "heads x 48", flush=True)
    k1_bf16_phase(groups["cinn"], BATCH, 135, 4, 48, backward=False)
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
    for geometry in ("ds1_photons", "ds1_pions"):
        n, pdim = VIT_TOKENS[geometry]
        print(f"{geometry}: K3 vs plain at tgt ({BATCH}, {DS1_K3_TOKENS[geometry]}, 128); K2v at "
              f"tokens ({BATCH}, {n}, {pdim}); K4 at y ({BATCH}, {DS1_K4_ROW[geometry]})",
              flush=True)
        k3_kernel_phase(groups[geometry], DS1_K3_TOKENS[geometry])
        k2v_kernel_phase(groups[geometry], n, pdim)
        k4_kernel_phase(groups[geometry], DS1_K4_ROW[geometry], other_branch=False)
    print("cfm_ds2_electrons_tpu, 4 heads x 120: K2v attention and forward at (256, 135); K1 "
          "forward and backward at qkv (64, 135, 1440)", flush=True)
    k2v_kernel_phase(groups["tpu"], *VIT_TOKENS["ds2"], gemms=False, heads=4)
    print("cfm_ds3_electrons_tpu, 4 heads x 120: K2v attention and forward at (256, 450)",
          flush=True)
    k2v_kernel_phase(groups["tpu_ds3"], *VIT_TOKENS["ds3"], gemms=False, heads=4)
    k1_ms["_tpu, 4 heads x 120"] = k1_kernel_phase(groups["tpu"], 64, 135, heads=4, d=120)
    print("cinn_ds2_electrons_tpu: K1 forward at qkv (256, 135, 768), 4 heads x 64", flush=True)
    k1_fwd_phase(groups["tpu_cinn"], BATCH, 135, 4, 64)
    torch.cuda.empty_cache()
    print("cinn_ds2_electrons training: K1 at qkv (64, 135, 576), 4 heads x 48; K5b, K2b, K5c, "
          "K5a at its ViT1D subnet's x (64, 135, 192); K2v at the subnet's sampling shape "
          "(256, 135, 24)", flush=True)
    k1_ms["cINN training, 4 heads x 48"] = k1_kernel_phase(groups["cinn_train"], 64, 135,
                                                           heads=4, d=48)
    k5_kernel_phase(groups["cinn_train"], 64, 135, primitives=False, h=192, heads=4, fdim=768,
                    depth=3, pdim=24, out=744)
    k2v_kernel_phase(groups["cinn_twin"], 135, 24, heads=4, h=192, depth=3, out=744)
    for group, n, heads, d, b, label in (("nflows", 135, 6, 60, 64, "cinn_nflows"),
                                         ("nflows_270", 270, 6, 60, 64, "cinn_nflows, spatial"),
                                         ("nflows_ds3", 675, 4, 90, 16, "cinn_nflows_ds3")):
        print(f"{label}: K1 at qkv ({b}, {n}, {3 * heads * d}) and forward at ({BATCH}, {n}, "
              f"{3 * heads * d}), {heads} heads x {d}", flush=True)
        k1_ms[f"{label}, {n} tokens, {heads} heads x {d}"] = k1_kernel_phase(
            groups[group], b, n, heads=heads, d=d)
        k1_fwd_phase(groups[f"{group}_serve"], BATCH, n, heads, d)
        torch.cuda.empty_cache()
    print("cfm_eplus (CaloGAN): K2v at tokens (256, 84, 6), 6 heads x 80 (cfm_lemurs serves and "
          "trains at ds2's shapes: the main group's K2v and K1)", flush=True)
    k2v_kernel_phase(groups["calogan"], 84, 6)
    print("cfm_calohad (CaloHadronic): K2v at tokens (256, 606, 75), 6 heads x 80, and "
          "cfm_calohad_tpu's 4 heads x 120; K1 forward and backward at qkv (32, 606, 1440)",
          flush=True)
    k2v_kernel_phase(groups["calohad"], 606, 75)
    k2v_kernel_phase(groups["calohad_tpu"], 606, 75, gemms=False, heads=4)
    k1_ms["CaloHadronic training, 606 tokens, 6 heads x 80"] = k1_kernel_phase(
        groups["calohad_train"], 32, 606)
    torch.cuda.empty_cache()
    print("calochallenge_ds2tods3_ft: K2v at tokens (256, 450, 48) after the 90 -> 48 x_mapper, "
          "the final product's N 90 (calohadronic_ft serves at cfm_calohad's shapes and trains "
          "at CaloHadronic's K1 shape)", flush=True)
    k2v_kernel_phase(groups["ft_ds3"], 450, 48, out=90)
    torch.cuda.empty_cache()
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
    stamp("build and kernels")

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
    for particle in ("photons", "pions"):
        geometry = f"ds1_{particle}"
        serving += [
            (f"{geometry}_cfm", f"ds1 {particle} CFM (multi-section ViT)", cfm_phase, geometry,
             DS1_SHAPE_MODEL[particle], DS1_ENERGY_MODEL[particle],
             DS1_SHAPE_TRANSFORMS[particle], DS1_ENERGY_TRANSFORMS[particle],
             CFM_GROUPS if particle == "photons" else None),
            (f"{geometry}_cinn", f"ds1 {particle} cINN", cinn_phase, geometry,
             DS1_CINN_MODEL[particle], DS1_ENERGY_MODEL[particle],
             DS1_CINN_TRANSFORMS[particle], DS1_ENERGY_TRANSFORMS[particle],
             CINN_GROUPS if particle == "photons" else None)]
    serving += [
        ("tpu_cfm", "cfm_ds2_electrons_tpu (4 heads x 120)", cfm_phase, "ds2",
         DS2_TPU_SHAPE_MODEL, DS2_ENERGY_MODEL, DS2_SHAPE_TRANSFORMS, DS2_ENERGY_TRANSFORMS, None),
        ("tpu_cinn", "cinn_ds2_electrons_tpu (subnets of 4 heads x 64)", cinn_phase, "ds2",
         DS2_TPU_CINN_MODEL, DS2_ENERGY_MODEL, DS2_CINN_TRANSFORMS, DS2_ENERGY_TRANSFORMS, None)]
    # this slice's cINN paths: (path, label, geometry, shape model, energy
    # model, their transforms, requests, counters)
    for path, label, geometry, shape_cfg, energy_cfg, requests, counters in (
            ("energy_cinn_chain", "cinn_ds2_electrons behind the energy cINN (cinn_energy)",
             "ds2", DS2_CINN_MODEL, ENERGY_CINN_MODEL, REQUESTS, CINN),
            ("nflows_cinn", "cinn_nflows (8 nflows couplings, subnets of 6 heads x 60)", "ds2",
             NFLOWS_MODEL, DS2_ENERGY_MODEL, REQUESTS, CINN),
            ("nflows_oneside_cinn", "cinn_nflows_oneside (10 one-sided couplings)", "ds2",
             NFLOWS_ONESIDE_MODEL, DS2_ENERGY_MODEL, REQUESTS, CINN),
            ("nflows_ds3_cinn", "cinn_nflows_ds3 (1350 tokens x 30, subnets over 675 tokens in 4 "
             "heads x 90)", "ds3", NFLOWS_DS3_MODEL, DS3_ENERGY_MODEL, 1, CINN),
            ("vit1d_twin_cinn", "cinn_ds2_electrons with fused_block: sample (K2v over each "
             "ViT1D subnet)", "ds2", _TWIN(fused_block="sample"), DS2_ENERGY_MODEL, REQUESTS,
             {**CINN, **SERVING})):
        tf = (DS3_CINN_TRANSFORMS, DS3_ENERGY_TRANSFORMS) if geometry == "ds3" else \
            (DS2_CINN_TRANSFORMS, DS2_ENERGY_TRANSFORMS)
        serving.append((path, label, functools.partial(
            cinn_phase, requests=requests, per_request=CINN_PER_REQUEST[path], counters=counters),
            geometry, shape_cfg, energy_cfg, *tf, None))
    for path, label, phase, geometry, *cfgs, prof_groups in serving:
        with tempfile.TemporaryDirectory() as tmp:
            print(f"{path}: {label} two-stage generator at full width", flush=True)
            launches[path], times, generator = phase(Path(tmp), geometry, *cfgs)
            steady = "" if len(times) < 2 else \
                f", {BATCH * (len(times) - 1) / sum(times[1:]):.2f} steady (first request excluded)"
            print(f"{path}: {BATCH * len(times) / sum(times):.2f} showers/s over all "
                  f"{len(times)} requests{steady}; batch {BATCH}, requests "
                  f"{[round(t, 4) for t in times]} s; on {card}", flush=True)
            if prof_groups is not None:
                print(f"{path} profile: one more request, by layer and by kernel", flush=True)
                profile_phase(generator, card, groups=prof_groups)
            if path in EXPORTS:
                print(f"{path}_export: the same chain exported (torch.export), saved, loaded and "
                      "served", flush=True)
                launches[f"{path}_export"] = export_phase(Path(tmp), path, generator, card)
            del generator
            torch.cuda.empty_cache()
        stamp(path)
    for path, label, param, per_eval in DS3_SERVING:
        with tempfile.TemporaryDirectory() as tmp:
            print(f"{path}: ds3 CFM two-stage generator at full width, fused_block: false, "
                  f"{label}, both CFMs at {COARSE_EVALS} net evals", flush=True)
            launches[path], times, generator = cfm_phase(
                Path(tmp), "ds3", dict(_with_net_param(DS3_SHAPE_MODEL, fused_block=False,
                                                       **param), odeint_kwargs=COARSE_ODE),
                dict(DS3_ENERGY_MODEL, odeint_kwargs=COARSE_ODE), DS3_SHAPE_TRANSFORMS,
                DS3_ENERGY_TRANSFORMS, DS3_REQUESTS, COMPOSED, per_eval)
            steady = "" if len(times) < 2 else \
                f", {BATCH * (len(times) - 1) / sum(times[1:]):.2f} steady (first request excluded)"
            print(f"{path}: {BATCH * len(times) / sum(times):.2f} showers/s over all "
                  f"{len(times)} requests{steady}; batch {BATCH}, requests "
                  f"{[round(t, 4) for t in times]} s; on {card}", flush=True)
            del generator
            torch.cuda.empty_cache()
        stamp(path)
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
        steady = "" if len(times) < 2 else (
            f", {DS3_LONG_SERVE_BATCH * (len(times) - 1) / sum(times[1:]):.4f} steady (first "
            "request excluded)")
        print(f"ds3_long_cfm: {DS3_LONG_SERVE_BATCH * len(times) / sum(times):.4f} showers/s "
              f"over all {len(times)} requests{steady}; batch {DS3_LONG_SERVE_BATCH}, requests "
              f"{[round(t, 4) for t in times]} s; on {card}", flush=True)
        del generator
        torch.cuda.empty_cache()

    for path, family, shape_cfg, requests, prof in FAMILY_SERVING:
        with tempfile.TemporaryDirectory() as tmp:
            print(f"{path}: {family} two-stage generator at full width and depth", flush=True)
            launches[path], _ = family_serving_phase(Path(tmp), family, shape_cfg, card,
                                                     requests, prof)
        stamp(path)
    stamp("serving paths")

    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "data").mkdir()
        _binning_xml(Path(tmp) / "data", "ds2")
        print("ds2_train: ds2 shape model at full width through the CaloChallenge experiment",
              flush=True)
        launches["ds2_train"], exp = train_phase(Path(tmp), card)
        print("train parity: K1 against the plain attention", flush=True)
        train_parity_phase(exp)
        print("causal_train: train parity of the layer-causal ViT, K1 masked against the plain "
              "masked attention", flush=True)
        _, launches["causal_train"] = train_parity_phase(exp, causal=True)
        stamp("ds2_train and its parities")
        print("train profile: one ds2 train step", flush=True)
        train_profile_phase(exp, card)
        print("ds2_fused_train: ds2 shape model, fused_block: true, through the experiment",
              flush=True)
        launches["ds2_fused_train"], fexp = fused_train_phase(Path(tmp), card, exp)
        print("fused train parity: the megakernel tier against the composed path", flush=True)
        for path, label, cfg, batch, variant in FUSED_PARITY:
            _, launches[path] = fused_parity_phase(label, cfg, batch, variant)
            torch.cuda.empty_cache()
        stamp("ds2_fused_train and the fused parities")
        print("fused train profile: one ds2 fused train step", flush=True)
        train_profile_phase(fexp, card, groups=FUSED_TRAIN_GROUPS)
        shape_cfg = Config(exp.cfg.to_container(resolve=False))
        del exp, fexp
        _binning_xml(Path(tmp) / "data", "ds3")
        rates = {}
        for stem, label, setting, param in DS3_SETTINGS:
            path = f"{stem}_train"
            print(f"{path}: ds3 shape model at full width, composed, {label}, through the "
                  "CaloChallenge experiment", flush=True)
            launches[path], rates[path] = ds3_train_phase(Path(tmp), card, path, label, setting,
                                                          param)
            torch.cuda.empty_cache()
            stamp(path)
        print(f"ds3_long_train: ds3_long at full width (13,500 tokens, K7), batch "
              f"{DS3_LONG_TRAIN_BATCH}, {DS3_LONG_STEPS} steps and one validation batch, through "
              "the CaloChallenge experiment", flush=True)
        launches["ds3_long_train"], rates["ds3_long_train"] = ds3_train_phase(
            Path(tmp), card, "ds3_long_train", "13,500 tokens, attn_impl auto (K7)", "k7", {},
            DS3_LONG_MODEL, DS3_LONG_STEPS, DS3_LONG_STEPS, DS3_LONG_TRAIN_BATCH)
        torch.cuda.empty_cache()
        stamp("ds3_long_train")
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
        stamp("the ds3 parities")
        print("energy: ds2 energy model at full width", flush=True)
        energy_exp = energy_phase(Path(tmp))
        torch.cuda.empty_cache()
        stamp("energy")
        print("experiment sampling: sample_n (staged and fused), the inverse pipeline and the "
              "evaluation core of plot, on the ds2_train and energy run dirs", flush=True)
        launches.update(experiment_sampling_phase(shape_cfg, energy_exp, card))
        del energy_exp
        torch.cuda.empty_cache()
    stamp("ds2 and ds3 training, energy, experiment sampling")
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "data").mkdir()
        _binning_xml(Path(tmp) / "data", "ds2")
        print("bf16: compute_dtype bfloat16 -- the ds2 shape model trained through the "
              "experiment (K1's bf16 arm), one ds2 CFM and one ds2 cINN request against f32",
              flush=True)
        launches["bf16_train"] = bf16_train_phase(Path(tmp), card)
        launches.update(bf16_serving_phase(Path(tmp), card))
        torch.cuda.empty_cache()
    stamp("bf16")
    with tempfile.TemporaryDirectory() as tmp:
        print("ds1_train: ds1 photons (energy and shape models) through the CaloChallenge "
              "experiment, then sample_n, to_mev and the evaluation core of eval_sample",
              flush=True)
        launches.update(ds1_train_phase(Path(tmp), card))
    stamp("ds1_train")
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "data").mkdir()
        _binning_xml(Path(tmp) / "data", "ds2")
        print("ds2_cinn_train: cinn_ds2_electrons at full width through the CaloChallenge "
              "experiment", flush=True)
        launches["ds2_cinn_train"], cexp = cinn_train_phase(Path(tmp), card)
        shape_cfg = Config(cexp.cfg.to_container(resolve=False))
        del cexp
        torch.cuda.empty_cache()
        stamp("ds2_cinn_train")
        print("cINN train parity: K1, remat_spline, the nflows couplings and the ViT1D twins "
              "against their reference paths from one state", flush=True)
        for path, label, cfg, ref, tol, counters, want in CINN_PARITY:
            _, launches[path] = parity_phase(label, cfg, ref, 64, counters, want, tol,
                                             CINN_TRAINING, steps=CINN_PARITY_STEPS)
            torch.cuda.empty_cache()
            stamp(path)
        print("energy_cinn: the energy cINN through the CaloChallenge experiment", flush=True)
        energy_exp = energy_cinn_phase(Path(tmp), card)
        print("cinn_sampling: sample_n of the ds2_cinn_train run behind the energy-cINN run, "
              "staged and fused", flush=True)
        launches.update(cinn_sampling_phase(shape_cfg, energy_exp, card))
        del energy_exp
        torch.cuda.empty_cache()
    stamp("the cINN's training, parities and sampling")

    for family, parity_batch in FAMILY_TRAIN:
        with tempfile.TemporaryDirectory() as tmp:
            print(f"{family}_train: the {family} energy and shape models at full width through "
                  "the experiment on synthetic events", flush=True)
            launches[f"{family}_train"], exp, energy_exp = family_train_phase(Path(tmp), family,
                                                                             card)
            if parity_batch:
                print(f"{family}_parity: K1 against the plain attention from one state",
                      flush=True)
                _, launches[f"{family}_parity"] = family_parity_phase(family, parity_batch)
            print(f"{family}_sampling: sample_n staged and fused, plot's inverse and evaluation",
                  flush=True)
            launches.update(family_sampling_phase(family, exp, energy_exp, card))
            del exp, energy_exp
            torch.cuda.empty_cache()
        stamp(family)

    stamp("the families")
    print("ar: the autoregressive energy net (ARtransformer) at its defaults", flush=True)
    ar_phase(card)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        print("ds2tods3_ft: calochallenge_ds2tods3_ft (a ds2 backbone fine-tuned on ds3) at full "
              "width through the experiment: training, parity, warm start, sample_n", flush=True)
        launches.update(ft_ds3_phase(Path(tmp), card))
    stamp("ds2tods3_ft")
    with tempfile.TemporaryDirectory() as tmp:
        print("calohadronic_ft: CaloHadronic fine-tuned from a LEMURS backbone at full width: "
              "training through the experiment, one request", flush=True)
        launches.update(ft_calohad_phase(Path(tmp), card))
    stamp("ar and fine-tuning")
    with tempfile.TemporaryDirectory() as tmp:
        print("parallel: the parallel layer (data parallelism through the launcher, NCCL, tensor "
              "parallelism, the pipeline, ring attention) in ranks of this script on the card",
              flush=True)
        launches.update(parallel_phase(Path(tmp), card))
    stamp("parallel")

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
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(parallel_child(sys.argv[2], Path(sys.argv[3])))
    sys.exit(main())
