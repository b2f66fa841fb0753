#!/usr/bin/env python3
"""Time one tree's ViT GEMM, its K1, K6, K8 and K2v attention kernels,
K5b's products, K3, K7 and K4, or rerun its end-to-end paths, with this
checkout's ``chip_smoke.py``, so that two trees can be compared on one
card.

    python3 tree_compare.py kernels [--tree DIR] [--label NAME]
    python3 tree_compare.py paths [--tree DIR] [--label NAME] [--only PATH ...]
    python3 tree_compare.py k7 [--tree DIR] [--label NAME]
    python3 tree_compare.py sass --tree DIR

DIR (default: this checkout) goes first on the import path, so the
``vit4hep_tpu_torch`` that runs is DIR's, its kernels built there; the
shapes and the phases are those of this checkout's smoke. ``kernels``: the
six products of a ds2 and of a ds3 sampling forward at batch 256
(``VIT_TOKENS``, ``vit_products``: the embedding's positional epilogue on
the f32 patches, the gated residuals in place); at the ds3 shapes of K6 and K8
(``K68_SHAPES``), K1's forward and K6's forward, dQ and dK/dV passes
on the qkv panel, and K7's f32 forward and K8's passes on its contiguous
q, k, v (as the smoke's kernel phase holds them);
K2v's attention at the ds2 and ds3 serving shapes, qkv (256, 135 or 450,
1440); and K5b's four NT and four TN products of a ds2 block gradient
(8,640 rows), each as the tree's block backward calls it; K1's forward
at the ds2 training shape (64, 135, 1440), plain and layer-causal, and at
the cINN subnet shapes (256, 135 or 225, 576); K1's backward passes (delta,
dK/dV, dQ) at (64, 135, 1440), plain and layer-causal, and (16, 450, 1440),
with SDPA's f32 backward beside them; K3 at the energy net's sampling shape
(batch 256); K7 at the smoke's shapes (``K7_SHAPES``: q/k/v (2 and 8, 6,
13500, 80), (64, 6, 450, 80) plain and layer-causal, (8, 6, 300, 80) with
a tail tile and a dead row), its forward, dK/dV and dQ passes as DIR's
wrappers launch them alone (each with its own pre-pass where DIR has one),
its backward through autograd's path (delta, one pre-pass, both passes),
and where DIR has the pre-pass, the pre-pass alone and the passes on
operands split beforehand, SDPA's f32 forward and backward (with the mask)
beside them; K4 at the ds2 and ds3 cINN sampling shapes (y (256, 3240 or
20250), theta (..., 31), the shipped spline); each the median device time
of ``tools.timing.time_ms`` on inputs made from seed 0.
``paths``: the smoke's
``train_phase`` (ds2 composed, 30 steps through the experiment) and
``fused_train_phase`` (the same with ``fused_block: true``),
``ds3_train_phase`` with ``attn_impl: flash`` (K6's forward and backward),
and
``cinn_phase`` and ``cfm_phase`` at ds2 and ds3 (3 requests of 256
showers), and ds3_long (13,500 tokens, K7): its serving (``cfm_phase``,
batch 2, 2 requests) and training (``ds3_train_phase``, batch 8,
DS3_LONG_STEPS steps); ``--only`` picks some of them (``PATHS``).
``k7``: K7's passes as ``kernels`` times them, at the tail shape and at
the least N that each attention dispatch sends to K7 (``K7_EDGE_SHAPES``).
Each prints one JSON line: the card's name and power limit,
then the times in ms or the rates (train steps/s of the whole loop and of
the steady step interior; each generator's steady showers/s, first request
excluded, and its request seconds). ``sass`` builds the libraries of
the kernels a change should leave as they were (``SASS_KERNELS``: K6's
three kernels, K8's three, K7's, K1's TF32 forward, delta kernel and
backward passes, K3's, K2v's attention with the ViT GEMM and modln
kernels beside it, and K4's) in DIR and in
this checkout, and prints per kernel the SASS lines (``cuobjdump -sass``,
addresses and encodings stripped) that differ between the two.

To compare a change with its parent, unpack the parent (``git archive``)
into a git-ignored directory and run both trees in turns in one call:
parent, change, change, parent (a request's or a step's host clock spreads
by several percent between runs, so take paths in three such pairs). It
needs a CUDA card and exits 2 without one.
"""

from __future__ import annotations

import argparse
import difflib
import importlib.util
import inspect
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke(tree: Path):
    """This checkout's chip_smoke, importing DIR's vit4hep_tpu_torch."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def kernels(cs, torch) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rand = lambda *s, sc=1.0: torch.randn(*s, generator=gen, device="cuda") * sc  # noqa: E731
    bf, fdb, h, fdim = torch.bfloat16, cs.fdb, 480, 1920
    res = {}
    for geometry, (n, pdim) in cs.VIT_TOKENS.items():
        m = cs.BATCH * n
        x, pos, gate = rand(m, h), rand(n, h), rand(cs.BATCH, 6, h, sc=0.1)[:, 2]
        a_of = {"embed": rand(m, pdim), "fc2": rand(m, fdim).to(bf)}
        h_bf = rand(m, h).to(bf)
        times = {}
        for key, (k, nout), epi in cs.vit_products(pdim, h, fdim):
            kw = {fdb.EPI_BIAS_POS: dict(pos=pos),
                  fdb.EPI_GATED_RESID: dict(out=x, gate=gate)}.get(epi, {})
            w, bias = rand(k, nout, sc=0.05).to(bf), rand(nout, sc=0.05)
            times[key] = cs.time_ms(lambda: fdb.linear(a_of.get(key, h_bf), w, bias, epi,
                                                       n_tok=n, **kw))
        times["sum"] = sum(times.values())
        res[f"gemm_{geometry}"] = times
        del x, a_of, h_bf
    mask, heads, d, scale = cs._causal_mask((15, 5, 6)), 6, 80, 80 ** -0.5
    attn = {}
    for _, b, causal, label in cs.K68_SHAPES:
        m = mask if causal else None
        qkv, g = rand(b, 450, 3 * heads * d), rand(b, 450, heads * d)
        q, k, v = (t.contiguous()
                   for t in qkv.reshape(b, 450, 3, heads, d).permute(2, 0, 3, 1, 4))
        gh = g.reshape(b, 450, heads, d).permute(0, 2, 1, 3).contiguous()
        out, lse = cs.ffa.flash_fwd_kernel(qkv, heads, scale, m)
        delta = cs.fqa.attention_bwd_delta_kernel(g, out, heads)
        dqkv = torch.zeros_like(qkv)
        lse8 = cs.fva.vmem_fwd_kernel(q, k, v, scale, m)[1]
        rt = cs.fva.vmem_bwd_dq_kernel(q, k, v, gh, lse8, scale, m)[1]
        runs = {
            "k1_fwd": lambda: cs.fqa.attention_fwd_kernel(qkv, heads, scale, m),
            "k7_fwd": lambda: cs.fla.flash_fwd_kernel(q, k, v, scale, m),
            "k6_fwd": lambda: cs.ffa.flash_fwd_kernel(qkv, heads, scale, m),
            "k6_dq": lambda: cs.ffa.flash_bwd_dq_kernel(qkv, g, lse, delta, heads, scale, dqkv,
                                                        m),
            "k6_dkv": lambda: cs.ffa.flash_bwd_dkv_kernel(qkv, g, lse, delta, heads, scale,
                                                          dqkv, m),
            "k8_fwd": lambda: cs.fva.vmem_fwd_kernel(q, k, v, scale, m),
            "k8_dq": lambda: cs.fva.vmem_bwd_dq_kernel(q, k, v, gh, lse8, scale, m),
            "k8_dkv": lambda: cs.fva.vmem_bwd_dkv_kernel(q, k, v, gh, lse8, rt, scale, m)}
        attn[f"({b}, 450, 1440) {label}"] = {name: cs.time_ms(fn) for name, fn in runs.items()}
        del qkv, g, q, k, v, gh, out, lse, delta, dqkv, lse8, rt, runs
        torch.cuda.empty_cache()
    res["k6_k8"] = attn
    # K1's forward at the ds2 training shape (plain and layer-causal) and at
    # the cINN subnet shapes, as the smoke's kernel phase holds it
    res["k1_fwd"] = {}
    for b, n, h, dh, grid in ((64, 135, 6, 80, None), (64, 135, 6, 80, (15, 1, 9)),
                              (cs.BATCH, 135, 4, 48, None), (cs.BATCH, 225, 4, 48, None)):
        qkv = rand(b, n, 3 * h * dh)
        m = None if grid is None else cs._causal_mask(grid)
        res["k1_fwd"][f"({b}, {n}, {3 * h * dh}){' layer-causal' if grid else ''}"] = \
            cs.time_ms(lambda: cs.fqa.attention_fwd_kernel(qkv, h, dh ** -0.5, m))
        del qkv
    # K1's backward passes at the smoke's shapes: the ds2 training shape,
    # plain and layer-causal, and 450 tokens; SDPA's f32 backward beside them
    res["k1_bwd"] = {}
    for b, n, grid in ((64, 135, None), (64, 135, (15, 1, 9)), (16, 450, None)):
        qkv, g = rand(b, n, 3 * heads * d), rand(b, n, heads * d)
        m = None if grid is None else cs._causal_mask(grid)
        out, lse = cs.fqa.attention_fwd_kernel(qkv, heads, scale, m)
        delta = cs.fqa.attention_bwd_delta_kernel(g, out, heads)
        dqkv = torch.empty_like(qkv)
        xs = tuple(t.contiguous().requires_grad_()
                   for t in qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
        o = cs.F.scaled_dot_product_attention(*xs, attn_mask=m, scale=scale)
        gh = g.reshape(b, n, heads, d).permute(0, 2, 1, 3).contiguous()
        res["k1_bwd"][f"({b}, {n}, 1440){' layer-causal' if grid else ''}"] = {
            "delta": cs.time_ms(lambda: cs.fqa.attention_bwd_delta_kernel(g, out, heads)),
            "dkv": cs.time_ms(lambda: cs.fqa.attention_bwd_dkv_kernel(
                qkv, g, lse, delta, heads, scale, dqkv, m)),
            "dq": cs.time_ms(lambda: cs.fqa.attention_bwd_dq_kernel(
                qkv, g, lse, delta, heads, scale, dqkv, m)),
            "sdpa_f32_bwd": cs.time_ms(lambda: torch.autograd.grad(o, xs, gh,
                                                                   retain_graph=True))}
        del qkv, g, out, lse, delta, dqkv, xs, o, gh
    # K3 at the energy net's sampling shape, batch 256 (the smoke's inputs)
    res["k3"] = cs.time_ms(cs.k3_inputs()[0])
    # K2v's attention at the ds2 and ds3 serving shapes, qkv (256, N, 1440)
    res["k2v_attention"] = {}
    for geometry, (n, _) in cs.VIT_TOKENS.items():
        qkv = rand(cs.BATCH, n, 3 * heads * d)
        res["k2v_attention"][f"{geometry} ({cs.BATCH}, {n}, 1440)"] = cs.time_ms(
            lambda: fdb.attention(qkv, heads, scale))
        del qkv
    res["k5b"] = k5b_products(cs, torch, rand)
    res["k7"] = k7_passes(cs, torch, rand)
    res["k4"] = k4_times(cs, torch, rand)
    return res


def k4_times(cs, torch, rand) -> dict:
    """K4 at the ds2 and ds3 cINN sampling shapes, y (256, 3240 or 20250) ~
    6 N(0, 1), theta (..., 31), the shipped spline (``K4_SPLINE``)."""
    res = {}
    for d in (3240, 20250):
        y, theta = rand(cs.BATCH, d, sc=6.0), rand(cs.BATCH, d, 31)
        res[f"({cs.BATCH}, {d}, 31)"] = cs.time_ms(
            lambda: cs.fsp.fused_binned_rqs_inverse(y, theta, *cs.K4_SPLINE))
        del y, theta
    return res


# K7's shapes in the smoke: (batch, tokens, mask, label)
K7_SHAPES = ((2, 13500, None, "ds3_long serving"), (8, 13500, None, "ds3_long training"),
             (64, 450, None, "ds3 training"), (64, 450, "layer-causal", "ds3 training"),
             (8, 300, "tail", "tail tile and a dead row"))
# the tail shape and the least N each dispatch sends to K7: dot_product_attention's
# auto past 1024 tokens, qkv_attention's auto past flash_qkv_fits (10,752 at
# hidden 480, 6 heads)
K7_EDGE_SHAPES = (K7_SHAPES[-1], (8, 1025, None, "dot_product_attention auto"),
                  (2, 10753, None, "qkv_attention auto"))


def k7_passes(cs, torch, rand, shapes=K7_SHAPES) -> dict:
    """K7's passes at ``shapes``, as the module docstring says."""
    fla, F, heads, d = cs.fla, cs.F, 6, 80
    scale, pre = d ** -0.5, hasattr(fla, "split_kernel")
    res = {}
    for b, n, kind, label in shapes:
        mask = None
        if kind == "layer-causal":
            mask = cs._causal_mask((15, 5, 6))
        elif kind == "tail":
            mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device="cuda"))
            mask[7] = False
        qkv = rand(b, n, 3 * heads * d)
        q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        g = rand(b, n, heads * d).reshape(b, n, heads, d).permute(0, 2, 1, 3)
        out, lse = fla.flash_fwd_kernel(q, k, v, scale, mask)
        delta = fla.delta_plain(g, out)
        runs = {"fwd": lambda: fla.flash_fwd_kernel(q, k, v, scale, mask),
                "dkv": lambda: fla.flash_bwd_dkv_kernel(q, k, v, g, lse, delta, scale, mask),
                "dq": lambda: fla.flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale, mask),
                "bwd": lambda: fla.flash_bwd_kernel(q, k, v, g, out, lse, scale, mask)}
        times = {name: cs.time_ms(fn) for name, fn in runs.items()}
        if pre:
            kv = fla.split_kernel("flash_attention_fwd", [(k, (fla.ROWS,)), (v, (fla.COLS,))],
                                  b, heads, n, d)
            ops = fla.split_bwd(q, k, v, g)
            times.update({
                "split_fwd": cs.time_ms(lambda: fla.split_kernel(
                    "flash_attention_fwd", [(k, (fla.ROWS,)), (v, (fla.COLS,))], b, heads, n,
                    d)),
                "split_bwd": cs.time_ms(lambda: fla.split_bwd(q, k, v, g)),
                "fwd_only": cs.time_ms(lambda: fla.flash_fwd_kernel(q, k, v, scale, mask, kv)),
                "dkv_only": cs.time_ms(lambda: fla.flash_bwd_dkv_kernel(
                    q, k, v, g, lse, delta, scale, mask, ops)),
                "dq_only": cs.time_ms(lambda: fla.flash_bwd_dq_kernel(
                    q, k, v, g, lse, delta, scale, mask, ops))})
            del kv, ops
        qc, kc, vc, gc = (t.contiguous() for t in (q, k, v, g))
        xs = tuple(t.clone().requires_grad_() for t in (qc, kc, vc))
        o = F.scaled_dot_product_attention(*xs, attn_mask=mask, scale=scale)
        times["sdpa_f32_fwd"] = cs.time_ms(
            lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask, scale=scale))
        times["sdpa_f32_bwd"] = cs.time_ms(lambda: torch.autograd.grad(o, xs, gc,
                                                                        retain_graph=True))
        res[f"({b}, 6, {n}, 80) {label}{', ' + kind if kind else ''}"] = times
        del qkv, q, k, v, g, out, lse, delta, runs, qc, kc, vc, gc, xs, o
        torch.cuda.empty_cache()
    return res


def k5b_products(cs, torch, rand) -> dict:
    """K5b's four NT and four TN products of one block gradient at the ds2
    training shape (8,640 rows, H 480, F 1920), each as the tree's block
    backward calls it (a tree whose gemm_nt takes bf16 copies and writes
    saves gets them, as its main path does)."""
    bf, fdb, m, h, f = torch.bfloat16, cs.fdb, 64 * 135, 480, 1920
    copies = "save" in inspect.signature(fdb.gemm_nt).parameters
    w2, w1, wout, wqkv = (rand(*s, sc=0.05).to(bf) for s in ((f, h), (h, f), (h, h), (h, 3 * h)))
    dy, da1, dattn, dqkv, ctx = rand(m, h), rand(m, f), rand(m, h), rand(m, 3 * h), rand(m, h)
    a1, hb, h2 = rand(m, f).to(bf), rand(m, h).to(bf), rand(m, h).to(bf)
    times = {}
    if copies:
        c16 = {k: t.to(bf) for k, t in (("dy", dy), ("da1", da1), ("dattn", dattn),
                                          ("dqkv", dqkv), ("ctx", ctx))}
        saves = [torch.empty(m, f, dtype=bf, device="cuda") for _ in range(2)]
        nt = {"dy_w2": lambda: fdb.gemm_nt(c16["dy"], w2, a1, save=saves[0],
                                           gelu_save=saves[1]),
              "da1_w1": lambda: fdb.gemm_nt(c16["da1"], w1),
              "dattn_wout": lambda: fdb.gemm_nt(c16["dattn"], wout),
              "dqkv_wqkv": lambda: fdb.gemm_nt(c16["dqkv"], wqkv)}
        tn = {"dw2": lambda: fdb.weight_grad_partial(saves[1], dy, b16=c16["dy"]),
              "dw1": lambda: fdb.weight_grad_partial(h2, da1, b16=c16["da1"]),
              "dwout": lambda: fdb.weight_grad_partial(c16["ctx"], dattn, b16=c16["dattn"]),
              "dwqkv": lambda: fdb.weight_grad_partial(hb, dqkv, b16=c16["dqkv"])}
    else:
        nt = {"dy_w2": lambda: fdb.gemm_nt(dy, w2, a1),
              "da1_w1": lambda: fdb.gemm_nt(da1, w1),
              "dattn_wout": lambda: fdb.gemm_nt(dattn, wout),
              "dqkv_wqkv": lambda: fdb.gemm_nt(dqkv, wqkv)}
        tn = {"dw2": lambda: fdb.weight_grad_partial(a1, dy, True),
              "dw1": lambda: fdb.weight_grad_partial(h2, da1),
              "dwout": lambda: fdb.weight_grad_partial(ctx, dattn),
              "dwqkv": lambda: fdb.weight_grad_partial(hb, dqkv)}
    for kind, runs in (("nt", nt), ("tn", tn)):
        for name, fn in runs.items():
            times[f"{kind}_{name}"] = cs.time_ms(fn)
        times[f"{kind}_sum"] = sum(v for k, v in times.items() if k.startswith(kind + "_"))
    return times


PATHS = ("ds2_train", "ds3_flash_train", "cinn", "cfm", "ds3_long")


def paths(cs, torch, only=PATHS) -> dict:
    res = ds3_long_paths(cs, torch) if "ds3_long" in only else {}
    rate = lambda e: {"loop": len(e.train_loss) / e.train_seconds,  # noqa: E731
                      "interior": len(e.step_times[2:]) / sum(e.step_times[2:])}
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "data").mkdir()
        if "ds2_train" in only:
            cs._binning_xml(Path(tmp) / "data" / "binning_dataset_2.xml", "ds2")
            _, exp = cs.train_phase(Path(tmp), cs.card_name())
            res["ds2_train_steps_per_s"] = rate(exp)
            _, fexp = cs.fused_train_phase(Path(tmp), cs.card_name(), exp)
            res["ds2_fused_train_steps_per_s"] = rate(fexp)
            del exp, fexp
        if "ds3_flash_train" in only:
            # the ds3 composed path through K6 (attn_impl: flash), forward and backward
            cs._binning_xml(Path(tmp) / "data" / "binning_dataset_3.xml", "ds3")
            _, (loop, interior) = cs.ds3_train_phase(
                Path(tmp), cs.card_name(), "ds3_flash_train", "attn_impl: flash (K6)", "flash",
                {"attn_impl": "flash"})
            res["ds3_flash_train_steps_per_s"] = {"loop": loop, "interior": interior}
        torch.cuda.empty_cache()
    return res | serving_paths(cs, torch, only)


def serving_paths(cs, torch, only) -> dict:
    """The ds2 and ds3 cINN and CFM serving paths that ``only`` names."""
    res = {}
    for geometry, phase, cfgs in (
            ("ds2", cs.cinn_phase, (cs.DS2_CINN_MODEL, cs.DS2_ENERGY_MODEL,
                                    cs.DS2_CINN_TRANSFORMS, cs.DS2_ENERGY_TRANSFORMS)),
            ("ds3", cs.cinn_phase, (cs.DS3_CINN_MODEL, cs.DS3_ENERGY_MODEL,
                                    cs.DS3_CINN_TRANSFORMS, cs.DS3_ENERGY_TRANSFORMS)),
            ("ds2", cs.cfm_phase, (cs.DS2_SHAPE_MODEL, cs.DS2_ENERGY_MODEL,
                                   cs.DS2_SHAPE_TRANSFORMS, cs.DS2_ENERGY_TRANSFORMS)),
            ("ds3", cs.cfm_phase, (cs.DS3_SHAPE_MODEL, cs.DS3_ENERGY_MODEL,
                                   cs.DS3_SHAPE_TRANSFORMS, cs.DS3_ENERGY_TRANSFORMS))):
        if ("cinn" if phase is cs.cinn_phase else "cfm") not in only:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            _, times, generator = phase(Path(tmp), geometry, *cfgs)
            res[f"{geometry}_{'cinn' if phase is cs.cinn_phase else 'cfm'}"] = {
                "showers_per_s": cs.BATCH * (len(times) - 1) / sum(times[1:]),
                "request_s": times}
            del generator
            torch.cuda.empty_cache()
    return res


def ds3_long_paths(cs, torch) -> dict:
    """ds3_long (13,500 tokens, every attention K7) served at batch
    DS3_LONG_SERVE_BATCH (DS3_REQUESTS requests; steady showers/s, the first
    request excluded) and trained at DS3_LONG_TRAIN_BATCH for DS3_LONG_STEPS
    steps, as the smoke's phases run them."""
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        _, times, generator = cs.cfm_phase(
            Path(tmp), "ds3", cs.DS3_LONG_MODEL, cs.DS3_ENERGY_MODEL, cs.DS3_SHAPE_TRANSFORMS,
            cs.DS3_ENERGY_TRANSFORMS, cs.DS3_REQUESTS, cs.COMPOSED, cs.DS3_LONG_PER_EVAL,
            cs.DS3_LONG_SERVE_BATCH, (1, cs.DS3_LONG_REFERENCE_STEP, 1e-3))
        res["ds3_long_cfm"] = {
            "showers_per_s": cs.DS3_LONG_SERVE_BATCH * (len(times) - 1) / sum(times[1:]),
            "request_s": times}
        del generator
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "data").mkdir()
        cs._binning_xml(Path(tmp) / "data" / "binning_dataset_3.xml", "ds3")
        torch.cuda.reset_peak_memory_stats()
        _, (loop, interior) = cs.ds3_train_phase(
            Path(tmp), cs.card_name(), "ds3_long_train", "13,500 tokens, attn_impl auto (K7)",
            "k7", {}, cs.DS3_LONG_MODEL, cs.DS3_LONG_STEPS, cs.DS3_LONG_STEPS,
            cs.DS3_LONG_TRAIN_BATCH)
        res["ds3_long_train_steps_per_s"] = {
            "loop": loop, "interior": interior,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        torch.cuda.empty_cache()
    return res


# the kernels that a change may leave compiled as they were: the library
# and a substring of each kernel's mangled name
SASS_KERNELS = {"flash_qkv_attention": ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                                        "flash_bwd_dkv_wgmma_kernel"),
                "vmem_attention": ("vmem_fwd_wgmma_kernel", "vmem_bwd_dq_wgmma_kernel",
                                   "vmem_bwd_dkv_wgmma_kernel"),
                "flash_attention": ("k7_",),
                "qkv_attention": ("bwd_delta_kernel", "qkv_fwd_tf32_kernel"),
                "qkv_attention_bwd": ("qkv_bwd_",),
                "energy_decoder": ("energy_decoder",),
                "vit_forward": ("vit_attn_wgmma_kernel", "gemm_wgmma_kernel", "modln_kernel"),
                "binned_rqs": ("binned_rqs_inverse_kernel",)}


def sass(tree: Path) -> dict:
    """Build this checkout's and DIR's kernel libraries of SASS_KERNELS and
    count, per kernel, the SASS instruction lines that differ (0: the same
    code)."""
    trees = {"tree": tree, "this checkout": HERE}
    cudas = {}
    for label, root in trees.items():
        spec = importlib.util.spec_from_file_location(
            f"_cuda_{len(cudas)}", root / "vit4hep_tpu_torch" / "ops" / "_cuda.py")
        cudas[label] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cudas[label])
    with ThreadPoolExecutor(len(cudas)) as pool:
        list(pool.map(lambda c: c.build(tuple(SASS_KERNELS)), cudas.values()))
    res = {}
    for name, patterns in SASS_KERNELS.items():
        a, b = (cudas["this checkout"].sass_functions(c._lib_path(name))
                for c in cudas.values())
        for fn in sorted(f for f in set(a) | set(b) if any(p in f for p in patterns)):
            if fn not in a or fn not in b:
                res[fn] = "only in " + ("this checkout" if fn in b else "the tree")
                continue
            ops = difflib.SequenceMatcher(None, a[fn], b[fn], autojunk=False).get_opcodes()
            res[fn] = {"lines": len(b[fn]),
                       "differ": sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops
                                     if tag != "equal")}
    return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=("kernels", "paths", "sass", "k7"))
    p.add_argument("--tree", default=str(HERE), help="the checkout whose package runs")
    p.add_argument("--label", default=None, help="a name for the tree in the output")
    p.add_argument("--only", nargs="+", choices=PATHS, default=PATHS,
                   help="paths: the paths to run")
    args = p.parse_args()
    tree = Path(args.tree).resolve()
    import torch

    if not torch.cuda.is_available():
        print("tree_compare: no CUDA device", file=sys.stderr)
        return 2
    if args.what == "sass":
        print(json.dumps({"tree": args.label or str(tree), "sass": sass(tree)}), flush=True)
        return 0
    os.chdir(tree)
    cs = _smoke(tree)
    torch.backends.cuda.matmul.allow_tf32 = False  # as the smoke runs
    torch.backends.cudnn.allow_tf32 = False
    cs._cuda.build()
    if args.what == "k7":
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        rand = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
        res = {"k7": k7_passes(cs, torch, rand, K7_EDGE_SHAPES)}
    else:
        res = kernels(cs, torch) if args.what == "kernels" else paths(cs, torch, args.only)
    res = {"tree": args.label or str(tree), "card": cs.card_name(), **res}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
