#!/usr/bin/env python3
"""Time one tree's ViT GEMM, its K6, K8 and K2v attention kernels and K5b's
products, or rerun its end-to-end paths, with this checkout's
``chip_smoke.py``, so that two trees can be compared on one card.

    python3 tree_compare.py kernels [--tree DIR] [--label NAME]
    python3 tree_compare.py paths [--tree DIR] [--label NAME]

DIR (default: this checkout) goes first on the import path, so the
``vit4hep_tpu_torch`` that runs is DIR's, its kernels built there; the
shapes and the phases are those of this checkout's smoke. ``kernels``: the
six products of a ds2 and of a ds3 sampling forward at batch 256
(``VIT_TOKENS``, ``vit_products``: the embedding's positional epilogue on
the f32 patches, the gated residuals in place); at the ds3 shapes of K6 and K8
(``K68_SHAPES``), K1's f32 forward and K6's forward, dQ and dK/dV passes
on the qkv panel, and K7's f32 forward and K8's passes on its contiguous
q, k, v (as the smoke's kernel phase holds them);
K2v's attention at the ds2 and ds3 serving shapes, qkv (256, 135 or 450,
1440); and K5b's four NT and four TN products of a ds2 block gradient
(8,640 rows), each as the tree's block backward calls it; each the median
device time of ``tools.timing.time_ms`` on inputs made from seed 0.
``paths``: the smoke's
``train_phase`` (ds2 composed, 30 steps through the experiment) and
``fused_train_phase`` (the same with ``fused_block: true``), and
``cinn_phase`` and ``cfm_phase`` at ds2 and ds3 (3 requests of 256
showers). Either prints one JSON line: the card's name and power limit,
then the times in ms or the rates (train steps/s of the whole loop and of
the steady step interior; each generator's steady showers/s, first request
excluded, and its request seconds).

To compare a change with its parent, unpack the parent (``git archive``)
into a git-ignored directory and run both trees in turns in one call:
parent, change, change, parent (a request's or a step's host clock spreads
by several percent between runs, so take paths in three such pairs). It
needs a CUDA card and exits 2 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import tempfile
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
    # K2v's attention at the ds2 and ds3 serving shapes, qkv (256, N, 1440)
    res["k2v_attention"] = {}
    for geometry, (n, _) in cs.VIT_TOKENS.items():
        qkv = rand(cs.BATCH, n, 3 * heads * d)
        res["k2v_attention"][f"{geometry} ({cs.BATCH}, {n}, 1440)"] = cs.time_ms(
            lambda: fdb.attention(qkv, heads, scale))
        del qkv
    res["k5b"] = k5b_products(cs, torch, rand)
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


def paths(cs, torch) -> dict:
    res = {}
    rate = lambda e: {"loop": len(e.train_loss) / e.train_seconds,  # noqa: E731
                      "interior": len(e.step_times[2:]) / sum(e.step_times[2:])}
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "data").mkdir()
        cs._binning_xml(Path(tmp) / "data" / "binning_dataset_2.xml", "ds2")
        _, exp = cs.train_phase(Path(tmp), cs.card_name())
        res["ds2_train_steps_per_s"] = rate(exp)
        _, fexp = cs.fused_train_phase(Path(tmp), cs.card_name(), exp)
        res["ds2_fused_train_steps_per_s"] = rate(fexp)
        del exp, fexp
    for geometry, phase, cfgs in (
            ("ds2", cs.cinn_phase, (cs.DS2_CINN_MODEL, cs.DS2_ENERGY_MODEL,
                                    cs.DS2_CINN_TRANSFORMS, cs.DS2_ENERGY_TRANSFORMS)),
            ("ds3", cs.cinn_phase, (cs.DS3_CINN_MODEL, cs.DS3_ENERGY_MODEL,
                                    cs.DS3_CINN_TRANSFORMS, cs.DS3_ENERGY_TRANSFORMS)),
            ("ds2", cs.cfm_phase, (cs.DS2_SHAPE_MODEL, cs.DS2_ENERGY_MODEL,
                                   cs.DS2_SHAPE_TRANSFORMS, cs.DS2_ENERGY_TRANSFORMS)),
            ("ds3", cs.cfm_phase, (cs.DS3_SHAPE_MODEL, cs.DS3_ENERGY_MODEL,
                                   cs.DS3_SHAPE_TRANSFORMS, cs.DS3_ENERGY_TRANSFORMS))):
        with tempfile.TemporaryDirectory() as tmp:
            _, times, generator = phase(Path(tmp), geometry, *cfgs)
            res[f"{geometry}_{'cinn' if phase is cs.cinn_phase else 'cfm'}"] = {
                "showers_per_s": cs.BATCH * (len(times) - 1) / sum(times[1:]),
                "request_s": times}
            del generator
            torch.cuda.empty_cache()
    return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=("kernels", "paths"))
    p.add_argument("--tree", default=str(HERE), help="the checkout whose package runs")
    p.add_argument("--label", default=None, help="a name for the tree in the output")
    args = p.parse_args()
    tree = Path(args.tree).resolve()
    import torch

    if not torch.cuda.is_available():
        print("tree_compare: no CUDA device", file=sys.stderr)
        return 2
    os.chdir(tree)
    cs = _smoke(tree)
    torch.backends.cuda.matmul.allow_tf32 = False  # as the smoke runs
    torch.backends.cudnn.allow_tf32 = False
    cs._cuda.build()
    res = {"tree": args.label or str(tree), "card": cs.card_name(),
           **(kernels if args.what == "kernels" else paths)(cs, torch)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
