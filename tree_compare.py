#!/usr/bin/env python3
"""Time one tree's ViT GEMM and its K6 and K8 attention kernels, or rerun
its untouched end-to-end paths, with this checkout's ``chip_smoke.py``, so
that two trees can be compared on one card.

    python3 tree_compare.py kernels [--tree DIR] [--label NAME]
    python3 tree_compare.py paths [--tree DIR] [--label NAME]

DIR (default: this checkout) goes first on the import path, so the
``vit4hep_tpu_torch`` that runs is DIR's, its kernels built there; the
shapes and the phases are those of this checkout's smoke. ``kernels``: the
six products of a ds2 and of a ds3 sampling forward at batch 256
(``VIT_TOKENS``, ``vit_products``: the embedding's positional epilogue on
the f32 patches, the gated residuals in place) and, at the ds3 shapes of K6 and K8
(``K68_SHAPES``), K6's forward, dQ and dK/dV passes on the qkv panel and
K8's on its contiguous q, k, v (as the smoke's kernel phase holds them),
each the median device time of ``tools.timing.time_ms`` on inputs made
from seed 0. ``paths``: the smoke's
``train_phase`` (ds2 composed, 30 steps through the experiment) and
``cinn_phase`` at ds2 and ds3 (3 requests of 256 showers). Either prints
one JSON line: the card's name and power limit, then the times in ms or
the rates (train steps/s of the whole loop and of the steady step
interior; each cINN's steady showers/s, first request excluded, and its
request seconds).

To compare a change with its parent, unpack the parent (``git archive``)
into a git-ignored directory and run both trees in turns in one call:
parent, change, change, parent (a request's or a step's host clock spreads
by several percent between runs, so take paths in three such pairs). It
needs a CUDA card and exits 2 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
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
    return res


def paths(cs, torch) -> dict:
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "data").mkdir()
        cs._binning_xml(Path(tmp) / "data" / "binning_dataset_2.xml", "ds2")
        _, exp = cs.train_phase(Path(tmp), cs.card_name())
        steady = exp.step_times[2:]
        res["ds2_train_steps_per_s"] = {"loop": len(exp.train_loss) / exp.train_seconds,
                                        "interior": len(steady) / sum(steady)}
        del exp
    for geometry, cfgs in (
            ("ds2", (cs.DS2_CINN_MODEL, cs.DS2_ENERGY_MODEL, cs.DS2_CINN_TRANSFORMS,
                     cs.DS2_ENERGY_TRANSFORMS)),
            ("ds3", (cs.DS3_CINN_MODEL, cs.DS3_ENERGY_MODEL, cs.DS3_CINN_TRANSFORMS,
                     cs.DS3_ENERGY_TRANSFORMS))):
        with tempfile.TemporaryDirectory() as tmp:
            _, times, generator = cs.cinn_phase(Path(tmp), geometry, *cfgs)
            res[f"{geometry}_cinn"] = {
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
