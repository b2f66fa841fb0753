"""Itemize the DiT block body's time by kernel on the card (port of
``tools/megakernel_residue.py``, K10).

The TPU harness times each segment of the block body inside one Pallas
kernel per segment (``_run``, over ``_seg_kernel`` and ``_full_kernel``),
the segment repeated R = 8 times in the kernel behind a data dependency, so
that per-cell copies and dispatch amortize. On the card the block body is
already split into hand-written kernels (K2b's body: ``vit_gemm``,
``vit_modln``, ``vit_attention``), so this harness times those kernels as
the sampling forward calls them, each R times back to back between two
CUDA events (behind a spin kernel that holds the card until the host has
queued them all), the median over a few trials. The segments map:

====================  ==============================================
TPU segment           kernel here
====================  ==============================================
qkv                   ``vit_gemm``, bias epilogue: (N, H) @ (H, 3H)
qk, scores, pv        ``vit_attention``, one segment: the scores,
                      softmax and P.V are fused in one kernel (online
                      softmax), so they cannot be timed apart
out                   ``vit_gemm``, gated-residual epilogue
mlp1                  ``vit_gemm``, GELU epilogue: (N, H) @ (H, F)
mlp2                  ``vit_gemm``, gated-residual epilogue
glue                  ``vit_modln`` x 2 (the gated residuals ride the
                      GEMMs' epilogues)
full                  K2b: the whole block body
====================  ==============================================

Each row has its bound: the larger of its bytes over the HBM rate and its
operations over the bf16 tensor-core peak (the TPU kernels' precision
contract, as the smoke's K2v rows), and its share of the full block.

    python -m vit4hep_tpu_torch.tools.megakernel_residue [ds2|ds3|both]

on a machine with a CUDA card (ds2: 135 tokens, batch 256; ds3: 450 tokens,
batch 64; hidden 480, 6 heads, MLP 1920). Without a card it refuses.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vit4hep_tpu_torch.ops import fused_dit_block as fdb
from vit4hep_tpu_torch.tools.timing import BF16_FLOPS, card_name, time_ms, work_bound

R = 8  # back-to-back launches of a segment between two CUDA events
TRIALS = 5
SHAPES = {"ds2": (135, 256), "ds3": (450, 64)}  # tokens, batch
HIDDEN, HEADS, MLP = 480, 6, 1920


def make_inputs(n, batch, hdim=HIDDEN, fdim=MLP, device="cuda"):
    """The block's operands from numpy seed 0: x (B, N, H) and the qkv panel
    f32, the modulated LayerNorm output and the GELU hidden in bf16 (the
    GEMMs' A operands), the bf16 weights and f32 biases, mods (B, 6, H)."""
    rng = np.random.default_rng(0)
    t = lambda *s, sc=0.1, dt=torch.float32: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * sc).astype(np.float32)).to(device=device, dtype=dt)
    bf, m = torch.bfloat16, batch * n
    return {"x": t(batch, n, hdim, sc=1.0), "qkv": t(batch, n, 3 * hdim, sc=1.0),
            "h": t(m, hdim, sc=1.0, dt=bf), "hid": t(m, fdim, dt=bf),
            "mod": t(batch, 6, hdim, sc=0.3),
            "wqkv": t(hdim, 3 * hdim, sc=0.05, dt=bf), "bqkv": t(3 * hdim, sc=0.05),
            "wout": t(hdim, hdim, sc=0.05, dt=bf), "bout": t(hdim, sc=0.05),
            "w1": t(hdim, fdim, sc=0.05, dt=bf), "b1": t(fdim, sc=0.05),
            "w2": t(fdim, hdim, sc=0.05, dt=bf), "b2": t(hdim, sc=0.05)}


def itemize(inputs, num_heads=HEADS):
    """Rows (segment, kernel, ms, bound ms, bound by) of one block body on
    ``inputs`` (:func:`make_inputs`), the last row K2b's whole block; raises
    ValueError unless every input is a CUDA tensor."""
    off = [k for k, v in inputs.items() if v.device.type != "cuda"]
    if off:
        raise ValueError(f"megakernel_residue times the CUDA kernels: inputs {off} are not on a "
                         "CUDA device")
    i = inputs
    b, n, hdim = i["x"].shape
    fdim, m, d = i["w1"].shape[1], b * n, hdim // num_heads
    scale = d ** -0.5
    x2, mod = i["x"].view(m, hdim), i["mod"]
    out_buf = torch.empty_like(x2)
    ctx = fdb.attention(i["qkv"], num_heads, scale)  # the out-projection's bf16 A operand

    def gemm(a, w, bias, epi, **kw):
        return lambda: fdb.linear(a, w, bias, epi, n_tok=n, **kw)

    def gemm_bytes(a, w, out_bytes, resid):
        k, nn = w.shape
        return (a.numel() * a.element_size() + w.numel() * 2 + nn * 4 + m * nn * out_bytes
                + (m * nn * 4 + b * nn * 4 if resid else 0))

    resid = dict(out=out_buf, resid=x2)
    segments = [
        ("qkv", "vit_gemm (bias)", gemm(i["h"], i["wqkv"], i["bqkv"], fdb.EPI_BIAS),
         gemm_bytes(i["h"], i["wqkv"], 4, False), 2 * m * hdim * 3 * hdim),
        ("qk+scores+pv", "vit_attention", lambda: fdb.attention(i["qkv"], num_heads, scale),
         i["qkv"].numel() * 4 + m * hdim * 2, 4 * b * num_heads * n * n * d),
        ("out", "vit_gemm (gated residual)",
         gemm(ctx.view(m, hdim), i["wout"], i["bout"], fdb.EPI_GATED_RESID, gate=mod[:, 2],
              **resid), gemm_bytes(ctx, i["wout"], 4, True), 2 * m * hdim * hdim),
        ("mlp1", "vit_gemm (GELU)", gemm(i["h"], i["w1"], i["b1"], fdb.EPI_BIAS_GELU),
         gemm_bytes(i["h"], i["w1"], 2, False), 2 * m * hdim * fdim),
        ("mlp2", "vit_gemm (gated residual)",
         gemm(i["hid"], i["w2"], i["b2"], fdb.EPI_GATED_RESID, gate=mod[:, 5], **resid),
         gemm_bytes(i["hid"], i["w2"], 4, True), 2 * m * fdim * hdim),
        ("glue", "vit_modln x 2",
         lambda: (fdb.modln(x2, mod[:, 0], mod[:, 1], n), fdb.modln(x2, mod[:, 3], mod[:, 4], n)),
         2 * (m * hdim * 4 + m * hdim * 2 + 2 * b * hdim * 4), 2 * 8 * m * hdim),
    ]
    ws = [i[k] for k in ("wqkv", "bqkv", "wout", "bout", "w1", "b1", "w2", "b2")]
    full_flops = 2 * m * (4 * hdim * hdim + 2 * hdim * fdim) + 4 * b * num_heads * n * n * d
    full_bytes = 4 * (2 * m * hdim + b * 6 * hdim) + sum(w.numel() * w.element_size() for w in ws)
    segments.append(("full", "K2b (block body)",
                     lambda: fdb._block_fwd_kernel(i["x"], mod, *ws, None, num_heads, scale),
                     full_bytes, full_flops))
    rows = []
    for name, kernel, fn, nbytes, flops in segments:
        ms = time_ms(fn, reps=TRIALS, repeat=R)
        rows.append((name, kernel, ms, *work_bound(nbytes, flops, BF16_FLOPS)))
    return rows


def table(tag, rows, card=""):
    """The rows as a text table: ms per block eval over the batch, share of
    the full block, bound and the bound's share of the time."""
    full = rows[-1][2]
    lines = [f"== {tag} ({card}) ==",
             f"{'segment':14s} {'kernel':28s} {'ms/eval':>9s} {'share':>7s} {'bound ms':>9s} "
             f"{'by':>10s} {'bound/ms':>8s}"]
    for name, kernel, ms, b_ms, by in rows:
        lines.append(f"{name:14s} {kernel:28s} {ms:9.4f} {100 * ms / full:6.1f}% {b_ms:9.4f} "
                     f"{by:>10s} {100 * b_ms / ms:7.1f}%")
    seg = sum(r[2] for r in rows[:-1])
    lines.append(f"{'SUM':14s} {'(segments)':28s} {seg:9.4f} {100 * seg / full:6.1f}%")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    which = args[0] if args else "both"
    if which not in ("ds2", "ds3", "both"):
        print("usage: python -m vit4hep_tpu_torch.tools.megakernel_residue [ds2|ds3|both]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("megakernel_residue: no CUDA device; it times the port's CUDA kernels",
              file=sys.stderr)
        return 2
    card = card_name()
    for tag in ("ds2", "ds3") if which == "both" else (which,):
        n, batch = SHAPES[tag]
        rows = itemize(make_inputs(n, batch))
        print(table(f"{tag}: {n} tokens, batch {batch}, hidden {HIDDEN}, {HEADS} heads, MLP {MLP}, "
                    f"R {R}", rows, card), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
