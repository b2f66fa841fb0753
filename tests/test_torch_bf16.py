"""Port parity of ``compute_dtype: bfloat16`` against the JAX package, on the
CPU: ViTNet, ViT1DNet and ParallelTransformerNet computing in bf16 with f32
parameters, K1 on a bf16 panel, a tiny bf16 cINN, one bf16 CFM train step and
the experiment's ``dtype``.

The same numpy inputs and the JAX params (converted by
``vit4hep_tpu_torch.utils.jax_params``) go through both packages. The JAX
nets run under ``jax.jit`` with XLA's excess precision off
(``xla_allow_excess_precision``: false; ``_strict``), so that each of XLA's
bf16 ops rounds its result to bf16 as it does op by op (by default jit
keeps some fused bf16 intermediates in f32: 2 ulps off); the port rounds
at the same ops (flax's Dense:
the product, then the bias; LayerNorm statistics in f32; SiLU and the tanh
GELU by JAX's formulas op by op, ``utils/misc.py``). JAX's Pallas kernels run
in interpret mode, which multiplies in f32, and the port's plain versions
do the same (``mm_dtype`` f32).

Tolerances, with their reasons:
- forward outputs: within one bf16 ulp of the output's scale (2^-8 of
  max |out|). Both sides round the same ops to bf16, so they differ only
  where an f32 sum (a product's or a LayerNorm's statistics, summed in
  another order) lands a value on the other side of a bf16 rounding
  boundary, and such a flip moves a later value by about one ulp.
- gradients of the f32 parameters: relative L2 within 2.5e-2 per tensor.
  The backward rounds to bf16 at every op too, but autograd and JAX's VJPs
  split some derivatives into other ops (the tanh and reciprocal
  derivatives, a LayerNorm's) and so round at other points: each such
  point moves a cotangent by up to half an ulp (2^-9 relative), which over
  the ~20 ops between the loss and a first-block weight gives ~1-2e-2 of a
  tensor's norm (measured at most 1.8e-2; JAX's own bf16 gradients are
  2.3-3.5e-2 from its f32 ones). Each test prints the JAX bf16 net's
  output gap to its f32 twin beside it, for scale (2.7-4.3e-2 of the
  output scale).
- exact: the dtype of every module's output, and of every kernel input.
"""

import logging
import math

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp
    import optax

    from tests.test_torch_chain import _energy_param as _chain_energy_param
    from tests.test_torch_chain import _pipelines, _shape_param
    from tests.test_torch_experiment import _tiny_ds2
    from vit4hep_tpu.experiments import train_state as jts
    from vit4hep_tpu.models.calochallenge import CaloChallengeCFM as JaxCaloChallengeCFM
    from vit4hep_tpu.models.calochallenge import CaloChallengeCINN as JaxCaloChallengeCINN
    from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer
    from vit4hep_tpu.models.vit import ViT as JaxViT
    from vit4hep_tpu.models.vit import ViT1D as JaxViT1D
    from vit4hep_tpu.models.vit import sampling_variant as jax_sampling_variant
    from vit4hep_tpu.ops import fused_dit_block as jfdb
    from vit4hep_tpu.ops import fused_energy_decoder as jfed
    from vit4hep_tpu.ops import fused_qkv_attention as jfqa
    from vit4hep_tpu.utils.config import Config as JaxConfig
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.experiments import train_state as ts
from vit4hep_tpu_torch.experiments.main import main
from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCFM, CaloChallengeCINN
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models import energy_transformer as tet
from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import ViT, ViT1D, sampling_variant
from vit4hep_tpu_torch.ops import fused_dit_block as tfdb
from vit4hep_tpu_torch.ops import fused_energy_decoder as tfed
from vit4hep_tpu_torch.ops import fused_qkv_attention as fqa
from vit4hep_tpu_torch.utils.config import Config
from vit4hep_tpu_torch.utils.jax_params import (convert_cinn_params, convert_energy_params,
                                                convert_vit_params)
from vit4hep_tpu_torch.utils import serving
from vit4hep_tpu_torch.utils.misc import compute_dtype

BF16_GRAD_REL = 2.5e-2


def _strict(fn, *args):
    """``fn(*args)`` compiled by jit with XLA's excess precision off: every
    bf16 op's result rounded to bf16, as op by op."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _ulp_bound(ref):
    """One bf16 ulp of the output's scale: 2^-8 of max |ref| (at least 1)."""
    return 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))


def _perturbed(params, rng, std=0.1):
    """Non-zero adaLN and final-layer weights, so that every layer acts (the
    params are made under jit: only the nets' applications run op by op)."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        params)


def _rel_l2(got, want):
    """{name: |got - want| / |want|} over the tensors of ``want`` with a
    non-zero norm."""
    return {k: float((got[k] - v).norm() / v.norm()) for k, v in want.items() if v.norm() > 0}


def _vit_param(fused, causal, impl, dt):
    return dict(dim=3, condition_dim=5, hidden_dim=48, out_channels=1, depth=2, num_heads=4,
                mlp_ratio=2, pos_embedding_coords="cylindrical", learn_pos_embed=True,
                causal_attn=causal, num_patches=[[2, 2, 3]], patch_dim=6, attn_impl=impl,
                fused_block=fused, compute_dtype=dt)


VIT_CASES = {  # (fused_block, causal_attn, attn_impl)
    "composed-auto": (False, False, "auto"),  # 12 tokens: auto takes xla, the plain attention
    "composed-fused": (False, False, "fused"),  # K1's plain version on a bf16 panel
    "sample-twin": ("sample", False, "auto"),  # K2v's plain version, the training net composed
    "layer-causal": (False, True, "fused"),
    "fused-block-true": (True, False, "auto"),  # K5a / K5b forward and backward, K2v sampling
}


def _vit_inputs(rng):
    return (rng.normal(size=(3, 12, 6)).astype(np.float32),
            rng.uniform(size=(3, 1)).astype(np.float32),
            rng.normal(size=(3, 5)).astype(np.float32))


@pytest.mark.parametrize("case", list(VIT_CASES))
def test_vitnet_bf16_matches_jax(case):
    """The sampling net's output and the training net's gradients of
    sum(out^2) with respect to the f32 parameters, bf16 against JAX's bf16."""
    fused, causal, impl = VIT_CASES[case]
    rng = np.random.default_rng(4)
    x, t, c = _vit_inputs(rng)
    jnet = JaxViT(_vit_param(fused, causal, impl, "bfloat16"))
    jnet32 = JaxViT(_vit_param(fused, causal, impl, "float32"))
    params = _perturbed(jax.jit(jnet.init)(jax.random.PRNGKey(0), x, t, c), rng)
    ref, jgrad = _strict(lambda p: (
        jax_sampling_variant(jnet).apply(p, x, t, c),
        jax.grad(lambda q: jnp.sum(jnet.apply(q, x, t, c) ** 2))(p)), params)
    ref, jgrad = np.asarray(ref), convert_vit_params(jgrad)
    # the f32 twin's output, for scale only (plain jit)
    ref32 = np.asarray(jax.jit(jax_sampling_variant(jnet32).apply)(params, x, t, c))

    net = ViT(_vit_param(fused, causal, impl, "bfloat16"))
    net.load_state_dict(convert_vit_params(params))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    args = tuple(map(torch.from_numpy, (x, t, c)))
    with torch.no_grad():
        out = sampling_variant(net)(*args)
    assert out.dtype == torch.float32
    loss = (net(*args) ** 2).sum()
    grads = dict(zip([n for n, _ in net.named_parameters()],
                     torch.autograd.grad(loss, list(net.parameters()))))
    err, gap = np.abs(out.numpy() - ref).max(), np.abs(ref32 - ref).max()
    rel = _rel_l2(grads, jgrad)
    print(f"{case}: out {err:.3g} (JAX bf16 vs f32 {gap:.3g}, scale {np.abs(ref).max():.3g}); "
          f"grad rel L2 {max(rel.values()):.3g}")
    assert err <= _ulp_bound(ref)
    assert max(rel.values()) <= BF16_GRAD_REL, max(rel, key=rel.get)


def _flat_intermediates(inter):
    """{flax module path: its __call__ output} of capture_intermediates."""
    leaves = jax.tree_util.tree_flatten_with_path(inter["intermediates"])[0]
    out = {}
    for path, v in leaves:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if keys[-2] == "__call__" and keys[-1] == "0":
            out["/".join(keys[:-2])] = v
    return out


# the port's module name -> the flax module path, where both have a module
def _vit_module_map(depth=2):
    names = {"": "", "t_embedder": "t_embedder", "c_embedder": "c_embedder",
             "c_embedder.0": "c_embedder/Dense_0", "t_embedder.mlp.0": "t_embedder/Dense_0",
             "x_embedder": "x_embedder", "final_layer": "final_layer",
             "final_layer.adaLN_modulation.1": "final_layer/adaLN_modulation",
             "final_layer.linear": "final_layer/Dense_0"}
    for i in range(depth):
        names.update({
            f"blocks.{i}": f"block_{i}",
            f"blocks.{i}.adaLN_modulation.1": f"block_{i}/adaLN_modulation",
            f"blocks.{i}.attn": f"block_{i}/Attention_0",
            f"blocks.{i}.attn.qkv": f"block_{i}/Attention_0/Dense_0",  # the qkv panel
            f"blocks.{i}.attn.proj": f"block_{i}/Attention_0/Dense_1",
            f"blocks.{i}.mlp": f"block_{i}/MlpBlock_0",
            f"blocks.{i}.mlp.fc1": f"block_{i}/MlpBlock_0/Dense_0",
            f"blocks.{i}.mlp.fc2": f"block_{i}/MlpBlock_0/Dense_1"})
    return names


def _port_dtypes(net, args, names):
    seen = {}

    def hook(name):
        def record(mod, inputs, output):  # returns None: the output stays as it is
            seen.setdefault(name, output.dtype)

        return record

    hooks = [m.register_forward_hook(hook(n)) for n, m in net.named_modules() if n in names]
    with torch.no_grad():
        net(*args)
    for h in hooks:
        h.remove()
    return seen


def _record_args(monkeypatch, module, fn_name, log):
    """Record (dtype name, f32 numpy values, or None for a traced JAX
    array) of each array argument of ``module.fn_name``, a list a call."""
    fn = getattr(module, fn_name)

    def value(v):
        if torch.is_tensor(v):
            return np.asarray(v.detach().float())
        return None if isinstance(v, jax.core.Tracer) else np.asarray(v.astype(jnp.float32))

    def wrapped(*a, **kw):
        log.append([(str(v.dtype).replace("torch.", ""), value(v))
                    for v in a if hasattr(v, "dtype") and getattr(v, "ndim", 0) > 0])
        return fn(*a, **kw)

    monkeypatch.setattr(module, fn_name, wrapped)


# the modulations' positions among the kernel functions' array arguments
_MODS = {"fused_vit_forward": (2, 3), "fused_dit_block": (1,)}


@pytest.mark.parametrize("fused", [False, True, "sample-twin"])
def test_vit_bf16_module_dtypes_equal_jax(fused, monkeypatch):
    """Every module's output dtype equals JAX's (bf16 residual stream and
    qkv panel, f32 net output), exactly. The kernel tier's inputs are JAX's:
    the tokens / residual stream in f32, the adaLN modulations rounded to
    bf16 (JAX hands its kernels the bf16 modulations, which they cast to
    f32; the port's kernels take those values in f32), equal bit for bit.
    ``sample-twin`` is the fused_block: sample twin (K2v); ``True`` the
    per-block kernel path (fused_stack false, K2b)."""
    rng = np.random.default_rng(9)
    x, t, c = _vit_inputs(rng)
    param = _vit_param(fused is not False, False, "fused", "bf16")
    if fused is True:
        param["fused_stack"] = False
    jnet = JaxViT(param)
    params = _perturbed(jax.jit(jnet.init)(jax.random.PRNGKey(0), x, t, c), rng)
    net = ViT(param)
    net.load_state_dict(convert_vit_params(params))
    if fused == "sample-twin":
        param["fused_block"] = "sample"
        jnet, net = jax_sampling_variant(JaxViT(param)), sampling_variant(ViT(param))
        net.load_state_dict(convert_vit_params(params))
    jlog, tlog = {}, {}
    for mod, log in ((jfdb, jlog), (tfdb, tlog)):
        for fn in _MODS:
            _record_args(monkeypatch, mod, fn, log.setdefault(fn, []))
    _, inter = jnet.apply(params, x, t, c, capture_intermediates=True)
    jdt = {k: str(v.dtype) for k, v in _flat_intermediates(inter).items()}
    names = {p: f for p, f in _vit_module_map().items() if f in jdt}
    assert len(names) >= (6 if fused else 20)
    tdt = _port_dtypes(net, tuple(map(torch.from_numpy, (x, t, c))), names)
    got = {p: str(tdt[p]).replace("torch.", "") for p in names if p in tdt}
    assert got == {p: jdt[f] for p, f in names.items() if p in tdt}
    assert got[""] == "float32" and got["t_embedder"] == "bfloat16"
    calls = [(fn, j, t) for fn in _MODS for j, t in zip(jlog[fn], tlog[fn], strict=True)]
    if fused is False:
        assert got["blocks.0.attn.qkv"] == got["blocks.1"] == "bfloat16"
        assert not calls
        return
    assert calls
    for k, (fn, jcall, tcall) in enumerate(calls):
        assert [dt for dt, _ in tcall] == ["float32"] * len(jcall)
        assert [dt for dt, _ in jcall] == ["bfloat16" if i in _MODS[fn] else "float32"
                                           for i in range(len(jcall))]
        # the modulations bit for bit, and the first call's tokens / stream
        # (a later block's stream is the previous kernel's f32 output)
        for i in _MODS[fn] + ((0,) if k == 0 else ()):
            np.testing.assert_array_equal(tcall[i][1], jcall[i][1])


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "causal"])
@pytest.mark.parametrize("heads,d", [(2, 80), (4, 16)], ids=["per-head-80", "packed-16"])
def test_k1_bf16_panel_matches_jax_interpret(masked, heads, d):
    """fused_qkv_attention on a bf16 panel: the bf16 context, the f32 lse
    and the bf16 dqkv against JAX's kernel in interpret mode (which
    multiplies the bf16 values in f32, as the plain version does). Both
    store in bf16 what f32 sums give, in another order: one bf16 ulp of the
    scale."""
    rng = np.random.default_rng(11)
    b, n = 2, 40
    qkv = jnp.asarray(rng.normal(size=(b, n, 3 * heads * d)).astype(np.float32)).astype(
        jnp.bfloat16)
    g = jnp.asarray(rng.normal(size=(b, n, heads * d)).astype(np.float32)).astype(jnp.bfloat16)
    mask = np.tril(np.ones((n, n), bool)) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    out_j, (_, _, lse_j) = _strict(lambda a: jfqa._fused_fwd(a, heads, jmask), qkv)
    (dqkv_j,) = _strict(lambda a, gg: jax.vjp(
        lambda b: jfqa.fused_qkv_attention(b, heads, jmask), a)[1](gg), qkv, g)
    assert out_j.dtype == dqkv_j.dtype == jnp.bfloat16

    x = torch.from_numpy(np.asarray(qkv.astype(jnp.float32))).to(torch.bfloat16)
    x.requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fqa.fused_qkv_attention(x, heads, tmask)
    out.backward(torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(torch.bfloat16))
    _, lse = fqa.attention_fwd_plain(x.detach(), heads, d ** -0.5, tmask)
    assert out.dtype == x.grad.dtype == torch.bfloat16 and lse.dtype == torch.float32
    for got, want in ((out, out_j), (x.grad, dqkv_j)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(got.detach().float().numpy() - want).max() <= _ulp_bound(want)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-5, rtol=1e-6)


def test_k1_bf16_plain_rounds_p_and_ds_and_other_dtypes_raise():
    """The plain versions' mm_dtype bf16 (the card's oracle of the bf16 arm)
    rounds P and dS to bf16 before their products, as JAX's kernel does off
    interpret mode; other dtypes than f32 and bf16 raise."""
    rng = np.random.default_rng(12)
    qkv = torch.from_numpy(rng.normal(size=(2, 30, 3 * 2 * 16)).astype(np.float32))
    qkv16 = qkv.to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(2, 30, 32)).astype(np.float32)).to(torch.bfloat16)
    s = 16 ** -0.5
    out, lse = fqa.attention_fwd_plain(qkv16, 2, s, mm_dtype=torch.bfloat16)
    q, k, v = fqa._heads(qkv16.float(), 2, 3)
    sc = q @ k.transpose(-1, -2) * s
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    want = (p.to(torch.bfloat16).float() @ v) / p.sum(-1, keepdim=True)
    assert torch.equal(out, fqa._merge(want).to(torch.bfloat16))
    dq = fqa.attention_bwd_plain(qkv16, g, lse, 2, s, mm_dtype=torch.bfloat16)
    dq32 = fqa.attention_bwd_plain(qkv16, g, lse, 2, s)
    assert dq.dtype == torch.bfloat16 and 0 < (dq.float() - dq32.float()).abs().max() < 0.1
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fqa.fused_qkv_attention(qkv.half(), 2)


@pytest.mark.parametrize("name,dtype", [("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
                                        ("float32", torch.float32), ("fp32", torch.float32),
                                        ("float16", torch.float32)])
def test_compute_dtype_names_map_as_jax(name, dtype, caplog):
    """bf16 for "bfloat16" and "bf16", f32 for anything else, as JAX's
    ViTParams.dtype; a name that is neither logs a warning."""
    with caplog.at_level(logging.WARNING, logger="vit4hep-tpu"):
        assert compute_dtype(name) is dtype
    assert sum("neither" in r.message for r in caplog.records) == (name == "float16")


def _vit1d_param(dt, **kw):
    return {**dict(dim=1, condition_dim=5, hidden_dim=32, out_channels=1, depth=2, num_heads=2,
                   mlp_ratio=2.0, learn_pos_embed=True, num_patches=[[10, 1, 1]], patch_dim=6,
                   x_out=7, attn_impl="fused", compute_dtype=dt), **kw}


@pytest.mark.parametrize("fused", [False, "sample"])
def test_vit1d_bf16_matches_jax(fused):
    """ViT1DNet in bf16 (its sampling twin for ``sample``): the output, f32."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 10, 6)).astype(np.float32)
    c = rng.normal(size=(2, 5)).astype(np.float32)
    jnet = JaxViT1D(_vit1d_param("bfloat16", fused_block=fused))
    params = _perturbed(jax.jit(jnet.init)(jax.random.PRNGKey(0), x, c), rng)
    ref = np.asarray(_strict(jax_sampling_variant(jnet).apply, params, x, c))
    net = ViT1D(_vit1d_param("bfloat16", fused_block=fused))
    net.load_state_dict(convert_vit_params(params))
    with torch.no_grad():
        out = sampling_variant(net)(torch.from_numpy(x), torch.from_numpy(c))
    assert out.dtype == torch.float32 and out.shape == (2, 10, 42)
    assert np.abs(out.numpy() - ref).max() <= _ulp_bound(ref)


L, A, R = 6, 4, 3


def _tiny_cinn_kwargs():
    return dict(shape=[L, A, R], patch_shape=[[3, 2, 1]], in_channels=1,
                coupling_block="CaloRQSplineFrEIA", nblocks=2, is_spatial=[False, True],
                cinn_kwargs={"fused_spline": True, "bins": 10, "min_bin_sizes": [0.001, 0.001],
                             "default_domain": [-8.0, 8.0, -8.0, 8.0], "identity_tails": False,
                             "domain_clamping": None},
                vit_kwargs={"dim": 1, "condition_dim": 5, "hidden_dim": 32, "out_channels": 1,
                            "depth": 1, "num_heads": 2, "mlp_ratio": 2.0,
                            "learn_pos_embed": True, "causal_attn": False,
                            "checkpoint_grads": False, "compute_dtype": "bfloat16"})


def test_tiny_cinn_bf16_matches_jax():
    """A tiny CaloChallengeCINN whose ViT1D subnets compute in bf16 (the spline math in f32,
    K4's plain version on the sampling side): the log-likelihood, a sample on JAX's own z,
    and the loss of one train step (through experiments/train_state) against JAX's batch
    loss on the same batch (its negative log-likelihood). A coupling's spline turns a
    subnet's bf16 ulp flip into an f32 change of its output; the couplings compound it: 1e-3
    of the scale."""
    rng = np.random.default_rng(8)
    jmodel = JaxCaloChallengeCINN(**_tiny_cinn_kwargs())
    params = _perturbed(jax.jit(jmodel.init_params)(jax.random.PRNGKey(1)), rng, 0.05)
    model = CaloChallengeCINN(**_tiny_cinn_kwargs())
    model.net.load_state_dict(convert_cinn_params(params))
    assert model.net.blocks[0].subnet1.dt == torch.bfloat16
    x = rng.normal(size=(3, 1, L, A, R)).astype(np.float32)
    c = rng.normal(size=(3, 5)).astype(np.float32)
    ref = float(_strict(jmodel.log_prob, params, x, c))
    with torch.no_grad():
        lp = float(model.log_prob(torch.from_numpy(x), torch.from_numpy(c)))
    assert abs(lp - ref) <= 1e-3 * abs(ref), (lp, ref)

    key = jax.random.PRNGKey(9)
    sample_j = np.asarray(_strict(jmodel.sample_batch, params, jnp.asarray(c), key))
    z = torch.from_numpy(np.array(jax.random.normal(key, jmodel.x_shape(3), jnp.float32)))
    sample_t = model.sample_batch(torch.from_numpy(c), z=z)
    assert sample_t.dtype == torch.float32
    assert np.abs(sample_t.numpy() - sample_j).max() <= 1e-3 * np.abs(sample_j).max()

    tcfg = dict(lr=1e-4, iterations=10, optimizer="AdamW", betas=[0.9, 0.999], eps=1e-6,
                weight_decay=0.0, scheduler=None)
    state = ts.create_train_state(model, Config(tcfg), use_ema=False)
    step = ts.make_train_step(lambda x, c: model.batch_loss(x, c), clip_grad_norm=1000)
    m = step(state, (torch.from_numpy(x), torch.from_numpy(c)))  # JAX's batch loss: -log_prob
    assert m["skipped"] == 0 and abs(float(m["loss"]) + ref) <= 1e-3 * abs(ref)


def _energy_param(fused, dt):
    return dict(dims_in=L, dims_c=1, dim_embedding=16, nhead=2, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=32, activation="gelu", embeds=True,
                encode_t_dim=16, encode_t_scale=30, fused_block=fused, compute_dtype=dt)


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused-block"])
def test_energy_transformer_bf16_matches_jax(fused, monkeypatch):
    """ParallelTransformerNet in bf16: composed (attention through
    dot_product_attention's plain version) and with ``fused_block: true``
    (K3's plain version, its target and time features in f32 from bf16
    values, the cross terms in f32). The output f32; the kernel's inputs in
    JAX's dtypes, exactly (JAX's under jit: their dtypes as traced)."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(5, L)).astype(np.float32)
    t = rng.uniform(size=(5, 1)).astype(np.float32)
    c = rng.uniform(size=(5, 1)).astype(np.float32)
    jnet = JaxParallelTransformer(_energy_param(fused, "bfloat16"))
    params = _perturbed(jax.jit(jnet.init)(jax.random.PRNGKey(0), x, t, c), rng, 0.05)
    ref32 = np.asarray(jax.jit(JaxParallelTransformer(_energy_param(fused, "float32")).apply)(
        params, x, t, c))  # for scale only
    jlog, tlog = [], []
    _record_args(monkeypatch, jfed, "fused_energy_decoder", jlog)
    _record_args(monkeypatch, tfed, "fused_energy_decoder", tlog)
    monkeypatch.setattr(tet, "fused_energy_decoder", tfed.fused_energy_decoder)
    ref = np.asarray(_strict(jnet.apply, params, x, t, c))
    net = ParallelTransformer(_energy_param(fused, "bfloat16"))
    net.load_state_dict(convert_energy_params(params))
    with torch.no_grad():
        out = net(*map(torch.from_numpy, (x, t, c)))
    err = np.abs(out.numpy() - ref).max()
    print(f"energy {fused}: {err:.3g} (JAX bf16 vs f32 {np.abs(ref - ref32).max():.3g})")
    assert out.dtype == torch.float32 and err <= _ulp_bound(ref)
    assert len(tlog) == len(jlog) == int(fused)
    for tcall, jcall in zip(tlog, jlog):
        assert [dt for dt, _ in tcall] == [dt for dt, _ in jcall] == ["float32"] * len(jcall)


def test_cfm_bf16_train_step_matches_jax():
    """One CFM train step of a tiny bf16 ViT (``attn_impl: fused``: K1's plain version on a
    bf16 panel) through experiments/train_state against JAX's: its loss and gradients op by
    op, then optax's AdamW update (f32, under jit): the loss, then the parameters after the
    step. The loss is a forward (one ulp of its scale); Adam's first step moves each entry
    by lr times the sign of its gradient (m / sqrt(v) = g / |g|), so an entry moves the
    other way only where its bf16 gradient is at rounding noise: the update vector within
    0.3 relative L2 (a wrong gradient gives ~1.4), and the parameters within 2 lr."""
    rng = np.random.default_rng(50)
    # the ViT tests' net and batch (a (2, 4, 9) shower in (1, 2, 3) patches:
    # 12 tokens of 6), whose JAX ops are compiled once in this file
    vit = dict(_vit_param("sample", False, "fused", "bfloat16"))
    geometry = dict(patch_shape=[1, 2, 3], shape=[2, 4, 9])
    jmodel = JaxCaloChallengeCFM(JaxViT(vit), **geometry)
    model = CaloChallengeCFM(ViT(vit), **geometry)
    params = _perturbed(jax.jit(jmodel.init_params)(jax.random.PRNGKey(5)), rng, 0.05)
    model.net.load_state_dict(convert_vit_params(params))
    lr = 1e-3
    tcfg = dict(lr=lr, iterations=10, optimizer="AdamW", betas=[0.9, 0.999], eps=1e-6,
                weight_decay=0.0, scheduler=None)
    tx = jts.make_optimizer(JaxConfig(tcfg), jts.make_schedule(JaxConfig(tcfg)))

    def jloss(p, x, c, t, x_0):
        x_t, x_t_dot = jmodel.trajectory(x_0, x, t)
        return jnp.mean((jmodel.forward(p, x_t, t.reshape(-1, 1), c) - x_t_dot) ** 2)

    state = ts.create_train_state(model, Config(tcfg), use_ema=False)
    step = ts.make_train_step(lambda x, c, t, x_0: model.batch_loss(x, c, t=t, x_0=x_0),
                              clip_grad_norm=1000)
    x = rng.normal(size=(3, 1, 2, 4, 9)).astype(np.float32)
    c = rng.uniform(size=(3, 5)).astype(np.float32)
    t = rng.uniform(size=(3, 1, 1, 1, 1)).astype(np.float32)
    x_0 = rng.normal(size=x.shape).astype(np.float32)
    jl, jg = _strict(jax.value_and_grad(jloss), params, x, c, t, x_0)
    updates, _ = jax.jit(tx.update)(jg, tx.init(params), params)
    jparams = jax.jit(optax.apply_updates)(params, updates)
    m = step(state, tuple(map(torch.from_numpy, (x, c, t, x_0))))
    assert abs(float(m["loss"]) - float(jl)) <= 2.0 ** -8 * abs(float(jl))
    want, init = convert_vit_params(jparams), convert_vit_params(params)
    got = model.net.state_dict()
    num = sum(float(((got[k] - init[k]) - (want[k] - init[k])).norm() ** 2) for k in want)
    den = sum(float((want[k] - init[k]).norm() ** 2) for k in want)
    assert math.sqrt(num / den) <= 0.3, math.sqrt(num / den)
    assert max(float((got[k] - want[k]).abs().max()) for k in want) <= 2 * lr * 1.001


def test_experiment_dtype_is_logged_and_changes_nothing(tmp_path):
    """``dtype=bfloat16`` through the launcher is resolved and logged, as
    the JAX experiment does, and no module reads it: the run's losses equal
    those of ``dtype=float32`` bit for bit."""
    losses = {}
    for dt in ("float32", "bfloat16"):
        work = tmp_path / dt
        work.mkdir()
        exp = main(["-cn", "calochallenge/cfm/calochallenge_ds2", *_tiny_ds2(work),
                    f"dtype={dt}", "training.iterations=2",
                    "training.validate_every_n_steps=2"], device="cpu")
        assert exp.dtype == getattr(torch, dt)
        log = (work / "runs" / "Tiny" / "run" / "out_0.log").read_text()
        assert f"Using dtype torch.{dt}" in log
        losses[dt] = (exp.train_loss, exp.val_loss)
    assert losses["bfloat16"] == losses["float32"]
    with pytest.raises(ValueError, match="not supported"):
        main(["-cn", "calochallenge/cfm/calochallenge_ds2", *_tiny_ds2(tmp_path),
              "dtype=float8", "training.iterations=1"], device="cpu")


EULER = {"method": "euler", "options": {"step_size": 1.0}}  # one net eval a model


@pytest.mark.parametrize("chain", ["cfm", "cinn"])
def test_bf16_chain_serves_and_exports_as_live(tmp_path, chain):
    """A bf16-configured two-stage chain (a bf16 energy CFM behind a bf16
    shape CFM, or a cINN whose subnets are bf16: K1's forward on a bf16
    panel) serves through ``utils/serving.Generator`` and exports
    (``torch.export``, the kernels as registered ops): after a file round
    trip the artifact's showers equal the live generator's bit for bit."""
    (shape_tf, energy_tf), _ = _pipelines(tmp_path)
    torch.manual_seed(0)
    energy = CFM(ParallelTransformer(dict(_chain_energy_param(), compute_dtype="bfloat16")),
                 shape=[L], odeint_kwargs=EULER)
    if chain == "cfm":
        shape = CaloChallengeCFM(ViT(dict(_shape_param(), compute_dtype="bfloat16")),
                                 patch_shape=[3, 4, 1], shape=[L, A, R], odeint_kwargs=EULER)
    else:
        kw = _tiny_cinn_kwargs()
        shape = CaloChallengeCINN(**dict(kw, vit_kwargs=dict(kw["vit_kwargs"], condition_dim=L + 1,
                                                             attn_impl="fused")))
    with torch.no_grad():
        for p in (*shape.parameters(), *energy.parameters()):
            p.add_(0.1 * torch.randn(p.shape))
    gen = serving.Generator(shape, energy, energy_tf, shape_tf, batch=3)
    program, header = serving.trace_generator(shape, energy, energy_tf, shape_tf, 3,
                                              meta={"chain": chain})
    path = tmp_path / "generator.v4h"
    path.write_bytes(serving.artifact_bytes(program, header))
    cond = gen.condition(10 ** np.random.default_rng(0).uniform(3, 6, 3))
    live = gen(cond, seed=0)
    assert live.dtype == torch.float32 and torch.isfinite(live).all()
    assert torch.equal(serving.load_sampler(path)(cond, seed=0), live)


# ---------------------------------------------------------------------------
# on the card: K1's bf16 arm against its bf16 plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _bf16_bound(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * max(1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True, "dead-row"])
@pytest.mark.parametrize("b,n,heads,d", [(3, 135, 6, 80), (2, 65, 4, 48), (2, 130, 2, 16),
                                         (1, 77, 2, 13), (2, 200, 2, 128)])
def test_k1_bf16_arm_matches_plain_on_cuda(cuda_device, b, n, heads, d, masked):
    """The bf16 arm's forward, delta, dK/dV and dQ against the plain
    versions on bf16 multiplicands (mm_dtype bf16): summation order and a
    p or ds element flipped across a bf16 rounding boundary (2e-3 of the
    scale forward, 4e-3 backward), then both sides' bf16 rounding of the
    context and dqkv one ulp apart (up to 2^-7 of the scale): 1e-2 and
    1.2e-2 (chip_smoke.py's TOL reasons them)."""
    gen = torch.Generator(device="cuda").manual_seed(b * n + d)
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(b, n, heads * d, generator=gen, device="cuda").to(torch.bfloat16)
    mask = None
    if masked:
        mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device="cuda"))
        if masked == "dead-row":
            mask[5] = False
    s = d ** -0.5
    out, lse = fqa.attention_fwd_bf16_kernel(qkv, heads, s, mask)
    out_p, lse_p = fqa.attention_fwd_plain(qkv, heads, s, mask, mm_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _bf16_bound(out, out_p, 1e-2)
    _bf16_bound(lse, lse_p, 1e-4)
    delta = fqa.attention_bwd_delta_bf16_kernel(g, out, heads)
    _bf16_bound(delta, fqa.delta_plain(g, out, heads), 1e-4)
    dqkv = fqa.attention_bwd_bf16_kernel(qkv, g, out, lse, heads, s, mask)
    want = fqa.attention_bwd_plain(qkv, g, lse, heads, s, mask, mm_dtype=torch.bfloat16, out=out)
    assert dqkv.dtype == torch.bfloat16
    _bf16_bound(dqkv, want, 1.2e-2)
