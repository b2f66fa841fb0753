"""Port parity of the training slice against the JAX package, on the CPU.

The same converted initial params (vit4hep_tpu_torch.utils.jax_params) and
the same numpy batches and draws (x, c, t, x_0) go through JAX
``make_train_step`` with optax and the port's ``make_train_step`` with
torch.optim; the loss, ``grad_norm``, ``grad_norm_net``, the params and the
EMA are compared after every step. The skip guard (a nonfinite loss, a
spike past MIN_STEP_SKIP) and the EMA warm-up are held against the JAX state
the same way, Adam's moments and the schedule's count included. On the JAX
side a loss function takes ``t`` and ``x_0`` (and a loss factor) as batch
entries, so no JAX file changes.

Tolerances: losses and norms rtol 1e-5 (f32 forward and backward on both
sides, summation order only). Params and EMA atol 1e-5 after lr 1e-3 steps,
with Adam's eps at 1e-6: Adam divides each gradient entry by its own RMS, so
an entry whose true gradient is zero (the key bias, to which softmax is
invariant) or cancels to near zero carries rounding noise that eps 1e-8
turns into updates of up to lr (one ViT entry moved by 4.8e-6, an energy
key bias by 1.4e-5); eps 1e-6 keeps noise of ~1e-9 below 1e-3 of lr, and
1e-5 is 1% of one step's lr, while a wrong update rule is off by ~lr.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit4hep_tpu.experiments import train_state as jts
from vit4hep_tpu.models.calochallenge import CaloChallengeCFM as JaxCaloChallengeCFM
from vit4hep_tpu.models.cfm import CFM as JaxCFM
from vit4hep_tpu.models.energy_transformer import ParallelTransformer as JaxParallelTransformer
from vit4hep_tpu.models.vit import ViT as JaxViT
from vit4hep_tpu.utils.config import Config as JaxConfig
from vit4hep_tpu_torch.experiments import train_state as ts
from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCFM
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import ViT
from vit4hep_tpu_torch.utils.config import Config
from vit4hep_tpu_torch.utils.jax_params import convert_energy_params, convert_vit_params

L, A, R = 6, 4, 3
B = 4


def _vit_param(**kw):
    return {**dict(dim=3, condition_dim=L + 1, hidden_dim=48, out_channels=1, depth=2,
                   num_heads=4, mlp_ratio=2, pos_embedding_coords="cylindrical",
                   learn_pos_embed=True, causal_attn=False, num_patches=[[2, 1, 3]],
                   patch_dim=12, attn_impl="fused", fused_block="sample",
                   compute_dtype="float32"), **kw}


def _energy_param():
    return dict(dims_in=L, dims_c=1, dim_embedding=16, nhead=2, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=32, activation="relu", embeds=True,
                encode_t_dim=16, encode_t_scale=30, fused_block="sample")


def _training(**kw):
    cfg = dict(lr=1e-3, iterations=10, optimizer="AdamW", betas=[0.9, 0.999], eps=1e-6,
               weight_decay=0.1, scheduler="CosineAnnealingLR", scheduler_scale=1,
               cosanneal_eta_min=0, onecycle_max_lr=10, onecycle_pct_start=0.2)
    cfg.update(kw)
    return cfg


def _models(kind, rng, **vit_kw):
    """(jax model, jax params, port model) with the same (perturbed) params."""
    key = jax.random.PRNGKey(5)
    if kind == "vit":
        jmodel = JaxCaloChallengeCFM(JaxViT(_vit_param(**vit_kw)), patch_shape=[3, 4, 1],
                                     shape=[L, A, R])
        model = CaloChallengeCFM(ViT(_vit_param(**vit_kw)), patch_shape=[3, 4, 1],
                                 shape=[L, A, R])
        convert = convert_vit_params
    else:
        jmodel = JaxCFM(JaxParallelTransformer(_energy_param()), shape=[L])
        model = CFM(ParallelTransformer(_energy_param()), shape=[L])
        convert = convert_energy_params
    params = jax.tree.map(  # non-zero adaLN / final-layer weights
        lambda a: np.asarray(a, np.float32) + rng.normal(0, 0.05, a.shape).astype(np.float32),
        jmodel.init_params(key))
    model.net.load_state_dict(convert(params))
    return jmodel, params, model, convert


def _batches(rng, x_shape, n_steps):
    out = []
    for _ in range(n_steps):
        x = rng.normal(size=(B, *x_shape)).astype(np.float32)
        c = rng.uniform(size=(B, L + 1 if len(x_shape) > 1 else 1)).astype(np.float32)
        t = rng.uniform(size=(B,) + (1,) * len(x_shape)).astype(np.float32)
        x_0 = rng.normal(size=x.shape).astype(np.float32)
        out.append((x, c, t, x_0))
    return out


def _jax_loss(jmodel):
    def loss_fn(params, x, c, t, x_0, rng):
        del rng
        x_t, x_t_dot = jmodel.trajectory(x_0, x, t)
        v = jmodel.forward(params, x_t, t.reshape(-1, 1), c)
        return jnp.mean((v - x_t_dot) ** 2)

    return loss_fn


def _port_loss(model):
    return lambda x, c, t, x_0: model.batch_loss(x, c, t=t, x_0=x_0)


def _assert_params(sd_port, jparams, convert, atol):
    want = convert(jparams)
    assert set(want) == set(sd_port)
    for k, v in want.items():
        np.testing.assert_allclose(sd_port[k].detach().numpy(), v.numpy(), atol=atol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("kind,tcfg,vit_kw,n_steps", [
    ("vit", _training(), {}, 3),  # the ds2 default: AdamW + cosine
    ("vit", _training(optimizer="Adam", scheduler=None, clip_grad_value=0.05), {}, 3),
    # past RAdam's rectification threshold (rho_t >= 5 from step 6 at beta2 0.999)
    ("vit", _training(optimizer="RAdam", scheduler="OneCycleLR"), {}, 10),
    ("energy", _training(), {}, 3),
    # the megakernel tier: K5a forward, K5b backward / the plain hybrid
    # backward / per-block K2b with K5c (plain versions on the CPU, JAX's
    # Pallas kernels in interpret mode)
    ("vit", _training(), dict(fused_block=True), 3),
    ("vit", _training(), dict(fused_block="hybrid"), 3),
    ("vit", _training(), dict(fused_block=True, fused_stack=False), 3),
], ids=["vit-adamw-cosine", "vit-adam-l2-clipvalue", "vit-radam-onecycle", "energy-adamw-cosine",
        "vit-fused", "vit-hybrid", "vit-fused-nostack"])
def test_train_step_matches_jax(kind, tcfg, vit_kw, n_steps):
    rng = np.random.default_rng(50)
    jmodel, params, model, convert = _models(kind, rng, **vit_kw)
    x_shape = (1, L, A, R) if kind == "vit" else (L,)
    clip = dict(clip_grad_value=tcfg.get("clip_grad_value"), clip_grad_norm=0.5)

    tx = jts.make_optimizer(JaxConfig(tcfg), jts.make_schedule(JaxConfig(tcfg)))
    jstate = jts.create_train_state(params, tx, use_ema=True)
    jstep = jax.jit(jts.make_train_step(_jax_loss(jmodel), tx, ema_decay=0.999, **clip))
    state = ts.create_train_state(model, Config(tcfg), use_ema=True)
    step = ts.make_train_step(_port_loss(model), ema_decay=0.999, **clip)

    for batch in _batches(rng, x_shape, n_steps):
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        m = step(state, tuple(torch.from_numpy(a) for a in batch))
        for key in ("loss", "grad_norm", "grad_norm_net"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        assert m["skipped"] == int(jm["skipped"]) == 0
        _assert_params(model.net.state_dict(), jstate.params, convert, atol=1e-5)
    names = [n.removeprefix("net.") for n, p in model.named_parameters() if p.requires_grad]
    _assert_params(dict(zip(names, state.ema)), jstate.ema_params, convert, atol=1e-5)
    assert state.step == int(jstate.step) == n_steps
    assert state.ema_updates == int(jstate.ema_updates)


class _ScaledPair:
    """JAX and port train steps (AdamW + cosine, EMA on) on the same converted
    tiny ViT, with the loss multiplied by a factor ``s`` handed in as the
    last batch entry (inf for a nonfinite gradient, a large one for a
    spike)."""

    def __init__(self, tcfg, **clip):
        rng = np.random.default_rng(54)
        jmodel, params, self.model, self.convert = _models("vit", rng)
        self.tcfg = tcfg
        jloss, loss = _jax_loss(jmodel), _port_loss(self.model)
        tx = jts.make_optimizer(JaxConfig(tcfg), jts.make_schedule(JaxConfig(tcfg)))
        self.jstate = jts.create_train_state(params, tx, use_ema=True)
        self.jstep = jax.jit(jts.make_train_step(
            lambda p, x, c, t, x_0, s, r: jloss(p, x, c, t, x_0, r) * s, tx, ema_decay=0.999,
            **clip))
        self.state = ts.create_train_state(self.model, Config(tcfg), use_ema=True)
        self.step = ts.make_train_step(lambda x, c, t, x_0, s: loss(x, c, t, x_0) * s,
                                       ema_decay=0.999, **clip)
        self.batches = iter(_batches(rng, (1, L, A, R), 3))

    def both(self, s) -> int:
        """One step of each on the next batch with the loss scaled by ``s``;
        the metrics agree; returns ``skipped``."""
        batch = next(self.batches) + (np.float32(s),)
        self.jstate, jm = self.jstep(self.jstate, batch, jax.random.PRNGKey(0))
        m = self.step(self.state, tuple(torch.as_tensor(a) for a in batch))
        for key in ("loss", "grad_norm", "grad_norm_net"):  # inf / nan where both are
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        assert m["skipped"] == int(jm["skipped"])
        return m["skipped"]

    def set_step(self, step):
        self.state.step = step
        self.jstate = self.jstate.replace(step=jnp.asarray(step, jnp.int32))

    def assert_states_match(self):
        """Params, EMA, Adam moments and counts, the schedule's count and lr,
        ``step`` and ``ema_updates`` of the port's state against optax's."""
        state, jstate, convert = self.state, self.jstate, self.convert
        _assert_params(self.model.net.state_dict(), jstate.params, convert, atol=1e-5)
        named = {n.removeprefix("net."): p for n, p in self.model.named_parameters()
                 if p.requires_grad}
        _assert_params(dict(zip(named, state.ema)), jstate.ema_params, convert, atol=1e-5)
        adam, _, sched = jstate.opt_state  # optax.adamw: (scale_by_adam, decay, schedule)
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            # the moments are linear (exp_avg) and quadratic (exp_avg_sq) in
            # gradients that agree to f32 summation order: 1e-4 of the largest
            want = convert(tree)
            got = {n: state.optimizer.state[p][key] for n, p in named.items()}
            assert set(want) == set(got)
            scale = max(float(v.abs().max()) for v in want.values())
            for n, v in want.items():
                np.testing.assert_allclose(got[n].numpy(), v.numpy(), rtol=0,
                                           atol=1e-4 * scale, err_msg=f"{key} {n}")
        assert {int(state.optimizer.state[p]["step"]) for p in named.values()} == \
            {int(adam.count)}
        assert state.schedule.last_epoch == int(sched.count)
        lr = float(jts.make_schedule(JaxConfig(self.tcfg))(sched.count)) * float(jstate.lr_scale)
        assert state.lr() == pytest.approx(lr, rel=1e-5)
        assert state.step == int(jstate.step) and state.ema_updates == int(jstate.ema_updates)


def _snapshot(state):
    return ([p.detach().clone() for p in state.params], [e.clone() for e in state.ema or ()],
            {i: {k: v.clone() for k, v in st.items()}
             for i, st in state.optimizer.state_dict()["state"].items()},
            state.schedule.last_epoch, state.ema_updates)


def test_nonfinite_grads_skip_bitwise_and_hold_the_schedule():
    """A loss scaled by inf: both skip. The port's params, moments, EMA and
    schedule are bit-identical across the skip while ``step`` advances, and
    both states agree after each step (applied, skipped, applied)."""
    pair = _ScaledPair(_training())
    assert pair.both(1.0) == 0
    pair.assert_states_match()
    before = _snapshot(pair.state)
    assert pair.both(np.inf) == 1
    after = _snapshot(pair.state)
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)
    for i, st in before[2].items():
        assert all(torch.equal(v, after[2][i][k]) for k, v in st.items())
    assert before[3:] == after[3:] and pair.state.step == 2
    pair.assert_states_match()
    assert pair.both(1.0) == 0
    pair.assert_states_match()


def test_spike_skip_only_after_min_step():
    """``max_grad_norm`` below a spiked step's norm: applied at step 0, skipped
    once ``step`` is past MIN_STEP_SKIP, and a calm step after it applied;
    the port's state equals optax's after each."""
    pair = _ScaledPair(_training(), clip_grad_norm=0.5, max_grad_norm=1.0)
    spike, calm = 1e4, 1e-4  # the tiny ViT's grad norm at s = 1 is O(0.1-1)
    assert pair.both(spike) == 0  # step 0 <= MIN_STEP_SKIP: applied
    pair.assert_states_match()
    pair.set_step(ts.MIN_STEP_SKIP + 1)
    assert pair.both(spike) == 1
    pair.assert_states_match()
    assert pair.both(calm) == 0
    pair.assert_states_match()


def test_ema_warmup_uses_the_post_increment_count():
    """The first EMA update uses decay 2/11 = min(0.999, (1 + 1) / (10 + 1)),
    on the port as in optax."""
    pair = _ScaledPair(_training())
    ema0 = [e.clone() for e in pair.state.ema]
    pair.both(1.0)
    decay = 2.0 / 11.0
    # the same f32 expression: rounding only, far below the ~1e-4 that a
    # decay of 1/10 or 3/12 would move an entry after one lr 1e-3 step
    for e, e0, p in zip(pair.state.ema, ema0, pair.state.params):
        torch.testing.assert_close(e, e0 * decay + p.detach() * (1 - decay), atol=1e-7, rtol=1e-6)
    assert pair.state.ema_updates == 1
    pair.assert_states_match()


def _tiny_state(use_ema=False, **kw):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 1))
    return ts.create_train_state(model, Config(_training(**kw)), use_ema)


def test_clip_by_value_then_by_global_norm():
    state = _tiny_state(lr=1.0, optimizer="Adam", scheduler=None, weight_decay=0.0,
                        betas=[0.0, 0.0], eps=0.0)
    x = torch.randn(5, 3)
    loss = lambda: (state.model(x) ** 2).mean() * 50  # noqa: E731
    grads = torch.autograd.grad(loss(), state.params)
    clipped = [g.clamp(-0.5, 0.5) for g in grads]
    norm = torch.sqrt(sum((g ** 2).sum() for g in clipped))
    m = ts.make_train_step(loss, clip_grad_value=0.5, clip_grad_norm=0.1)(state, ())
    torch.testing.assert_close(m["grad_norm_net"], torch.sqrt(sum((g ** 2).sum() for g in grads)))
    torch.testing.assert_close(m["grad_norm"], norm)
    # beta1 = beta2 = 0, eps = 0: Adam's update is the sign of the clipped
    # grad, so the norm clip (a positive scale) leaves it; check the moments
    scale = min(1.0, 0.1 / (float(norm) + 1e-6))
    for p, g in zip(state.params, clipped):
        torch.testing.assert_close(state.optimizer.state[p]["exp_avg"], g * scale)


def test_schedules_match_jax():
    steps = [0, 1, 2, 5, 19, 20, 21, 50, 99, 100, 101, 150, 1000]
    for sched in (None, "CosineAnnealingLR", "OneCycleLR", "ReduceLROnPlateau"):
        cfg = _training(iterations=100, scheduler=sched, cosanneal_eta_min=1e-5,
                        scheduler_scale=1.0)
        port, ref = ts.make_schedule(Config(cfg)), jts.make_schedule(JaxConfig(cfg))
        # optax evaluates the schedule in float32, the port in float64; near a
        # cosine segment's end cos(pi * pct) + 1 cancels in float32, so the
        # absolute bound is 1e-6 of the base lr (1e-3)
        np.testing.assert_allclose([port(s) for s in steps], [float(ref(s)) for s in steps],
                                   rtol=1e-5, atol=1e-9, err_msg=str(sched))
    # the LambdaLR of the train state follows the schedule's count of applied updates
    state = _tiny_state(iterations=8)
    x = torch.randn(5, 3)
    step = ts.make_train_step(lambda: (state.model(x) ** 2).mean())
    fn = ts.make_schedule(Config(_training(iterations=8)))
    for k in range(10):
        assert state.lr() == pytest.approx(fn(k), rel=1e-6, abs=1e-12)
        step(state, ())
    with pytest.raises(ValueError, match="not implemented"):
        ts.make_optimizer(Config(_training(optimizer="Nope")), state.params)


def test_checkpoint_grads_gives_the_same_gradients():
    rng = np.random.default_rng(51)
    x = torch.from_numpy(rng.normal(size=(2, 6, 12)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(size=(2, 1)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(2, L + 1)).astype(np.float32))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        net = ViT(_vit_param(checkpoint_grads=remat))
        torch.nn.init.normal_(net.final_layer.linear.weight)
        for blk in net.blocks:
            torch.nn.init.normal_(blk.adaLN_modulation[1].weight, std=0.1)
        (net(x, t, c) ** 2).sum().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("fused", [dict(fused_block=True), dict(fused_block="hybrid"),
                                   dict(fused_block=True, fused_stack=False)],
                         ids=["true", "hybrid", "no-stack"])
def test_fused_block_trains_with_the_composed_grads(fused):
    """``fused_block: true`` (K5a + K5b), ``"hybrid"`` (K5a + the plain
    residual backward) and ``fused_stack: false`` (K2b + K5c) give the
    composed net's gradients for every parameter (f32 plain versions on the
    CPU: summation order only), and under no_grad its output."""
    rng = np.random.default_rng(53)
    args = [torch.from_numpy(a.astype(np.float32)) for a in
            (rng.normal(size=(2, 6, 12)), rng.uniform(size=(2, 1)), rng.normal(size=(2, L + 1)))]
    torch.manual_seed(0)
    composed = ViT(_vit_param(fused_block=False))
    with torch.no_grad():  # non-zero adaLN and final-layer weights
        for p in composed.parameters():
            p.add_(0.05 * torch.randn_like(p))
    net = ViT(_vit_param(**fused))
    net.load_state_dict(composed.state_dict())
    for m in (composed, net):
        (m(*args) ** 2).sum().backward()
    for (name, a), b in zip(net.named_parameters(), composed.parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-4, msg=name)
    with torch.no_grad():
        torch.testing.assert_close(net(*args), composed(*args), atol=1e-5, rtol=1e-4)


def test_energy_fused_block_trains_with_the_composed_grads():
    """``fused_block: true`` trains the energy net through the decoder
    kernel's forward and the plain decoder's VJP: the composed net's
    gradients (f32 both, summation order only) and, under no_grad, its
    output (atol 1e-5)."""
    rng = np.random.default_rng(52)
    param = dict(_energy_param(), fused_block=True)
    fused = ParallelTransformer(param)
    composed = ParallelTransformer(dict(param, fused_block=False))
    with torch.no_grad():
        for p in composed.parameters():
            p.add_(0.05 * torch.randn_like(p))
    fused.load_state_dict(composed.state_dict())
    args = [torch.from_numpy(a.astype(np.float32)) for a in
            (rng.normal(size=(3, L)), rng.uniform(size=(3, 1)), rng.uniform(size=(3, 1)))]
    for m in (fused, composed):
        (m(*args) ** 2).sum().backward()
    for (name, a), b in zip(fused.named_parameters(), composed.parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-4, msg=name)
    with torch.no_grad():
        torch.testing.assert_close(fused(*args), composed(*args), atol=1e-5, rtol=1e-4)
