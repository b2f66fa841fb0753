"""Training state and the train step (port of
``vit4hep_tpu/experiments/train_state.py``).

One step is: loss and gradients, the gradient-hygiene chain (global norm of
the raw gradients, clip by value, global norm, clip by global norm), the
update-skip guard, the optimizer update scaled by ``lr_scale``, and the EMA
update. The semantics are the JAX package's:

- ``grad_norm_net`` is taken before any clip; then clip by value, then
  ``grad_norm``, then clip by global norm with the scale
  ``min(1, max / (norm + 1e-6))`` (torch's ``clip_grad_norm_``);
- a nonfinite ``grad_norm`` always skips the update; a spike above
  ``max_grad_norm`` skips it only once ``step > MIN_STEP_SKIP``;
- a skipped step leaves the parameters, the optimizer state, the EMA and the
  learning-rate schedule untouched (in optax the schedule counter lives in
  the optimizer state), while ``step`` still advances;
- updates are multiplied by ``lr_scale`` (the host-driven
  ReduceLROnPlateau factor): the optimizer steps with ``lr * lr_scale``;
- the EMA decay is ``min(decay, (1 + n) / (10 + n))`` with the
  post-increment update count ``n``, applied to the new parameters.

Parameters that get no gradient are given zero gradients, so that weight
decay and the moments treat them as optax does. Optimizers: ``AdamW`` (the
ds2 default), ``Adam`` with torch's coupled L2 weight decay (optax chains
``add_decayed_weights`` before it), and ``RAdam``, :class:`RAdam` below:
``optax.radam`` behind the same coupled L2, written out because torch's
RAdam rectifies otherwise (eps added before the bias correction, and
another rectification term) and drifts from optax once the rectified phase
starts (step 6 at beta2 0.999); :class:`Lion` (``optax.lion``: the sign
of the interpolated momentum, weight decay decoupled and scaled by the lr);
and :class:`Ranger`, JAX's RAdam(0.95, 0.999, eps 1e-5, coupled L2) inside
its Lookahead (k = 6, alpha 0.5). Schedules are the optax formulas
(``cosine_decay_schedule``, which holds its end value;
``cosine_onecycle_schedule``), driven by a ``LambdaLR`` whose counter
advances with each applied update. The optimizer may hold several
parameter groups, each with its own initial lr and its own schedule from
it (one lambda a group), as ``optax.multi_transform`` over per-group
schedules does for fine-tuning's backbone, head and embedder groups
(``models/finetuning.ft_param_groups``); gradient clipping stays global
over every parameter.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vit4hep_tpu_torch.parallel import _comm

# the spike-skip is only active after this many steps
MIN_STEP_SKIP = 1000


class TrainState:
    """The model, its optimizer and schedule, the EMA shadow and the
    counters ``step`` (steps taken, skipped ones included), ``ema_updates``
    and ``lr_scale``."""

    def __init__(self, model, optimizer, schedule, use_ema: bool):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.ema = [p.detach().clone() for p in self.params] if use_ema else None
        self.step = 0
        self.ema_updates = 0
        self.lr_scale = 1.0

    def lr(self) -> float:
        """The learning rate of the next applied update (the first group's)."""
        return self.lrs()[0]

    def lrs(self) -> list[float]:
        """Each parameter group's learning rate for the next applied update."""
        return [lr * self.lr_scale for lr in self.schedule.get_last_lr()]

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "schedule": self.schedule.state_dict(),
                "ema": None if self.ema is None else [e.clone() for e in self.ema],
                "step": self.step, "ema_updates": self.ema_updates, "lr_scale": self.lr_scale}

    def load_state_dict(self, sd: dict):
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.schedule.load_state_dict(sd["schedule"])
        if self.ema is not None:
            if sd.get("ema") is None:
                self.ema = [p.detach().clone() for p in self.params]
            else:
                for e, s in zip(self.ema, sd["ema"], strict=True):
                    e.copy_(s)
        self.step = int(sd["step"])
        self.ema_updates = int(sd["ema_updates"])
        self.lr_scale = float(sd["lr_scale"])


def create_train_state(model, training_cfg, use_ema: bool, param_groups=None) -> TrainState:
    """The train state of ``model``: one parameter group of every trainable
    parameter at ``training.lr``, or ``param_groups``, a list of ``(params,
    lr)``, each group scheduled from its own lr."""
    if param_groups is None:
        param_groups = [([p for p in model.parameters() if p.requires_grad],
                         float(training_cfg.lr))]
    optimizer = make_optimizer(training_cfg, [{"params": list(params), "lr": float(lr)}
                                              for params, lr in param_groups])
    return TrainState(model, optimizer, make_lr_schedule(optimizer, training_cfg), use_ema)


def make_lr_schedule(optimizer, training_cfg):
    """A ``LambdaLR`` that gives each group ``make_schedule(training_cfg,
    lr=<the group's initial lr>)`` of the count of applied updates."""
    lambdas = []
    for group in optimizer.param_groups:
        lr = float(group["lr"])
        fn = make_schedule(training_cfg, lr=lr)
        lambdas.append(lambda count, fn=fn, lr=lr: fn(count) / lr if lr else 0.0)
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambdas)


def global_norm(tensors, split=(), group=None) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors (optax.global_norm). The
    tensors flagged in ``split`` are this rank's parts of tensors split over
    ``group``: their squares are summed over it, the others' counted once."""
    squares = [torch.sum(t.float() ** 2) for t in tensors]
    if not any(split):
        return torch.sqrt(sum(squares))
    whole = sum(q for q, s in zip(squares, split) if not s)
    parts = sum(q for q, s in zip(squares, split) if s)
    return torch.sqrt(whole + _comm.all_reduce_(parts.clone(), group))


def _data_mean(grads, loss, group, n):
    """The gradients and the loss averaged over the data group, in one
    all-reduce of one flat buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    _comm.all_reduce_(flat, group).div_(n)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out, flat[-1]


def _ema_decay(base_decay: float, num_updates: int) -> float:
    """torch_ema's warm-up: the first update uses n = 1 (decay 2/11)."""
    return min(base_decay, (1.0 + num_updates) / (10.0 + num_updates))


def make_train_step(loss_fn, *, clip_grad_value=None, clip_grad_norm=None, max_grad_norm=None,
                    ema_decay=None, mesh=None):
    """``train_step(state, batch) -> metrics``, with ``loss_fn(*batch)`` the
    scalar loss of the state's model. Metrics are tensors on the model's
    device: ``loss``, ``grad_norm``, ``grad_norm_net`` and ``skipped``.

    On a ``mesh`` (``parallel/mesh.Mesh``) ``loss_fn`` is the mean over this
    rank's rows of the global batch: the gradients and the loss are
    averaged over the data group (one all-reduce of one flat buffer) before
    anything reads them, and the norms count each tensor-parallel part
    once, so every rank clips, skips and logs on the global batch's
    numbers, as JAX's SPMD step does."""
    data_group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group

    def train_step(state: TrainState, batch) -> dict:
        if state.ema is not None and ema_decay is None:
            raise ValueError("the train state keeps an EMA: make_train_step needs ema_decay")
        params = state.params
        loss = loss_fn(*batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        if data_group is not None:
            grads, loss = _data_mean(grads, loss, data_group, mesh.data)
        split = [getattr(p, "tp_shard", None) is not None for p in params]

        grad_norm_net = global_norm(grads, split, model_group)
        if clip_grad_value is not None:
            grads = [g.clamp(-clip_grad_value, clip_grad_value) for g in grads]
        grad_norm = global_norm(grads, split, model_group)
        if clip_grad_norm is not None:
            scale = torch.clamp(clip_grad_norm / (grad_norm + 1e-6), max=1.0)
            grads = [g * scale for g in grads]

        norm = float(grad_norm)  # the skip decision is taken on the host
        ok = math.isfinite(norm) and (
            max_grad_norm is None or state.step <= MIN_STEP_SKIP or norm <= max_grad_norm)
        if ok:
            for group, lr in zip(state.optimizer.param_groups, state.lrs()):
                group["lr"] = lr
            for p, g in zip(params, grads):
                p.grad = g
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.schedule.step()
            if state.ema is not None:
                state.ema_updates += 1
                decay = _ema_decay(ema_decay, state.ema_updates)
                with torch.no_grad():
                    for e, p in zip(state.ema, params):
                        e.mul_(decay).add_(p.detach(), alpha=1.0 - decay)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, "grad_norm_net": grad_norm_net,
                "skipped": int(not ok)}

    return train_step


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------
def _cosine_decay(init_value, decay_steps, alpha):
    def fn(count):
        count = min(float(count), float(decay_steps))
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps))
                             + alpha)

    return fn


def _cosine_onecycle(transition_steps, peak_value, pct_start, div_factor=25.0,
                     final_div_factor=1e4):
    """optax.cosine_onecycle_schedule: a piecewise cosine interpolation
    between peak/div, peak and peak/(div * final_div)."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    init = peak_value / div_factor
    values = [init, init * div_factor, init * div_factor / (div_factor * final_div_factor)]

    def fn(count):
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return values[-1] if count >= bounds[-1] else 0.0

    return fn


def make_schedule(training_cfg, lr=None):
    """The learning rate of the update with a given count of earlier applied
    updates, as a function of that count (the optax schedule of the JAX
    package)."""
    lr = float(training_cfg.lr if lr is None else lr)
    name = training_cfg.get("scheduler")
    if name is None:
        return lambda count: lr
    steps = max(1, int(int(training_cfg.iterations)
                       * float(training_cfg.get("scheduler_scale", 1))))
    if name == "CosineAnnealingLR":
        eta_min = float(training_cfg.get("cosanneal_eta_min", 0.0))
        return _cosine_decay(lr, steps, eta_min / lr if lr else 0.0)
    if name == "OneCycleLR":
        return _cosine_onecycle(steps, lr * float(training_cfg.get("onecycle_max_lr", 10)),
                                float(training_cfg.get("onecycle_pct_start", 0.2)))
    if name == "ReduceLROnPlateau":  # host-driven through TrainState.lr_scale
        if training_cfg.get("optimizer") == "Ranger":
            # lr_scale would scale Lookahead's sync step, whose parameters
            # must land on the slow weights (JAX refuses the pair alike)
            raise ValueError("ReduceLROnPlateau + Ranger is not supported: the host-driven "
                             "lr_scale would break Lookahead's sync step")
        return lambda count: lr
    raise ValueError(f"Learning rate scheduler {name} not implemented")


class RAdam(torch.optim.Optimizer):
    """``optax.chain(optax.add_decayed_weights(wd), optax.radam(lr, b1, b2,
    eps))``: with g += wd * p, m and v the moments and t the step,
    rho_t = rho_inf - 2 t b2^t / (1 - b2^t), rho_inf = 2 / (1 - b2) - 1; the
    update is lr * r_t * m_hat / (sqrt(v_hat) + eps) with r_t =
    sqrt((rho_t - 4)(rho_t - 2) rho_inf / ((rho_inf - 4)(rho_inf - 2) rho_t))
    where rho_t >= 5, and lr * m_hat below it. The scalars are computed in
    float32 as optax computes them (b^t correctly rounded, then each
    operation rounded): 1 - b2^t cancels, so rho_t, and with it r_t, carry
    optax's rounding, which a float64 evaluation would not reproduce. Each
    tensor operation is rounded on its own, as in optax. Its state per
    parameter is torch's (``step``, ``exp_avg``, ``exp_avg_sq``), so
    checkpoints and warm starts restore it as they do Adam's."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 threshold=5.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        f32 = np.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            wd, eps, lr = group["weight_decay"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + wd * p if wd else p.grad
                st = self.state[p]
                if "step" not in st:  # (Ranger keeps its Lookahead state beside)
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = int(st["step"])
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.copy_((1.0 - b1) * g + b1 * m)
                v.copy_((1.0 - b2) * (g * g) + b2 * v)
                b2t = f32(float(f32(b2)) ** t)
                rho = f32(rho_inf) - f32(2 * t) * b2t / (f32(1.0) - b2t)
                upd = m / float(f32(1.0) - f32(float(f32(b1)) ** t))
                if rho >= group["threshold"]:
                    r = np.sqrt((rho - f32(4.0)) * (rho - f32(2.0)) * f32(rho_inf)
                                / (f32((rho_inf - 4.0) * (rho_inf - 2.0)) * rho))
                    upd = float(r) * upd / (torch.sqrt(v / float(f32(1.0) - b2t)) + eps)
                p.add_(upd * -lr)
        return loss


class Lion(torch.optim.Optimizer):
    """``optax.lion(lr, b1, b2, weight_decay=wd)``: with m the momentum, the
    update is -lr * (sign((1 - b1) g + b1 m) + wd * p), then m = (1 - b2) g +
    b2 m. Its state per parameter is ``step`` and ``exp_avg`` (m)."""

    def __init__(self, params, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, lr = group["weight_decay"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                st["step"] += 1
                m = st["exp_avg"]
                upd = torch.sign((1.0 - b1) * g + b1 * m)
                m.copy_((1.0 - b2) * g + b2 * m)
                if wd:
                    upd = upd + wd * p
                p.add_(upd * -lr)
        return loss


class Ranger(RAdam):
    """JAX's Ranger: :class:`RAdam` (b1 0.95, b2 0.999, eps 1e-5, coupled L2
    weight decay) inside a Lookahead of sync period 6 and slow step 0.5.
    Each parameter keeps its slow copy (``slow``, its value before the
    first update) and a count (``lookahead_step``); every sixth update
    moves the slow copy half way to the fast parameter, and the parameter
    lands on it (p + (slow - p), as optax applies the update)."""

    SYNC_PERIOD, SLOW_STEP = 6, 0.5

    def __init__(self, params, lr=1e-3, weight_decay=0.0):
        super().__init__(params, lr=lr, betas=(0.95, 0.999), eps=1e-5, weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, closure=None):
        syncing = []
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "slow" not in st:
                    st["slow"] = p.detach().clone()
                    st["lookahead_step"] = torch.zeros((), dtype=torch.float32)
                st["lookahead_step"] += 1
                if int(st["lookahead_step"]) % self.SYNC_PERIOD == 0:
                    syncing.append((p, p.detach().clone()))
        loss = super().step(closure)
        for p, before in syncing:
            slow = self.state[p]["slow"]
            slow.copy_(slow + self.SLOW_STEP * (p - slow))  # p is the fast parameter now
            p.copy_(before + (slow - before))
        return loss


def make_optimizer(training_cfg, params) -> torch.optim.Optimizer:
    """The optimizer ``training.optimizer`` names over ``params``: tensors,
    or torch parameter-group dicts, each with its own ``lr``."""
    name = training_cfg.get("optimizer", "AdamW")
    lr = float(training_cfg.lr)
    betas = tuple(float(b) for b in training_cfg.get("betas", (0.9, 0.999)))
    eps = float(training_cfg.get("eps", 1e-8))
    wd = float(training_cfg.get("weight_decay", 0.0))
    if name == "AdamW":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    if name == "Adam":  # coupled L2: grad += wd * param before the moments
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    if name == "RAdam":
        return RAdam(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    if name == "Lion":
        return Lion(params, lr=lr, betas=betas, weight_decay=wd)
    if name == "Ranger":
        return Ranger(params, lr=lr, weight_decay=wd)
    raise ValueError(f"Optimizer {name} not implemented")
