"""Real-vs-generated classifier tests (port of
``vit4hep_tpu/evaluation/classifiers.py``): a LeakyReLU MLP ("DNN") on low-
or high-level features and a 3-D ResNet on voxel grids, trained with BCE,
model-selected by test accuracy, isotonic-calibrated, and scored by AUC and
JSD.

The networks compute what the flax modules compute, so that converted
variables (``utils/jax_params.convert_classifier_params``) give the same
logits and two epochs of training the same parameters:

- flax ``BatchNorm`` (momentum 0.99, the running variance updated from the
  *biased* batch variance E[x^2] - E[x]^2) is :class:`BatchNorm` here, not
  ``torch.nn.BatchNorm3d`` (momentum 0.1, unbiased variance);
- ``optax.adamw`` decays weights by 1e-4 unless told otherwise, so
  ``torch.optim.AdamW`` gets ``weight_decay=1e-4`` (its default is 1e-2);
- a projection shortcut exists where flax's ``residual.shape != y.shape``
  holds, which depends on the spatial sizes: :class:`ResNet3D` works them
  out from ``img_shape`` when it is built.

The AUC, the isotonic regression and the calibration curve are numpy/scipy
versions of sklearn's (held against sklearn in the tests), so the
evaluation runs where sklearn is not installed.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vit4hep_tpu_torch.utils.logger import LOGGER

# the JAX package's limit for holding the train and test sets on the device
# at once; larger sets stream from the host batch by batch
DEVICE_RESIDENT_BYTES = 8 * 1024**3


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------
def _dense(n_in, n_out, generator=None):
    """A Linear with flax ``Dense``'s initialisation (LeCun normal, zero bias)."""
    layer = nn.Linear(n_in, n_out)
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def _conv(n_in, n_out, kernel, stride=1, padding=0, generator=None):
    """A bias-free Conv3d with flax's ``he_normal`` initialisation."""
    conv = nn.Conv3d(n_in, n_out, kernel, stride=stride, padding=padding, bias=False)
    std = math.sqrt(2.0 / (n_in * kernel**3)) / 0.87962566103423978
    nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    return conv


def _conv_out(size, kernel, stride, padding):
    return tuple((s + 2 * padding - kernel) // stride + 1 for s in size)


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over channel axis 1: batch statistics E[x] and
    max(E[x^2] - E[x]^2, 0) in training, running averages with momentum
    0.99 of both, epsilon 1e-5."""

    def __init__(self, features, momentum=0.99, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [d for d in range(x.dim()) if d != 1]
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class DNN(nn.Module):
    """LeakyReLU MLP emitting one logit; ``num_inputs`` is the feature width
    (flax infers it at init). The initial weights are drawn from
    ``generator`` (torch's global one when None)."""

    def __init__(self, num_layer, num_hidden, dropout_probability=0.0, num_inputs=1,
                 generator=None):
        super().__init__()
        widths = [num_inputs] + [num_hidden] * (num_layer + 1)
        self.hidden = nn.ModuleList(_dense(a, b, generator)
                                    for a, b in zip(widths[:-1], widths[1:]))
        self.out = _dense(num_hidden, 1, generator)
        self.dropout = nn.Dropout(dropout_probability)

    def forward(self, x):
        for layer in self.hidden:
            x = self.dropout(F.leaky_relu(layer(x), 0.01))
        return self.out(x)


class BasicBlock3D(nn.Module):
    expansion = 1

    def __init__(self, in_planes, planes, stride, size, generator=None):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride, 1, generator)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1, generator)
        self.bn2 = BatchNorm(planes)
        self.out_size = _conv_out(size, 3, stride, 1)
        self.shortcut = None
        if in_planes != planes or self.out_size != tuple(size):
            self.shortcut = nn.Sequential(_conv(in_planes, planes, 1, stride, 0, generator),
                                          BatchNorm(planes))

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, in_planes, planes, stride, size, generator=None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = _conv(in_planes, planes, 1, 1, 0, generator)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1, generator)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, out, 1, 1, 0, generator)
        self.bn3 = BatchNorm(out)
        self.out_size = _conv_out(size, 3, stride, 1)
        self.shortcut = None
        if in_planes != out or self.out_size != tuple(size):
            self.shortcut = nn.Sequential(_conv(in_planes, out, 1, stride, 0, generator),
                                          BatchNorm(out))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn3(self.conv3(F.relu(self.bn2(self.conv2(y)))))
        return F.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class ResNet3D(nn.Module):
    """3-D ResNet real/fake voxel classifier. Input rows are [log10(Einc),
    voxels / Einc ...]; the voxels are reshaped to (N, 1, *img_shape), the
    energy feature batch-normed and concatenated before the last layer. The
    initial weights are drawn from ``generator`` (torch's global one when
    None)."""

    def __init__(self, stage_sizes, block, img_shape, inplanes=(32, 64, 64, 128), n_classes=1,
                 generator=None):
        super().__init__()
        self.img_shape = tuple(img_shape)
        self.e_norm = BatchNorm(1)
        self.stem = _conv(1, inplanes[0], 7, 2, 3, generator)
        self.bn = BatchNorm(inplanes[0])
        size = _conv_out(_conv_out(self.img_shape, 7, 2, 3), 3, 2, 1)  # stem, max pool
        blocks, in_planes = [], inplanes[0]
        for stage, (planes, n) in enumerate(zip(inplanes, stage_sizes)):
            for b in range(n):
                blk = block(in_planes, planes, 2 if (stage > 0 and b == 0) else 1, size,
                            generator)
                blocks.append(blk)
                in_planes, size = planes * block.expansion, blk.out_size
        self.blocks = nn.ModuleList(blocks)
        self.fc = _dense(in_planes + 1, n_classes, generator)

    def forward(self, x):
        e_inc = self.e_norm(x[:, :1])
        v = x[:, 1:].reshape(-1, 1, *self.img_shape)
        v = F.max_pool3d(F.relu(self.bn(self.stem(v))), 3, 2, 1)
        for blk in self.blocks:
            v = blk(v)
        return self.fc(torch.cat([v.mean(dim=(2, 3, 4)), e_inc], dim=1))


RESNET_DEPTHS = {
    10: (BasicBlock3D, [1, 1, 1, 1]),
    18: (BasicBlock3D, [2, 2, 2, 2]),
    34: (BasicBlock3D, [3, 4, 6, 3]),
    50: (Bottleneck3D, [3, 4, 6, 3]),
    101: (Bottleneck3D, [3, 4, 23, 3]),
    152: (Bottleneck3D, [3, 8, 36, 3]),
    200: (Bottleneck3D, [3, 24, 36, 3]),
}


def generate_model(model_depth: int, img_shape=(45, 50, 18), **kwargs) -> ResNet3D:
    """The ResNet3D of one of the reference depths."""
    block, stages = RESNET_DEPTHS[model_depth]
    return ResNet3D(stages, block, img_shape, **kwargs)


# ---------------------------------------------------------------------------
# data plumbing
# ---------------------------------------------------------------------------
def ttv_split(data1, data2, split=(0.6, 0.2, 0.2), rng=None):
    """Truncate to equal lengths, shuffle, split train/test/val, merge and
    shuffle each split; ``rng`` is a numpy Generator (unseeded when None)."""
    rng = rng or np.random.default_rng()
    n = min(len(data1), len(data2))
    data1, data2 = np.array(data1[:n]), np.array(data2[:n])
    rng.shuffle(data1)
    rng.shuffle(data2)
    cuts = np.cumsum((n * np.asarray(split)).astype(int))[:-1]
    out = []
    for a, b in zip(np.split(data1, cuts), np.split(data2, cuts)):
        merged = np.concatenate([a, b], axis=0)
        rng.shuffle(merged)
        out.append(merged)
    return tuple(out)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClassifierConfig:
    lr: float = 2e-4
    batch_size: int = 1000
    n_epochs: int = 50
    optimizer: str = "Adam"
    seed: int = 0


def _optimizer(model, cfg):
    if cfg.optimizer == "AdamW":
        return torch.optim.AdamW(model.parameters(), lr=cfg.lr, weight_decay=1e-4)
    return torch.optim.Adam(model.parameters(), lr=cfg.lr)


def _logits(model, data, batch_size, device):
    """Eval-mode logits of ``data``'s feature columns, ``batch_size`` rows a
    call; ``data`` is a host array or a tensor on ``device``."""
    model.eval()
    out = []
    with torch.no_grad():
        for start in range(0, len(data), batch_size):
            x = torch.as_tensor(data[start:start + batch_size, :-1], dtype=torch.float32,
                                device=device)
            out.append(model(x).squeeze(-1))
    return torch.cat(out).cpu().numpy()


def _step(model, opt, x, y):
    logits = model(x).squeeze(-1)
    loss = F.binary_cross_entropy_with_logits(logits, y)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach(), ((logits.detach() > 0) == (y > 0.5)).sum()


def train_classifier(model: nn.Module, train_data, test_data, cfg: ClassifierConfig,
                     device=None):
    """Train ``model`` (on ``device``, default: where its parameters are)
    with BCE; keep the state of the best test accuracy, stop early at test
    accuracy 1.0. Returns ``(best, apply_fn)``: ``best`` holds the accuracy
    and the state dict, ``apply_fn(data) -> logits`` runs the best state.

    The batches of an epoch come from ``np.random.default_rng(cfg.seed)``'s
    permutation, its ragged tail wrapped round to a full batch (a tiny set
    tiled); above ``DEVICE_RESIDENT_BYTES`` the sets stay on the host and the
    exact ragged batches stream to the device one by one."""
    device = torch.device(device) if device is not None else next(model.parameters()).device
    if device.type != "cpu":
        return _train_classifier(model, train_data, test_data, cfg, device)
    # oneDNN's f32 Conv3d weight gradient is wrong on the CPU when a strided
    # window leaves the last padded row unread (torch 2.13, e.g. the ResNet's
    # 7^3 stem at stride 2 over 6 rows); torch's own kernels are right
    with torch.backends.mkldnn.flags(enabled=False):
        return _train_classifier(model, train_data, test_data, cfg, device)


def _train_classifier(model, train_data, test_data, cfg, device):
    model.to(device)
    opt = _optimizer(model, cfg)
    n, bs = len(train_data), int(cfg.batch_size)
    streaming = np.asarray(train_data).nbytes + np.asarray(test_data).nbytes > \
        DEVICE_RESIDENT_BYTES
    steps = max(1, -(-n // bs))
    train = train_data if streaming else torch.as_tensor(train_data, dtype=torch.float32,
                                                         device=device)
    test = test_data if streaming else torch.as_tensor(test_data, dtype=torch.float32,
                                                       device=device)
    test_labels = np.asarray(test_data)[:, -1] > 0.5

    rng_np = np.random.default_rng(cfg.seed)
    best = {"acc": -np.inf, "state": copy.deepcopy(model.state_dict())}
    for epoch in range(cfg.n_epochs):
        model.train()
        perm = rng_np.permutation(n)
        if streaming:
            batches = [perm[s:s + bs] for s in range(0, n, bs)]
            seen = n
        else:
            if steps * bs > n:
                perm = np.tile(perm, -(-(steps * bs) // n))[:steps * bs]
            batches = list(perm.reshape(steps, bs))
            seen = steps * bs
        correct = torch.zeros((), dtype=torch.int64, device=device)
        for ids in batches:
            batch = torch.as_tensor(train_data[ids], dtype=torch.float32, device=device) \
                if streaming else train[torch.as_tensor(ids, device=device)]
            loss, c = _step(model, opt, batch[:, :-1], batch[:, -1])
            correct += c
        test_acc = float(np.mean((_logits(model, test, bs, device) > 0) == test_labels))
        LOGGER.info(f"classifier epoch {epoch + 1}/{cfg.n_epochs}: train acc "
                    f"{int(correct) / seen:.4f}, test acc {test_acc:.4f}, loss {float(loss):.4f}")
        if test_acc > best["acc"]:
            best = {"acc": test_acc, "state": copy.deepcopy(model.state_dict())}
        if test_acc == 1.0:
            break
    model.load_state_dict(best["state"])

    def apply_fn(data):
        return _logits(model, np.asarray(data), bs, device)

    return best, apply_fn


# ---------------------------------------------------------------------------
# scores: numpy/scipy versions of sklearn's
# ---------------------------------------------------------------------------
def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of binary labels: the Mann-Whitney statistic
    with tied scores given their average rank."""
    from scipy.stats import rankdata

    y_true = np.asarray(y_true).ravel() > 0.5
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("only one class present in y_true; the ROC AUC is not defined")
    ranks = rankdata(np.asarray(y_score, np.float64).ravel())
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _pava(y, w):
    """Pool adjacent violators: the non-decreasing least-squares fit of ``y``
    with weights ``w`` (float64)."""
    values, weights, counts = [], [], []
    for yi, wi in zip(y, w):
        values.append(yi)
        weights.append(wi)
        counts.append(1)
        while len(values) > 1 and values[-2] >= values[-1]:
            v, ww, c = values.pop(), weights.pop(), counts.pop()
            total = weights[-1] + ww
            values[-1] = (values[-1] * weights[-1] + v * ww) / total
            weights[-1] = total
            counts[-1] += c
    return np.repeat(np.asarray(values, np.float64), counts)


class IsotonicRegression:
    """sklearn's ``IsotonicRegression`` (increasing, unit weights) with
    ``y_min``/``y_max`` and ``out_of_bounds="clip"``: targets of equal inputs
    averaged (inputs closer than the dtype's resolution to a group's first
    count as equal), fitted by pool-adjacent-violators, clipped to [y_min,
    y_max]; ``predict`` clips its inputs to the fitted range and interpolates
    linearly, in the fitted inputs' dtype (float32 or float64)."""

    def __init__(self, y_min=None, y_max=None):
        self.y_min, self.y_max = y_min, y_max

    def fit(self, X, y):
        X = np.asarray(X).reshape(-1)
        dtype = X.dtype.type if X.dtype in (np.float32, np.float64) else np.float64
        X = X.astype(dtype, copy=False)
        y = np.asarray(y).reshape(-1).astype(dtype, copy=False)
        order = np.lexsort((y, X))
        X, y = X[order], y[order]
        eps = np.finfo(dtype).resolution
        # sklearn's _make_unique, accumulating in the dtype
        ux, uy, uw = [], [], []
        cur_x, cur_y, cur_w = X[0], dtype(0), dtype(0)
        for xi, yi in zip(X, y):
            if xi - cur_x >= eps:
                ux.append(cur_x)
                uy.append(cur_y / cur_w)
                uw.append(cur_w)
                cur_x, cur_y, cur_w = xi, yi, dtype(1)
            else:
                cur_w += dtype(1)
                cur_y += yi
        ux.append(cur_x)
        uy.append(cur_y / cur_w)
        uw.append(cur_w)
        fitted = _pava(np.asarray(uy, np.float64), np.asarray(uw, np.float64)).astype(dtype)
        lo = -np.inf if self.y_min is None else self.y_min
        hi = np.inf if self.y_max is None else self.y_max
        np.clip(fitted, lo, hi, fitted)
        self.X_thresholds_ = np.asarray(ux, dtype)
        self.y_thresholds_ = fitted
        self.X_min_, self.X_max_ = self.X_thresholds_.min(), self.X_thresholds_.max()
        return self

    def predict(self, T):
        dtype = self.X_thresholds_.dtype
        T = np.clip(np.asarray(T, dtype).reshape(-1), self.X_min_, self.X_max_)
        if len(self.y_thresholds_) == 1:
            return np.repeat(self.y_thresholds_, len(T)).astype(dtype)
        return np.interp(T.astype(np.float64), self.X_thresholds_.astype(np.float64),
                         self.y_thresholds_.astype(np.float64)).astype(dtype)


def calibration_curve(y_true, y_prob, n_bins=10):
    """sklearn's ``calibration_curve`` with the uniform strategy: (the
    fraction of positives, the mean predicted probability) in each non-empty
    one of ``n_bins`` equal bins of [0, 1]."""
    y_true = np.asarray(y_true).ravel()
    y_prob = np.asarray(y_prob).ravel()
    if y_prob.min() < 0 or y_prob.max() > 1:
        raise ValueError("y_prob has values outside [0, 1]")
    labels = np.unique(y_true)
    if len(labels) > 2:
        raise ValueError(f"only binary classification is supported; labels {labels}")
    y_true = y_true == labels[-1]
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    binids = np.searchsorted(bins[1:-1], y_prob)
    bin_sums = np.bincount(binids, weights=y_prob, minlength=len(bins))
    bin_true = np.bincount(binids, weights=y_true, minlength=len(bins))
    bin_total = np.bincount(binids, minlength=len(bins))
    nonzero = bin_total != 0
    return bin_true[nonzero] / bin_total[nonzero], bin_sums[nonzero] / bin_total[nonzero]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _jsd(y_true, probs, eps=1e-12):
    """1 - BCE / log(2): 0 for indistinguishable samples."""
    bce = -np.mean(y_true * np.log(probs + eps) + (1 - y_true) * np.log(1 - probs + eps))
    return (-bce + np.log(2.0)) / np.log(2.0)


def evaluate_classifier(apply_fn, val_data, calibration_data=None, final_eval=False):
    """Accuracy, AUC and JSD of the classifier on ``val_data``; with
    ``final_eval`` the scores are isotonic-calibrated on
    ``calibration_data`` first."""
    y_true = val_data[:, -1]
    probs = _sigmoid(apply_fn(val_data))
    acc = float(np.mean(y_true == np.round(probs)))
    auc = roc_auc_score(y_true, probs)
    jsd = _jsd(y_true, probs)
    LOGGER.info(f"classifier eval: acc {acc:.4f}, AUC {auc:.4f}, JSD {jsd:.4f}")
    if final_eval:
        if calibration_data is None:
            raise ValueError("final_eval calibrates on calibration_data, which is None")
        cal_probs = _sigmoid(apply_fn(calibration_data))
        iso = IsotonicRegression(y_min=1e-6, y_max=1 - 1e-6).fit(cal_probs,
                                                                 calibration_data[:, -1])
        rescaled = iso.predict(probs)
        acc = float(np.mean(y_true == np.round(rescaled)))
        auc = roc_auc_score(y_true, rescaled)
        jsd = _jsd(y_true, rescaled)
        prob_true, prob_pred = calibration_curve(y_true, rescaled, n_bins=10)
        LOGGER.info(f"rescaled calibration curve: {prob_true} {prob_pred}")
        LOGGER.info(f"classifier final (calibrated): acc {acc:.4f}, AUC {auc:.4f}, "
                    f"JSD {jsd:.4f}")
    return acc, auc, jsd


def run_dnn_classifier(labeled_a, labeled_b, ev, out_path, device="cuda"):
    """The DNN real-vs-fake test on two labelled feature arrays (last column
    the label): ttv split, train, calibrate, and append the AUC / JSD line
    to ``out_path``. Returns (acc, auc, jsd)."""
    train_data, test_data, val_data = ttv_split(labeled_a, labeled_b)
    cls_cfg = ClassifierConfig(lr=float(ev.eval_cls_lr), batch_size=int(ev.eval_cls_batch_size),
                               n_epochs=int(ev.eval_cls_n_epochs))
    model = DNN(int(ev.eval_cls_n_layer), int(ev.eval_cls_n_hidden),
                float(ev.eval_cls_dropout), num_inputs=train_data.shape[1] - 1,
                generator=torch.Generator().manual_seed(cls_cfg.seed))
    _, apply_fn = train_classifier(model, train_data, test_data, cls_cfg, device=device)
    acc, auc, jsd = evaluate_classifier(apply_fn, val_data, calibration_data=test_data,
                                        final_eval=True)
    LOGGER.info("Final result of classifier test (AUC / JSD):")
    LOGGER.info(f"{auc:.4f} / {jsd:.4f}")
    with open(out_path, "a", encoding="utf-8") as f:
        f.write(f"Final result of classifier test (AUC / JSD):\n{auc:.4f} / {jsd:.4f}\n\n")
    return acc, auc, jsd
