"""Distribution distances on high-level features: FPD and KPD (port of
``vit4hep_tpu/evaluation/metrics.py``, numpy and scipy on the host).

The estimators of Kansal et al., "Evaluating generative models in high
energy physics" (arXiv:2211.10295), with jetnet's normalisation and
batching constants:

- every feature of both sets is divided by the largest absolute value of
  that feature in the reference set (jetnet ``normalise_features``);
- **FPD**: the Frechet distance between Gaussian fits, at ``num_points``
  subsample sizes spaced uniformly in 1/N between ``min_samples`` and
  ``max_samples``, each the mean over ``num_batches`` draws with
  replacement; the value is the 1/N -> 0 intercept of a degree-1 fit and
  the error that intercept's fit standard error;
- **KPD**: the unbiased MMD^2 with the kernel (x.y / d + 1)^3 over
  ``num_batches`` draws of ``batch_size``, reported as the median with half
  the 16.275-83.725 percentile range as its error.

Draws come from ``np.random.RandomState(seed)``, as in the JAX package, so
equal inputs draw equal subsamples. The moments and kernel sums of each
draw are float64 products in torch on ``device`` (by default the card, as
in the other evaluation entry points: at the shipped sizes they are ~10^12
operations a metric; ``device="cpu"`` for the host); the matrix square
root is scipy's on the host. The estimates agree with the JAX package's
numpy ones to float64 rounding.
"""

from __future__ import annotations

import numpy as np
import torch


def normalise_features(reference, sample):
    """jetnet ``normalise_features``: scale every feature of BOTH sets by the
    max absolute value of that feature in the reference set."""
    maxes = np.max(np.abs(reference), axis=0)
    maxes = np.where(maxes == 0, 1.0, maxes)
    return reference / maxes, sample / maxes


def _gaussian_fit(x):
    """Mean and covariance (ddof 1) of the rows of a float64 tensor."""
    mu = x.mean(0)
    xc = x - mu
    return mu.cpu().numpy(), np.atleast_2d((xc.T @ xc / (len(x) - 1)).cpu().numpy())


def frechet_distance(x, y):
    """Frechet distance between Gaussian fits of two feature matrices (numpy
    arrays or float64 tensors; jetnet ``frechet_gaussian_distance`` without
    the normalise step)."""
    import scipy.linalg

    (mu_x, cov_x), (mu_y, cov_y) = (_gaussian_fit(torch.as_tensor(a, dtype=torch.float64))
                                    for a in (x, y))
    diff = mu_x - mu_y
    covmean = np.real(scipy.linalg.sqrtm(cov_x @ cov_y))
    return float(diff @ diff + np.trace(cov_x) + np.trace(cov_y) - 2 * np.trace(covmean))


def _prepare(reference, sample, normalise, device):
    reference = np.asarray(reference, np.float64)
    sample = np.asarray(sample, np.float64)
    if normalise:
        reference, sample = normalise_features(reference, sample)
    return (len(reference), len(sample),
            torch.as_tensor(reference, device=device), torch.as_tensor(sample, device=device))


def _take(x, idx):
    return x[torch.as_tensor(idx, device=x.device)]


def fpd(reference, sample, min_samples=20000, max_samples=50000, num_batches=20, num_points=10,
        normalise=True, seed=42, device="cuda"):
    """FPD with 1/N extrapolation; returns (value, intercept fit error).

    Subsample sizes are uniform in 1/N between min_samples and max_samples
    (jetnet's grid); draws are WITH replacement, so sizes may exceed the
    available statistics as in jetnet."""
    n_ref, n_src, reference, sample = _prepare(reference, sample, normalise, device)
    rng = np.random.RandomState(seed)
    sizes = (1.0 / np.linspace(1.0 / min_samples, 1.0 / max_samples, num_points)
             ).astype(np.int64)
    vals = []
    for n in sizes:
        draws = []
        for _ in range(num_batches):
            idx_r = rng.choice(n_ref, n)
            idx_s = rng.choice(n_src, n)
            draws.append(frechet_distance(_take(reference, idx_r), _take(sample, idx_s)))
        vals.append(float(np.mean(draws)))
    # the intercept of a degree-1 fit of FD against 1/N is the
    # infinite-sample estimate, its fit covariance the quoted error (jetnet)
    coef, cov = np.polyfit(1.0 / sizes, np.asarray(vals), 1, cov=True)
    return float(coef[1]), float(np.sqrt(cov[1, 1]))


def _kernel_sum(x, y, block=2048):
    """Sum of the polynomial kernel (x.y / d + 1)^3 over all pairs, in row
    blocks so that the whole (n, m) kernel matrix is never held at once."""
    d = x.shape[1]
    total = 0.0
    for i in range(0, len(x), block):
        k = x[i:i + block] @ y.T / d + 1.0
        total += float((k * k * k).sum())
    return total


def _mmd_unbiased(x, y):
    """KID-style unbiased MMD^2: off-diagonal means of kxx/kyy, full mean kxy."""
    n, m = len(x), len(y)
    d = x.shape[1]
    trace_xx = float((((x * x).sum(1) / d + 1.0) ** 3).sum())
    trace_yy = float((((y * y).sum(1) / d + 1.0) ** 3).sum())
    sum_xx = (_kernel_sum(x, x) - trace_xx) / (n * (n - 1))
    sum_yy = (_kernel_sum(y, y) - trace_yy) / (m * (m - 1))
    return float(sum_xx + sum_yy - 2.0 * _kernel_sum(x, y) / (n * m))


def kpd(reference, sample, num_batches=10, batch_size=5000, normalise=True, seed=42,
        device="cuda"):
    """KPD; returns (median MMD^2 over batches, IQR-based 1-sigma error)."""
    from scipy.stats import iqr

    n_ref, n_src, reference, sample = _prepare(reference, sample, normalise, device)
    rng = np.random.RandomState(seed)
    vals = [_mmd_unbiased(_take(reference, rng.choice(n_ref, batch_size)),
                          _take(sample, rng.choice(n_src, batch_size)))
            for _ in range(num_batches)]
    # jetnet's 1-sigma-equivalent IQR convention (16.275/83.725 percentiles)
    return float(np.median(vals)), float(iqr(vals, rng=(16.275, 83.725)) / 2)
