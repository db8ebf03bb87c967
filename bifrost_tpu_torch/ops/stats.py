"""Robust statistics for candidate detection and the RFI flagger
(counterpart of bifrost_tpu/ops/stats.py), on tensors with numpy's
semantics.  The flagger's window-axis median/MAD is `median_mad(x,
dim=0, keepdim=False)`; `spectral_kurtosis` and `sk_band` are the SK
flagger's estimator and acceptance band.

`torch.median` returns the LOWER middle value of an even count, where
`np.median` averages the two middle values; every gulp of the FRB chain
has an even frame count.  So the median here is a sort and, for an even
count, ``(lo + hi) / 2`` in the input dtype — the IEEE sequence of
numpy's mean of the two partitioned middle values.  (`torch.quantile`
refuses inputs above 2**24 elements, and one gulp is 8.4 M.)  The
normalisation ``(x - mu) / (MAD_SIGMA * mad + MAD_EPS)`` stays in the
input dtype (f32), as numpy computes it, so the SNR is bitwise numpy's.
"""

from __future__ import annotations

import math

import torch

__all__ = ["MAD_SIGMA", "MAD_EPS", "median", "median_mad", "mad_snr",
           "spectral_kurtosis", "sk_band"]

MAD_SIGMA = 1.4826   # Gaussian consistency factor: sigma ~= 1.4826 * MAD
MAD_EPS = 1e-6       # guard against a zero MAD (constant rows)


def median(x, dim=-1, keepdim=True):
    """np.median along `dim`: the mean of the two middle values for an
    even count."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    hi = s.narrow(dim, n // 2, 1)
    if n % 2 == 0:
        hi = (s.narrow(dim, n // 2 - 1, 1) + hi) / 2
    return hi if keepdim else hi.squeeze(dim)


def median_mad(x, dim=-1, keepdim=True):
    """Median and median absolute deviation along `dim`."""
    mu = median(x, dim=dim, keepdim=True)
    mad = median((x - mu).abs(), dim=dim, keepdim=True)
    if not keepdim:
        mu, mad = mu.squeeze(dim), mad.squeeze(dim)
    return mu, mad


def mad_snr(x, dim=-1):
    """Robust SNR: (x - median) / (MAD_SIGMA * MAD + MAD_EPS)."""
    mu, mad = median_mad(x, dim=dim, keepdim=True)
    return (x - mu) / (MAD_SIGMA * mad + MAD_EPS)


def spectral_kurtosis(x, dim=0):
    """Generalized spectral kurtosis of a power stream over its M samples
    along `dim`, in x's dtype: SK = ((M+1)/(M-1)) * (M * S2 / (S1**2 +
    MAD_EPS) - 1) with S1 = sum(p), S2 = sum(p**2).  Gaussian voltages
    (exponential power) give SK ~= 1 with std sqrt(4 / M)."""
    m = x.shape[dim]
    if m < 2:
        raise ValueError(f"spectral_kurtosis needs >= 2 samples, got {m}")
    mf = float(m)
    s1 = x.sum(dim=dim)
    s2 = (x * x).sum(dim=dim)
    return ((mf + 1.0) / (mf - 1.0)) * (mf * s2 / (s1 * s1 + MAD_EPS) - 1.0)


def sk_band(m, thresh=3.0):
    """The SK acceptance band (lo, hi) for M samples at `thresh` sigma:
    1 -+ thresh * sqrt(4 / M)."""
    half = float(thresh) * math.sqrt(4.0 / m)
    return 1.0 - half, 1.0 + half
