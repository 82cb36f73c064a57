"""Circular Smooth Labels on the host (copy of ``ryolo_tpu/geometry.py:152``
``csl_gaussian_labels_np``; the JAX module imports jax)."""

from __future__ import annotations

import numpy as np


def csl_gaussian_labels_np(theta_deg_plus90: np.ndarray, num_bins: int = 180,
                           sig: float = 6.0) -> np.ndarray:
    """Gaussian window of std ``sig`` rolled onto the truncated integer bin
    of ``theta * 180/pi + 90`` (``datasets/base_dataset.py:13-31`` of the
    reference).  Returns ``(..., num_bins)`` float32."""
    theta_deg_plus90 = np.asarray(theta_deg_plus90, dtype=np.float64)
    x = np.arange(-num_bins / 2, num_bins / 2, dtype=np.float64)
    y_sig = np.exp(-(x ** 2) / (2 * sig ** 2))
    index = np.trunc(num_bins / 2 - theta_deg_plus90).astype(np.int64)
    j = np.arange(num_bins)
    src = np.mod(j + index[..., None], num_bins)
    return y_sig[src].astype(np.float32)
