"""FID / sFID / Inception Score / improved precision and recall
(counterpart of ``imagefolder_tpu/eval/fid.py``, a copy: numpy and scipy
only; reference ``evaluator.py``, the OpenAI guided-diffusion evaluator).

The metric math is the evaluator's (the Frechet distance with its
eps-regularised sqrtm fallback, evaluator.py:72-115; IS from the softmax,
:193-206; the kNN-hypersphere precision and recall of the
ManifoldEstimator, :219-445). The features come from the port's
InceptionV3 (``imagefolder_tpu_torch/eval/inception.py``), pool3 and
spatial, read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "FIDStatistics", "frechet_distance", "compute_statistics",
    "inception_score", "ManifoldEstimator", "precision_recall",
]


@dataclasses.dataclass
class FIDStatistics:
    mu: np.ndarray
    sigma: np.ndarray

    def frechet_distance(self, other: "FIDStatistics", eps: float = 1e-6):
        return frechet_distance(self.mu, self.sigma, other.mu, other.sigma, eps)


def compute_statistics(feats: np.ndarray) -> FIDStatistics:
    """(N, D) activations -> (mu, sigma) (evaluator.py:607-615)."""
    mu = np.mean(feats, axis=0)
    sigma = np.cov(feats, rowvar=False)
    return FIDStatistics(mu, sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """evaluator.py:79-115 (identical eps fallback + imaginary check)."""
    from scipy import linalg

    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    diff = mu1 - mu2

    # sqrtm(disp=...) is deprecated (SciPy >= 1.16); detect failure from the
    # result instead — non-finite entries mean the iteration did not converge
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    tr_covmean = np.trace(covmean)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * tr_covmean)


def inception_score(softmax_probs: np.ndarray, split_size: int = 5000) -> float:
    """evaluator.py:193-206: exp(mean KL(p(y|x) || p(y))) averaged over splits."""
    scores = []
    for i in range(0, len(softmax_probs), split_size):
        part = softmax_probs[i:i + split_size]
        kl = part * (np.log(part) - np.log(np.expand_dims(np.mean(part, 0), 0)))
        kl = np.mean(np.sum(kl, 1))
        scores.append(np.exp(kl))
    return float(np.mean(scores))


class ManifoldEstimator:
    """kNN-hypersphere manifold (evaluator.py:219-328), numpy/batched.

    For each feature row, its radius is the distance to its nu_k-th nearest
    neighbour (k=3 by default); a query point is "in the manifold" if it lies
    within any row's hypersphere."""

    def __init__(self, features: np.ndarray, nhood_sizes=(3,),
                 row_batch_size: int = 10000, col_batch_size: int = 10000,
                 clamp_to_percentile: Optional[float] = None):
        self.features = features.astype(np.float32)
        self.nhood_sizes = list(nhood_sizes)
        self.row_batch = row_batch_size
        self.col_batch = col_batch_size
        n = len(features)
        self.D = np.zeros((n, len(self.nhood_sizes)), np.float32)
        for begin in range(0, n, row_batch_size):
            end = min(begin + row_batch_size, n)
            rows = self.features[begin:end]
            dists = np.zeros((end - begin, n), np.float32)
            for cb in range(0, n, col_batch_size):
                ce = min(cb + col_batch_size, n)
                dists[:, cb:ce] = _sq_dists(rows, self.features[cb:ce])
            # k-th smallest excluding self (self-distance is 0 => kth index k)
            for j, k in enumerate(self.nhood_sizes):
                self.D[begin:end, j] = np.partition(dists, k, axis=1)[:, k]
        if clamp_to_percentile is not None:
            max_d = np.percentile(self.D, clamp_to_percentile, axis=0)
            self.D[self.D > max_d] = 0

    def evaluate(self, query: np.ndarray) -> np.ndarray:
        """(M, D) -> (M, num_nhoods) binary membership."""
        q = query.astype(np.float32)
        out = np.zeros((len(q), len(self.nhood_sizes)), np.int32)
        for begin in range(0, len(q), self.row_batch):
            end = min(begin + self.row_batch, len(q))
            rows = q[begin:end]
            pred = np.zeros((end - begin, len(self.nhood_sizes)), bool)
            for cb in range(0, len(self.features), self.col_batch):
                ce = min(cb + self.col_batch, len(self.features))
                d = _sq_dists(rows, self.features[cb:ce])
                for j in range(len(self.nhood_sizes)):
                    pred[:, j] |= np.any(
                        d <= self.D[cb:ce, j][None, :], axis=1)
            out[begin:end] = pred
        return out


def _sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (np.sum(a ** 2, 1, keepdims=True) + np.sum(b ** 2, 1)
            - 2 * a @ b.T).clip(min=0)


def precision_recall(ref_features: np.ndarray, sample_features: np.ndarray,
                     nhood_size: int = 3) -> Tuple[float, float]:
    """Improved precision/recall (evaluator.py:205-216): precision = fraction
    of samples inside the reference manifold; recall = fraction of reference
    points inside the sample manifold."""
    ref_m = ManifoldEstimator(ref_features, (nhood_size,))
    smp_m = ManifoldEstimator(sample_features, (nhood_size,))
    precision = ref_m.evaluate(sample_features)[:, 0].mean()
    recall = smp_m.evaluate(ref_features)[:, 0].mean()
    return float(precision), float(recall)
