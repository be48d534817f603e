"""HumanML3D metric formulas (counterpart of
``afford_motion_tpu/eval/metrics.py``; reference: utils/eval/metrics.py).

R-Precision / Matching score / FID / Diversity / MultiModality over frozen
text-motion co-embeddings, on the host in numpy and scipy (``sqrtm`` stays
on the CPU, as in the reference). Diversity and MultiModality draw from the
``np.random.RandomState`` they are given: ``RandomState(s).choice`` draws
what ``np.random.seed(s); np.random.choice`` draws, so a seed gives the JAX
package's values."""
from __future__ import annotations

import numpy as np
from scipy import linalg


def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray) -> np.ndarray:
    """(N1, D) x (N2, D) -> (N1, N2) pairwise distances."""
    d1 = -2 * np.dot(matrix1, matrix2.T)
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(sorted_idx_mat: np.ndarray, top_k: int) -> np.ndarray:
    """Whether the ground-truth index appears among the first k sorted
    columns (cumulative), (N, >=k) -> (N, k) bool."""
    size = sorted_idx_mat.shape[0]
    gt = np.arange(size)[:, None]
    bool_mat = sorted_idx_mat == gt
    out = np.zeros((size, top_k), dtype=bool)
    correct = np.zeros(size, dtype=bool)
    for i in range(top_k):
        correct = correct | bool_mat[:, i]
        out[:, i] = correct
    return out


def calculate_R_precision(emb1: np.ndarray, emb2: np.ndarray, top_k: int, sum_all: bool = False):
    dist = euclidean_distance_matrix(emb1, emb2)
    argsorted = np.argsort(dist, axis=1)
    top_k_mat = calculate_top_k(argsorted, top_k)
    return top_k_mat.sum(axis=0) if sum_all else top_k_mat


def calculate_matching_score(emb1: np.ndarray, emb2: np.ndarray, sum_all: bool = False):
    dist = linalg.norm(emb1 - emb2, axis=1)
    return dist.sum(axis=0) if sum_all else dist


def calculate_activation_statistics(activations: np.ndarray):
    return np.mean(activations, axis=0), np.cov(activations, rowvar=False)


def calculate_diversity(activation: np.ndarray, diversity_times: int,
                        rng: np.random.RandomState) -> float:
    if activation.ndim != 2 or activation.shape[0] <= diversity_times:
        raise ValueError(f"diversity of {diversity_times} pairs over activations "
                         f"{activation.shape}")
    n = activation.shape[0]
    first = rng.choice(n, diversity_times, replace=False)
    second = rng.choice(n, diversity_times, replace=False)
    return float(linalg.norm(activation[first] - activation[second], axis=1).mean())


def calculate_multimodality(activation: np.ndarray, multimodality_times: int,
                            rng: np.random.RandomState) -> float:
    if activation.ndim != 3 or activation.shape[1] <= multimodality_times:
        raise ValueError(f"multimodality of {multimodality_times} pairs over activations "
                         f"{activation.shape}")
    n_per = activation.shape[1]
    first = rng.choice(n_per, multimodality_times, replace=False)
    second = rng.choice(n_per, multimodality_times, replace=False)
    return float(linalg.norm(activation[:, first] - activation[:, second], axis=2).mean())


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two activation Gaussians (Dougal Sutherland's stable
    formulation, as used by the reference)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"FID of statistics {mu1.shape}/{sigma1.shape} against "
                         f"{mu2.shape}/{sigma2.shape}")

    diff = mu1 - mu2
    # the array alone: ``disp=False`` is deprecated from SciPy 1.16 and gives
    # the same values
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}"
            )
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )
