"""F^R / F^L — learned resource & latency predictors (paper §6.1).

"Ensembles of practical regression models, not naturally differentiable over
the parameter spaces, noisy and probably biased" — we use bagged ridge
regression over quadratic features (pure numpy): non-differentiable w.r.t.
the *system* parameters in any useful sense (hence CMA-ES), cheap to fit
from logs, and an ensemble whose spread models the noise the paper warns
about.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def quad_features(X: np.ndarray) -> np.ndarray:
    """[1, x, x², upper-triangle cross terms]"""
    n, d = X.shape
    cols = [np.ones((n, 1)), X, X ** 2]
    for i in range(d):
        for j in range(i + 1, d):
            cols.append((X[:, i] * X[:, j])[:, None])
    return np.concatenate(cols, axis=1)


@dataclass
class RidgeEnsemble:
    n_members: int = 8
    l2: float = 1e-3
    seed: int = 0

    def fit(self, X: np.ndarray, y: np.ndarray):
        rng = np.random.default_rng(self.seed)
        self.x_mean = X.mean(0)
        self.x_std = X.std(0) + 1e-9
        Phi = quad_features((X - self.x_mean) / self.x_std)
        self.coefs = []
        n = len(y)
        for _ in range(self.n_members):
            idx = rng.integers(0, n, n)                  # bootstrap bag
            P, t = Phi[idx], y[idx]
            A = P.T @ P + self.l2 * np.eye(P.shape[1])
            self.coefs.append(np.linalg.solve(A, P.T @ t))
        return self

    def predict(self, X: np.ndarray, with_std: bool = False):
        Phi = quad_features((np.atleast_2d(X) - self.x_mean) / self.x_std)
        preds = np.stack([Phi @ c for c in self.coefs])
        mean = preds.mean(0)
        if with_std:
            return mean, preds.std(0)
        return mean

    def __call__(self, x: np.ndarray) -> float:
        return float(self.predict(np.atleast_2d(x))[0])
