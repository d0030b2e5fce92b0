"""CMA-ES with constraints (paper §6.1; cites Arnold & Hansen 2012).

Two pure-numpy optimizers:
  * ``cmaes_minimize``      — (μ/μw, λ)-CMA-ES (Hansen's standard strategy)
    with box bounds + black-box inequality constraints handled by adaptive
    penalty; restores the full SOLUTION PATH so the caller can re-validate
    constraint-satisfied minima on live traffic (paper: 5% of requests).
  * ``one_plus_one_cmaes``  — the (1+1)-CMA-ES with active constraint
    covariance downdates of Arnold & Hansen [GECCO'12], the exact variant
    the paper cites; used for the low-dimensional stage-level searches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np


@dataclass
class PathPoint:
    x: np.ndarray
    f: float
    feasible: bool
    violation: float


@dataclass
class Result:
    x: np.ndarray
    f: float
    feasible: bool
    path: list[PathPoint] = field(default_factory=list)
    evaluations: int = 0

    def best_feasible_candidates(self, k: int = 5) -> list[PathPoint]:
        feas = [p for p in self.path if p.feasible]
        return sorted(feas, key=lambda p: p.f)[:k]


def _clip(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


def cmaes_minimize(f: Callable[[np.ndarray], float],
                   x0: np.ndarray, sigma0: float,
                   bounds: Sequence[tuple[float, float]],
                   constraints: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                   budget: int = 2000, seed: int = 0,
                   penalty0: float = 10.0) -> Result:
    """constraints(x) → vector g(x); feasible iff all g ≤ 0."""
    rng = np.random.default_rng(seed)
    n = len(x0)
    lo = np.array([b[0] for b in bounds], float)
    hi = np.array([b[1] for b in bounds], float)
    span = hi - lo
    # normalized coordinates
    m = (np.asarray(x0, float) - lo) / span
    sigma = sigma0
    lam = 4 + int(3 * np.log(n))
    mu = lam // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w /= w.sum()
    mu_eff = 1.0 / np.sum(w ** 2)
    cc = (4 + mu_eff / n) / (n + 4 + 2 * mu_eff / n)
    cs = (mu_eff + 2) / (n + mu_eff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mu_eff)
    cmu = min(1 - c1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((n + 2) ** 2 + mu_eff))
    damps = 1 + 2 * max(0, np.sqrt((mu_eff - 1) / (n + 1)) - 1) + cs
    chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))

    pc = np.zeros(n)
    ps = np.zeros(n)
    C = np.eye(n)
    path: list[PathPoint] = []
    evals = 0
    penalty = penalty0
    best = Result(x=np.asarray(x0, float), f=np.inf, feasible=False, path=path)

    def eval_x(z_norm):
        nonlocal evals
        x = lo + _clip(z_norm, 0, 1) * span
        fx = float(f(x))
        g = np.asarray(constraints(x), float) if constraints else np.zeros(1)
        viol = float(np.maximum(g, 0).sum())
        feas = viol <= 1e-12
        evals += 1
        path.append(PathPoint(x.copy(), fx, feas, viol))
        return x, fx, viol, feas

    while evals < budget:
        try:
            A = np.linalg.cholesky(C + 1e-12 * np.eye(n))
        except np.linalg.LinAlgError:
            C = np.eye(n)
            A = np.eye(n)
        zs = rng.standard_normal((lam, n))
        ys = zs @ A.T
        xs_norm = m + sigma * ys
        scored = []
        for z_norm, y in zip(xs_norm, ys):
            x, fx, viol, feas = eval_x(z_norm)
            pen_f = fx + penalty * viol
            scored.append((pen_f, fx, viol, feas, y, x))
            if feas and fx < best.f:
                best.x, best.f, best.feasible = x.copy(), fx, True
            elif not best.feasible and not feas and fx + penalty * viol < best.f:
                best.x, best.f = x.copy(), fx + penalty * viol
        scored.sort(key=lambda s: s[0])
        sel = scored[:mu]
        y_w = np.sum([wi * s[4] for wi, s in zip(w, sel)], axis=0)
        m = _clip(m + sigma * y_w, 0, 1)
        # step-size + covariance adaptation
        A_inv = np.linalg.inv(A + 1e-12 * np.eye(n))
        ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mu_eff) * (A_inv @ y_w)
        sigma *= np.exp((cs / damps) * (np.linalg.norm(ps) / chi_n - 1))
        sigma = float(np.clip(sigma, 1e-8, 0.5))
        hs = np.linalg.norm(ps) / np.sqrt(
            1 - (1 - cs) ** (2 * evals / lam)) < (1.4 + 2 / (n + 1)) * chi_n
        pc = (1 - cc) * pc + hs * np.sqrt(cc * (2 - cc) * mu_eff) * y_w
        rank_mu = sum(wi * np.outer(s[4], s[4]) for wi, s in zip(w, sel))
        C = (1 - c1 - cmu) * C + c1 * np.outer(pc, pc) + cmu * rank_mu
        # adapt penalty: raise while infeasible solutions dominate
        frac_infeas = np.mean([0.0 if s[3] else 1.0 for s in scored])
        penalty *= 1.5 if frac_infeas > 0.6 else (0.9 if frac_infeas < 0.2 else 1.0)
        penalty = float(np.clip(penalty, 1e-3, 1e9))

    best.evaluations = evals
    return best


def one_plus_one_cmaes(f, x0, sigma0, bounds,
                       constraints=None, budget: int = 1000, seed: int = 0,
                       d: float = None, c_cov_plus: float = None,
                       c_constraint: float = 0.1, beta: float = 0.1) -> Result:
    """(1+1)-CMA-ES with active constraint handling [Arnold & Hansen 2012]:
    maintains Cholesky factor A; infeasible offspring update per-constraint
    exponentially-fading direction vectors v_j and DOWNDATE A along them."""
    rng = np.random.default_rng(seed)
    n = len(x0)
    lo = np.array([b[0] for b in bounds], float)
    hi = np.array([b[1] for b in bounds], float)
    span = hi - lo
    d = d or (1 + n / 2)
    c_cov_plus = c_cov_plus or (2 / (n * n + 6))
    p_target = 2 / 11
    x = (np.asarray(x0, float) - lo) / span
    sigma = sigma0
    A = np.eye(n)
    v: dict[int, np.ndarray] = {}
    p_succ = p_target
    path: list[PathPoint] = []
    evals = 0

    def full_eval(xn):
        nonlocal evals
        xx = lo + _clip(xn, 0, 1) * span
        g = np.asarray(constraints(xx), float) if constraints else np.zeros(1)
        feas = bool(np.all(g <= 0))
        fx = float(f(xx)) if feas else np.inf
        evals += 1
        path.append(PathPoint(xx.copy(), fx, feas, float(np.maximum(g, 0).sum())))
        return xx, fx, g, feas

    _, f_par, _, feas_par = full_eval(x)
    best = Result(x=lo + x * span, f=f_par if feas_par else np.inf,
                  feasible=feas_par, path=path)

    while evals < budget:
        z = rng.standard_normal(n)
        y = A @ z
        x_off = x + sigma * y
        xx, f_off, g, feas = full_eval(x_off)
        if not feas:
            # constraint-direction downdates (Arnold-Hansen eq. 5-7)
            for j in np.nonzero(g > 0)[0]:
                vj = v.get(j, np.zeros(n))
                vj = (1 - c_constraint) * vj + c_constraint * (A @ z)
                v[j] = vj
                wj = np.linalg.solve(A, vj)
                denom = np.dot(wj, wj)
                if denom > 1e-30:
                    A = A - (beta / len(v)) * np.outer(vj, wj) / denom
            sigma *= np.exp(-1.0 / d * p_succ / (1 - p_target))
            sigma = float(np.clip(sigma, 1e-9, 0.5))
            continue
        success = f_off <= f_par
        p_succ = (1 - 0.2) * p_succ + 0.2 * (1.0 if success else 0.0)
        sigma *= np.exp((1.0 / d) * (p_succ - p_target) / (1 - p_target))
        sigma = float(np.clip(sigma, 1e-9, 0.5))
        if success:
            x, f_par = x_off, f_off
            # rank-one update of A toward successful step
            a = np.sqrt(1 - c_cov_plus)
            norm2 = np.dot(z, z)
            if norm2 > 1e-30:
                b = a / norm2 * (np.sqrt(1 + c_cov_plus / (1 - c_cov_plus) * norm2) - 1)
                A = a * A + b * np.outer(A @ z, z)
            if f_off < best.f:
                best.x, best.f, best.feasible = lo + _clip(x, 0, 1) * span, f_off, True
    best.evaluations = evals
    return best
