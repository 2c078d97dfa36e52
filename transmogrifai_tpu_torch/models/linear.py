"""Linear-model trainers (counterpart of ``transmogrifai_tpu.models.linear``),
the binary logistic-regression subset the model selector runs:

 * ``fit_logistic_regression`` — one fit: Newton-IRLS with a damped
   Cholesky solve for pure-L2 candidates, proximal-gradient FISTA (the
   exact elastic-net optimum) when the L1 part is positive;
 * ``fit_logreg_grid`` — every (fold, candidate) fit of a sweep at once:
   one weighted Gram per fold gives a fixed majorizer shared by every
   candidate, and each iteration is two batched (N, D) products over the
   whole grid (Nesterov momentum, ``H_inv`` per (fold, candidate));
 * ``logreg_predict_proba``.

Everything computes in float32 on the inputs' device; loops are Python
loops that read the stopping test back to the host once per iteration.
The per-fold Gram ``X' diag(w) X`` and the grid products are plain large
matrix products (``torch.matmul``), as the JAX package left them to XLA.
Not ported yet (ROADMAP Queue A): the multinomial, linear-regression, SVC
and naive Bayes trainers and the sharded solvers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["LinearFit", "fit_logistic_regression", "logreg_predict_proba",
           "fit_logreg_grid"]


class LinearFit(NamedTuple):
    """coef (D,), intercept 0-d, iterations run, whether it converged."""
    coef: torch.Tensor
    intercept: torch.Tensor
    n_iter: int
    converged: bool


def _damped_solve(H: torch.Tensor, g: torch.Tensor,
                  rel: float = 1e-5) -> torch.Tensor:
    """Cholesky solve with damping relative to the Hessian's largest
    diagonal entry (pivoted one-hot blocks make H singular at reg 0);
    NaN where the factorisation fails, so the caller keeps its iterate."""
    eps = rel * H.diagonal().abs().max() + 1e-12
    L, info = torch.linalg.cholesky_ex(
        H + eps * torch.eye(H.shape[0], dtype=H.dtype, device=H.device))
    if int(info):
        return torch.full_like(g, float("nan"))
    return torch.cholesky_solve(g[:, None], L)[:, 0]


def _finite_or(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Reject a non-finite update (keeps the last good iterate)."""
    return new if bool(torch.isfinite(new).all()) else old


def _soft(x: torch.Tensor, thr) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - thr, min=0.0)


def fit_logistic_regression(X: torch.Tensor, y: torch.Tensor,
                            sample_weight: Optional[torch.Tensor] = None,
                            reg_param: float = 0.0,
                            elastic_net_param: float = 0.0,
                            max_iter: int = 50, tol: float = 1e-6,
                            fit_intercept: bool = True) -> LinearFit:
    """Binary logistic regression on (N, D) ``X`` (Spark's
    parameterisation: l2 = reg (1 - alpha), l1 = reg alpha, the loss a
    weighted mean).  Pure-L2: Newton-IRLS with a ridge-damped Hessian.
    L1 > 0: FISTA with the scalar majorizer from a 16-step power
    iteration, at most ``8 max_iter`` steps."""
    X = X.to(torch.float32)
    n, d = X.shape
    dev = X.device
    y = y.to(dev, torch.float32)
    w = (torch.ones(n, dtype=torch.float32, device=dev)
         if sample_weight is None
         else sample_weight.to(dev, torch.float32))
    wsum = torch.clamp(w.sum(), min=1.0)
    l2 = reg_param * (1.0 - elastic_net_param)
    l1 = reg_param * elastic_net_param
    Xa = (torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=dev)], 1)
          if fit_intercept else X)
    da = Xa.shape[1]

    def smooth_grad(beta):
        p = torch.sigmoid(Xa @ beta)
        g = Xa.T @ (w * (p - y) / wsum)
        g[:d] += l2 * beta[:d]
        return g, p

    beta = torch.zeros(da, dtype=torch.float32, device=dev)
    dn, it = float("inf"), 0
    if l1 > 0:
        v = torch.ones(da, dtype=X.dtype, device=dev) / da ** 0.5
        for _ in range(16):
            v = Xa.T @ (w * (Xa @ v)) / (4.0 * wsum)
            v = v / (torch.linalg.norm(v) + 1e-12)
        L = (torch.dot(v, Xa.T @ (w * (Xa @ v)) / (4.0 * wsum)) * 1.01
             + l2 + 1e-6)
        thr = l1 / L
        coef_dims = torch.arange(da, device=dev) < d
        zb, t_m = beta, 1.0
        while dn > tol and it < 8 * max_iter:
            grad, _ = smooth_grad(zb)
            nb = zb - grad / L
            nb = _finite_or(torch.where(coef_dims, _soft(nb, thr), nb), beta)
            nt = 0.5 * (1.0 + (1.0 + 4.0 * t_m * t_m) ** 0.5)
            zb = nb + (t_m - 1.0) / nt * (nb - beta)
            dn = float(torch.max(torch.abs(nb - beta)))
            beta, t_m, it = nb, nt, it + 1
    else:
        diag = torch.arange(d, device=dev)
        while dn > tol and it < max_iter:
            grad, p = smooth_grad(beta)
            s = torch.clamp(w * p * (1 - p) / wsum, min=1e-10)
            H = (Xa * s[:, None]).T @ Xa
            H[diag, diag] += l2
            new = _finite_or(beta - _damped_solve(H, grad), beta)
            dn = float(torch.max(torch.abs(new - beta)))
            beta, it = new, it + 1
    icpt = beta[d] if fit_intercept else torch.zeros((), device=dev)
    return LinearFit(beta[:d], icpt, it, dn <= tol)


def logreg_predict_proba(coef: torch.Tensor, intercept, X: torch.Tensor):
    """(probabilities (N, 2), raw margins (N, 2)) of a binary model."""
    z = X.to(torch.float32) @ coef.to(X.device, torch.float32) + intercept
    p1 = 1.0 / (1.0 + torch.exp(-z))
    return torch.stack([1.0 - p1, p1], 1), torch.stack([-z, z], 1)


# ---------------------------------------------------------------------------
# Grid-batched binary logistic regression
# ---------------------------------------------------------------------------

def _grid_fold_stats(X, W_tr, wsum, fit_intercept: bool,
                     standardization: bool):
    """Per-fold weighted centering and scale vectors (F, D); the
    standardized matrix is never built, the scale folds in algebraically."""
    mu = (W_tr @ X) / wsum[:, None]
    if standardization:
        ex2 = (W_tr @ (X * X)) / wsum[:, None]
        sig = torch.sqrt(torch.clamp(ex2 - mu ** 2, min=0.0))
        sig = torch.where(sig < 1e-12, 1.0, sig)
    else:
        sig = torch.ones_like(mu)
    cen = mu if fit_intercept else torch.zeros_like(mu)
    return cen, sig


def _grid_fold_grams(X, W_tr, wsum, cen, sig):
    """Standardized per-fold weighted covariance Grams (F, D, D) — the one
    O(N D^2) cost of a grid solve, one fold at a time."""
    Q = torch.stack([(X * w_f[:, None]).T @ X for w_f in W_tr])
    Q = Q / wsum[:, None, None]
    Qs = Q - cen[:, :, None] * cen[:, None, :]
    return Qs / (sig[:, :, None] * sig[:, None, :])


def _grid_lmax(Qs):
    """Per-fold top Gram eigenvalue (16 power-iteration steps, x1.01): the
    scalar majorizer's Lipschitz bound for the L1 candidates."""
    F, d, _ = Qs.shape
    v = torch.ones((F, d), dtype=Qs.dtype, device=Qs.device) / d ** 0.5
    for _ in range(16):
        v = (Qs @ v[..., None])[..., 0]
        v = v / (torch.linalg.norm(v, dim=1, keepdim=True) + 1e-12)
    return (v * (Qs @ v[..., None])[..., 0]).sum(1) * 1.01


def fit_logreg_grid(X: torch.Tensor, y: torch.Tensor, W_tr: torch.Tensor,
                    regs: torch.Tensor, alphas: torch.Tensor,
                    max_iter: int = 50, tol: float = 1e-5,
                    fit_intercept: bool = True, standardization: bool = True
                    ) -> Tuple[torch.Tensor, int, torch.Tensor,
                               torch.Tensor]:
    """Every (fold, candidate) binary-LR fit in one solve.

    ``X`` (N, D), ``y`` (N,), ``W_tr`` (F, N) per-fold training weights,
    ``regs``/``alphas`` (C,) per candidate.  Returns ``(scores, iters,
    coef, intercept)``: (F, C, N) sigmoid scores over all rows, the
    iterations run, and raw-feature-space (F, C, D) / (F, C) solutions.

    Proximal majorization with Nesterov momentum: the logistic Hessian is
    bounded by X' diag(w) X / 4, so each fold's standardized Gram, with
    the candidate's ridge, is a fixed majorizing metric, inverted once per
    (fold, candidate); pure-L2 candidates step through that inverse, L1
    candidates take the exact scalar-majorizer proximal step.  Stops when
    the largest coefficient move is at most ``tol`` or after
    ``max_iter`` steps."""
    dev = X.device
    X = X.to(torch.float32)
    y = y.to(dev, torch.float32)
    W_tr = W_tr.to(dev, torch.float32)
    regs = regs.to(dev, torch.float32)
    alphas = alphas.to(dev, torch.float32)
    n, d = X.shape
    F, C = W_tr.shape[0], regs.shape[0]
    wsum = torch.clamp(W_tr.sum(1), min=1.0)
    l2 = regs[None, :] * (1.0 - alphas[None, :])            # (1, C)
    l1 = regs[None, :] * alphas[None, :]

    cen, sig = _grid_fold_stats(X, W_tr, wsum, fit_intercept,
                                standardization)
    Qs = _grid_fold_grams(X, W_tr, wsum, cen, sig)
    eye = torch.eye(d, dtype=X.dtype, device=dev)
    H = Qs[:, None] / 4.0 + (l2[:, :, None, None] + 2.5e-6) * eye
    H_inv = torch.linalg.inv(H)                              # (F, C, D, D)

    def z_of(b, b0):
        """(F, C, N) logits of the standardized-space solution against
        the raw matrix: X (b/sig) - cen . (b/sig) + b0."""
        u = b / sig[:, None, :]
        z = (u.reshape(F * C, d) @ X.T).reshape(F, C, n)
        return z - (cen[:, None, :] * u).sum(2)[..., None] + b0[..., None]

    def grad(b, b0):
        p = torch.sigmoid(z_of(b, b0))
        r = W_tr[:, None, :] * (p - y[None, None, :]) / wsum[:, None, None]
        g_raw = (r.reshape(F * C, n) @ X).reshape(F, C, d)
        rsum = r.sum(2)
        g = (g_raw - cen[:, None, :] * rsum[..., None]) / sig[:, None, :]
        return g + l2[..., None] * b, rsum

    Lf = _grid_lmax(Qs)
    L_fc = Lf[:, None] / 4.0 + l2 + 1e-6                     # (F, C)
    thr = (l1 / L_fc)[..., None]
    has_l1 = (l1 > 0)[..., None]

    b = torch.zeros((F, C, d), dtype=X.dtype, device=dev)
    b0 = torch.zeros((F, C), dtype=X.dtype, device=dev)
    pb, pb0 = b, b0
    tm, dn, it = 1.0, float("inf"), 0
    while dn > tol and it < max_iter:
        # Nesterov: the gradient at the extrapolated point
        gb, g0 = grad(b, b0)
        nb_mm = b - (H_inv @ gb[..., None])[..., 0]
        nb_prox = _soft(b - gb / L_fc[..., None], thr)
        nb = torch.where(has_l1, nb_prox, nb_mm)
        n0 = b0 - 4.0 * g0 if fit_intercept else b0
        ntm = 0.5 * (1.0 + (1.0 + 4.0 * tm * tm) ** 0.5)
        mom = (tm - 1.0) / ntm
        b, b0 = nb + mom * (nb - pb), n0 + mom * (n0 - pb0)
        dn = float(torch.maximum(torch.max(torch.abs(nb - pb)),
                                 torch.max(torch.abs(n0 - pb0))))
        pb, pb0, tm, it = nb, n0, ntm, it + 1
    u = pb / sig[:, None, :]
    icpt = pb0 - (cen[:, None, :] * u).sum(2)
    return torch.sigmoid(z_of(pb, pb0)), it, u, icpt
