"""Linear-model trainers (counterpart of ``transmogrifai_tpu.models.linear``),
the binary logistic-regression and linear-regression subsets the model
selectors run:

 * ``fit_logistic_regression`` — one fit: Newton-IRLS with a damped
   Cholesky solve for pure-L2 candidates, proximal-gradient FISTA (the
   exact elastic-net optimum) when the L1 part is positive;
 * ``fit_logreg_grid`` — every (fold, candidate) fit of a sweep at once:
   one weighted Gram per fold gives a fixed majorizer shared by every
   candidate, and each iteration is two batched (N, D) products over the
   whole grid (Nesterov momentum, ``H_inv`` per (fold, candidate));
 * ``logreg_predict_proba``;
 * ``fit_linear_regression`` — ridge by the normal equations (a damped
   Cholesky solve of the centred weighted Gram), elastic net by FISTA on
   the same Gram; ``linear_predict``;
 * ``fit_linear_svc`` — the squared-hinge linear SVM with an L2 penalty
   by damped Newton steps; ``svc_decision``;
 * ``fit_naive_bayes`` — multinomial naive Bayes on the clipped
   non-negative matrix (one weighted one-hot product);
   ``naive_bayes_predict_log_proba``;
 * ``fit_linreg_grid`` — every (fold, candidate) linear-regression fit:
   one weighted Gram per fold, standardization folded into it, then a
   ridge solve or FISTA iterations per (fold, candidate), each pair
   stopping at its own convergence;
 * ``fit_softmax_grid`` — every (fold, candidate) multinomial-LR fit at
   once under Böhning's bound (one weighted Gram per fold, its (F, C, D,
   D) majorizer inverted once, Nesterov steps over (F, C, K, N) logits,
   scalar-majorizer FISTA for L1 candidates);
 * ``fit_multinomial_logreg`` — one multinomial fit: blockwise Newton
   (a damped Cholesky solve per class) for pure-L2 candidates, FISTA
   under Böhning's bound when the L1 part is positive;
   ``softmax_predict_proba``.

Everything computes in float32 on the inputs' device; loops are Python
loops that read the stopping test back to the host once per iteration.
The per-fold Gram ``X' diag(w) X`` and the grid products are plain large
matrix products (``torch.matmul``), as the JAX package left them to XLA.
Not ported yet (ROADMAP Queue A item 6.7): the sharded solvers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["LinearFit", "fit_logistic_regression", "logreg_predict_proba",
           "fit_logreg_grid", "fit_softmax_grid", "fit_multinomial_logreg",
           "softmax_predict_proba", "fit_linear_regression",
           "linear_predict", "fit_linreg_grid", "fit_linear_svc",
           "svc_decision", "fit_naive_bayes",
           "naive_bayes_predict_log_proba"]


class LinearFit(NamedTuple):
    """coef (D,) and intercept 0-d (a multinomial fit's (K, D) and (K,)),
    iterations run, whether it converged."""
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


# ---------------------------------------------------------------------------
# Multinomial (softmax) logistic regression
# ---------------------------------------------------------------------------

def fit_softmax_grid(X: torch.Tensor, y: torch.Tensor, n_classes: int,
                     W_tr: torch.Tensor, regs: torch.Tensor,
                     alphas: torch.Tensor, max_iter: int = 200,
                     tol: float = 1e-5, fit_intercept: bool = True,
                     standardization: bool = True
                     ) -> Tuple[torch.Tensor, int]:
    """Every (fold, candidate) multinomial-LR fit in one solve, the
    multiclass sibling of ``fit_logreg_grid``.

    ``X`` (N, D), ``y`` (N,) integer labels below ``n_classes`` K,
    ``W_tr`` (F, N) per-fold training weights, ``regs``/``alphas`` (C,)
    per candidate.  Returns ``(logits, iters)``: the (F, C, K, N) class
    scores of every row (a caller's argmax gives the predicted labels;
    the softmax never needs building) and the iterations run.

    Proximal majorization with Nesterov momentum under Böhning's bound
    H <= 1/2 (I_K - 11'/K) x X'WX <= 1/2 I_K x X'WX: one weighted Gram per
    fold, shared by every candidate and class, with the candidate's ridge
    inverted once per (fold, candidate); each step is two batched (N, D)
    products over the whole (fold, candidate, class) grid.  L1 candidates
    take the exact scalar-majorizer proximal step.  Stops when the largest
    coefficient move is at most ``tol`` or after ``max_iter`` steps."""
    dev = X.device
    X = X.to(torch.float32)
    yi = y.to(dev).long()
    W_tr = W_tr.to(dev, torch.float32)
    regs = regs.to(dev, torch.float32)
    alphas = alphas.to(dev, torch.float32)
    K = int(n_classes)
    n, d = X.shape
    F, C = W_tr.shape[0], regs.shape[0]
    Yt = torch.nn.functional.one_hot(yi, K).to(torch.float32).T  # (K, N)
    wsum = torch.clamp(W_tr.sum(1), min=1.0)
    l2 = regs[None, :] * (1.0 - alphas[None, :])            # (1, C)
    l1 = regs[None, :] * alphas[None, :]

    cen, sig = _grid_fold_stats(X, W_tr, wsum, fit_intercept,
                                standardization)
    Qs = _grid_fold_grams(X, W_tr, wsum, cen, sig)
    eye = torch.eye(d, dtype=X.dtype, device=dev)
    H = Qs[:, None] / 2.0 + (l2[:, :, None, None] + 2.5e-6) * eye
    H_inv_t = torch.linalg.inv(H).transpose(-1, -2)        # (F, C, D, D)

    def z_of(b, b0):
        """(F, C, K, N) logits of the standardized-space solution against
        the raw matrix."""
        u = b / sig[:, None, None, :]
        z = (u.reshape(F * C * K, d) @ X.T).reshape(F, C, K, n)
        return (z - (cen[:, None, None, :] * u).sum(3)[..., None]
                + b0[..., None])

    def grad(b, b0):
        p = torch.softmax(z_of(b, b0), dim=2)
        r = (W_tr[:, None, None, :] * (p - Yt[None, None])
             / wsum[:, None, None, None])
        g_raw = (r.reshape(F * C * K, n) @ X).reshape(F, C, K, d)
        rsum = r.sum(3)
        g = (g_raw - cen[:, None, None, :] * rsum[..., None]) \
            / sig[:, None, None, :]
        return g + l2[..., None, None] * b, rsum

    Lf = _grid_lmax(Qs)
    L_fc = (Lf[:, None] / 2.0 + l2 + 1e-6)[..., None, None]  # (F, C, 1, 1)
    thr = l1[..., None, None] / L_fc
    has_l1 = (l1 > 0)[..., None, None]

    b = torch.zeros((F, C, K, d), dtype=X.dtype, device=dev)
    b0 = torch.zeros((F, C, K), dtype=X.dtype, device=dev)
    pb, pb0 = b, b0
    tm, dn, it = 1.0, float("inf"), 0
    while dn > tol and it < max_iter:
        # Nesterov: the gradient at the extrapolated point
        gb, g0 = grad(b, b0)
        nb_mm = b - gb @ H_inv_t
        nb_prox = _soft(b - gb / L_fc, thr)
        nb = torch.where(has_l1, nb_prox, nb_mm)
        n0 = b0 - 2.0 * g0 if fit_intercept else b0
        ntm = 0.5 * (1.0 + (1.0 + 4.0 * tm * tm) ** 0.5)
        mom = (tm - 1.0) / ntm
        b, b0 = nb + mom * (nb - pb), n0 + mom * (n0 - pb0)
        dn = float(torch.maximum(torch.max(torch.abs(nb - pb)),
                                 torch.max(torch.abs(n0 - pb0))))
        pb, pb0, tm, it = nb, n0, ntm, it + 1
    return z_of(pb, pb0), it


def fit_multinomial_logreg(X: torch.Tensor, y: torch.Tensor,
                           n_classes: int,
                           sample_weight: Optional[torch.Tensor] = None,
                           reg_param: float = 0.0,
                           elastic_net_param: float = 0.0,
                           max_iter: int = 100, tol: float = 1e-6,
                           fit_intercept: bool = True) -> LinearFit:
    """Multinomial logistic regression on (N, D) ``X`` and integer labels
    (Spark's parameterisation, the loss a weighted mean).  Pure-L2:
    blockwise Newton — per class k, a Cholesky solve of X' diag(w p_k
    (1 - p_k)) X with its ridge and relative damping — stepping 0.9 of the
    direction.  L1 > 0: FISTA under Böhning's bound 1/2 X'WX (its top
    eigenvalue from a 16-step power iteration), at most ``8 max_iter``
    steps.  Returns (K, D) coefficients and (K,) intercepts."""
    X = X.to(torch.float32)
    n, d = X.shape
    dev = X.device
    K = int(n_classes)
    Y = torch.nn.functional.one_hot(y.to(dev).long(), K).to(torch.float32)
    w = (torch.ones(n, dtype=torch.float32, device=dev)
         if sample_weight is None
         else sample_weight.to(dev, torch.float32))
    wsum = torch.clamp(w.sum(), min=1.0)
    l2 = reg_param * (1.0 - elastic_net_param)
    l1 = reg_param * elastic_net_param
    Xa = (torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=dev)], 1)
          if fit_intercept else X)
    da = Xa.shape[1]

    def smooth_grad(B):
        P = torch.softmax(Xa @ B, dim=1)
        G = Xa.T @ (w[:, None] * (P - Y)) / wsum
        G[:d] += l2 * B[:d]
        return G, P

    B = torch.zeros((da, K), dtype=torch.float32, device=dev)
    dn, it = float("inf"), 0
    if l1 > 0:
        v = torch.ones(da, dtype=X.dtype, device=dev) / da ** 0.5
        for _ in range(16):
            v = Xa.T @ (w * (Xa @ v)) / (2.0 * wsum)
            v = v / (torch.linalg.norm(v) + 1e-12)
        L = (torch.dot(v, Xa.T @ (w * (Xa @ v)) / (2.0 * wsum)) * 1.01
             + l2 + 1e-6)
        thr = l1 / L
        coef_dims = (torch.arange(da, device=dev) < d)[:, None]
        zB, t_m = B, 1.0
        while dn > tol and it < 8 * max_iter:
            G, _ = smooth_grad(zB)
            nB = zB - G / L
            nB = _finite_or(torch.where(coef_dims, _soft(nB, thr), nB), B)
            nt = 0.5 * (1.0 + (1.0 + 4.0 * t_m * t_m) ** 0.5)
            zB = nB + (t_m - 1.0) / nt * (nB - B)
            dn = float(torch.max(torch.abs(nB - B)))
            B, t_m, it = nB, nt, it + 1
    else:
        diag = torch.arange(d, device=dev)
        while dn > tol and it < max_iter:
            G, P = smooth_grad(B)
            delta = torch.empty_like(B)
            for k in range(K):
                s = torch.clamp(w * P[:, k] * (1 - P[:, k]) / wsum,
                                min=1e-10)
                H = (Xa * s[:, None]).T @ Xa
                H[diag, diag] += l2
                delta[:, k] = _damped_solve(H, G[:, k])
            new = _finite_or(B - 0.9 * delta, B)
            dn = float(torch.max(torch.abs(new - B)))
            B, it = new, it + 1
    icpt = (B[d] if fit_intercept
            else torch.zeros(K, dtype=torch.float32, device=dev))
    return LinearFit(B[:d].T.contiguous(), icpt, it, dn <= tol)


def softmax_predict_proba(coef: torch.Tensor, intercept: torch.Tensor,
                          X: torch.Tensor):
    """(probabilities (N, K), class scores (N, K)) of a multinomial model:
    ``coef`` (K, D), ``intercept`` (K,)."""
    Z = (X.to(torch.float32) @ coef.to(X.device, torch.float32).T
         + intercept.to(X.device, torch.float32))
    return torch.softmax(Z, dim=1), Z


# ---------------------------------------------------------------------------
# Linear regression
# ---------------------------------------------------------------------------

def _power_lmax(A: torch.Tensor, steps: int) -> torch.Tensor:
    """Top eigenvalue of the symmetric (..., D, D) ``A`` by ``steps``
    power-iteration steps from the unit diagonal direction, as v' A v."""
    d = A.shape[-1]
    v = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device) / d ** 0.5
    for _ in range(steps):
        v = (A @ v[..., None])[..., 0]
        v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)
    return (v * (A @ v[..., None])[..., 0]).sum(-1)


def fit_linear_regression(X: torch.Tensor, y: torch.Tensor,
                          sample_weight: Optional[torch.Tensor] = None,
                          reg_param: float = 0.0,
                          elastic_net_param: float = 0.0,
                          max_iter: int = 200, tol: float = 1e-7,
                          fit_intercept: bool = True) -> LinearFit:
    """Weighted least squares on (N, D) ``X`` with l2 = reg (1 - alpha)
    and l1 = reg alpha.  The weighted, centred Gram A and moment b are one
    pass over the data; ridge (l1 = 0) solves (A + l2 I) beta = b with
    damping relative to its largest diagonal entry; elastic net runs FISTA
    on the quadratic with the step from a power-iteration bound on A's top
    eigenvalue, at most ``max_iter`` steps until the largest coefficient
    move is at most ``tol``."""
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
    if fit_intercept:
        xm = (w @ X) / wsum
        ym = (w @ y) / wsum
    else:
        xm = torch.zeros(d, dtype=X.dtype, device=dev)
        ym = torch.zeros((), dtype=X.dtype, device=dev)
    Xc = X - xm
    Xw = Xc * w[:, None]
    A = Xw.T @ Xc / wsum
    b = Xw.T @ (y - ym) / wsum
    if l1 > 0:
        L = _power_lmax(A, 17) + l2 + 1e-6
        beta = torch.zeros(d, dtype=X.dtype, device=dev)
        z, t_m, dn, it = beta, 1.0, float("inf"), 0
        while dn > tol and it < max_iter:
            nb = _soft(z - (A @ z - b + l2 * z) / L, l1 / L)
            nt = 0.5 * (1.0 + (1.0 + 4.0 * t_m * t_m) ** 0.5)
            z = nb + (t_m - 1.0) / nt * (nb - beta)
            dn = float(torch.max(torch.abs(nb - beta)))
            beta, t_m, it = nb, nt, it + 1
        converged = dn <= tol
    else:
        beta = _damped_solve(
            A + l2 * torch.eye(d, dtype=X.dtype, device=dev), b)
        it, converged = 1, True
    icpt = ym - torch.dot(xm, beta) if fit_intercept else ym
    return LinearFit(beta, icpt, it, converged)


def linear_predict(coef: torch.Tensor, intercept, X: torch.Tensor
                   ) -> torch.Tensor:
    """(N,) predictions X coef + intercept, float32."""
    return X.to(torch.float32) @ coef.to(X.device, torch.float32) + intercept


def fit_linreg_grid(X: torch.Tensor, y: torch.Tensor, W_tr: torch.Tensor,
                    regs: torch.Tensor, alphas: torch.Tensor,
                    max_iter: int = 200, tol: float = 1e-7,
                    fit_intercept: bool = True, standardization: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every (fold, candidate) linear-regression fit in one solve.

    ``X`` (N, D), ``y`` (N,), ``W_tr`` (F, N) per-fold training weights,
    ``regs``/``alphas`` (C,).  Returns ``(preds, coef, intercept)``: (F,
    C, N) predictions over all rows and the raw-feature-space (F, C, D) /
    (F, C) solutions.

    One weighted Gram per fold, centred by subtracting the weighted means'
    outer product and, under ``standardization``, scaled to unit diagonal
    (the penalty applies in standardized space).  Ridge candidates solve
    (A + (l2 + 1e-5) I) beta = b by Cholesky; candidates with an L1 part
    run FISTA on that Gram with the step from a power-iteration bound
    (x1.01), each (fold, candidate) pair stopping on its own once its
    largest coefficient move is at most ``tol`` or after ``max_iter``
    steps."""
    dev = X.device
    X = X.to(torch.float32)
    y = y.to(dev, torch.float32)
    W_tr = W_tr.to(dev, torch.float32)
    regs = regs.to(dev, torch.float32)
    alphas = alphas.to(dev, torch.float32)
    n, d = X.shape
    F, C = W_tr.shape[0], regs.shape[0]
    wsum = torch.clamp(W_tr.sum(1), min=1.0)
    l2 = (regs * (1.0 - alphas))[None, :].expand(F, C)      # (F, C)
    l1 = (regs * alphas)[None, :].expand(F, C)
    if fit_intercept:
        xm = (W_tr @ X) / wsum[:, None]
        ym = (W_tr @ y) / wsum
    else:
        xm = torch.zeros((F, d), dtype=X.dtype, device=dev)
        ym = torch.zeros(F, dtype=X.dtype, device=dev)
    A_raw = torch.stack([(X * w_f[:, None]).T @ X for w_f in W_tr])
    b_raw = torch.stack([(X * w_f[:, None]).T @ y for w_f in W_tr])
    A = A_raw / wsum[:, None, None] - xm[:, :, None] * xm[:, None, :]
    bv = b_raw / wsum[:, None] - xm * ym[:, None]
    if standardization:
        sig = torch.sqrt(torch.clamp(A.diagonal(dim1=1, dim2=2), min=0.0))
        sig = torch.where(sig < 1e-12, 1.0, sig)
        A = A / (sig[:, :, None] * sig[:, None, :])
        bv = bv / sig
    else:
        sig = torch.ones((F, d), dtype=X.dtype, device=dev)
    eye = torch.eye(d, dtype=X.dtype, device=dev)
    Ab = A[:, None].expand(F, C, d, d)
    bb = bv[:, None].expand(F, C, d)

    M = Ab + (l2 + 1e-5)[..., None, None] * eye
    Lc, _ = torch.linalg.cholesky_ex(M)
    coef_s = torch.cholesky_solve(bb[..., None], Lc)[..., 0]   # ridge
    has_l1 = l1 > 0
    if bool(has_l1.any()):
        Lf = (_power_lmax(A, 16) * 1.01)[:, None] + l2 + 1e-6       # (F, C)
        beta = torch.zeros((F, C, d), dtype=X.dtype, device=dev)
        z = beta
        t_m = torch.ones((F, C), dtype=X.dtype, device=dev)
        dn = torch.full((F, C), float("inf"), dtype=X.dtype, device=dev)
        it = torch.zeros((F, C), dtype=torch.int64, device=dev)
        while True:
            live = has_l1 & (dn > tol) & (it < max_iter)
            if not bool(live.any()):
                break
            g = (Ab @ z[..., None])[..., 0] - bb + l2[..., None] * z
            nb = _soft(z - g / Lf[..., None], (l1 / Lf)[..., None])
            nt = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t_m * t_m))
            nz = nb + ((t_m - 1.0) / nt)[..., None] * (nb - beta)
            ndn = torch.max(torch.abs(nb - beta), dim=2).values
            lv = live[..., None]
            beta = torch.where(lv, nb, beta)
            z = torch.where(lv, nz, z)
            t_m = torch.where(live, nt, t_m)
            dn = torch.where(live, ndn, dn)
            it = it + live.to(torch.int64)
        coef_s = torch.where(has_l1[..., None], beta, coef_s)
    coef = coef_s / sig[:, None, :]
    icpt = ym[:, None] - (xm[:, None, :] * coef).sum(2)
    preds = (coef.reshape(F * C, d) @ X.T).reshape(F, C, n)
    return preds + icpt[..., None], coef, icpt


# ---------------------------------------------------------------------------
# Linear SVC and multinomial naive Bayes
# ---------------------------------------------------------------------------

def fit_linear_svc(X: torch.Tensor, y: torch.Tensor,
                   sample_weight: Optional[torch.Tensor] = None,
                   reg_param: float = 1e-4, max_iter: int = 50,
                   tol: float = 1e-6, fit_intercept: bool = True
                   ) -> LinearFit:
    """Squared-hinge linear SVM with an L2 penalty (labels in {0, 1}, the
    loss a weighted mean), by Newton steps on its generalized Hessian
    over the rows inside the margin, each a damped Cholesky solve; stops
    when no coefficient moves more than ``tol`` or after ``max_iter``
    steps."""
    X = X.to(torch.float32)
    n, d = X.shape
    dev = X.device
    ypm = 2.0 * y.to(dev, torch.float32) - 1.0          # {-1, +1}
    w = (torch.ones(n, dtype=torch.float32, device=dev)
         if sample_weight is None
         else sample_weight.to(dev, torch.float32))
    wsum = torch.clamp(w.sum(), min=1.0)
    Xa = (torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=dev)], 1)
          if fit_intercept else X)
    diag = torch.arange(d, device=dev)
    beta = torch.zeros(Xa.shape[1], dtype=torch.float32, device=dev)
    dn, it = float("inf"), 0
    while dn > tol and it < max_iter:
        margin = 1.0 - ypm * (Xa @ beta)
        active = (margin > 0).to(X.dtype) * w / wsum
        grad = Xa.T @ (-2.0 * active * ypm * margin)
        grad[:d] += reg_param * beta[:d]
        H = (Xa * (2.0 * active)[:, None]).T @ Xa
        H[diag, diag] += reg_param
        new = _finite_or(beta - _damped_solve(H, grad), beta)
        dn = float(torch.max(torch.abs(new - beta)))
        beta, it = new, it + 1
    icpt = beta[d] if fit_intercept else torch.zeros((), device=dev)
    return LinearFit(beta[:d], icpt, it, dn <= tol)


def svc_decision(coef: torch.Tensor, intercept, X: torch.Tensor
                 ) -> torch.Tensor:
    """The SVM's margins ``X coef + intercept``."""
    return X.to(torch.float32) @ coef.to(X.device, torch.float32) + intercept


def fit_naive_bayes(X: torch.Tensor, y: torch.Tensor, n_classes: int,
                    sample_weight: Optional[torch.Tensor] = None,
                    smoothing: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multinomial naive Bayes (Spark's default, smoothing 1): log priors
    (K,) and log likelihoods (K, D) of the matrix clipped at 0, from the
    weighted class counts and per-class feature sums (one (K, N) x (N, D)
    product)."""
    X = torch.clamp(X.to(torch.float32), min=0.0)
    n, d = X.shape
    dev = X.device
    w = (torch.ones(n, dtype=torch.float32, device=dev)
         if sample_weight is None
         else sample_weight.to(dev, torch.float32))
    Y = torch.nn.functional.one_hot(y.to(dev).long(), n_classes).to(
        torch.float32) * w[:, None]
    class_count = Y.sum(0)
    feat_count = Y.T @ X
    log_prior = (torch.log(class_count + 1e-12)
                 - torch.log(torch.clamp(class_count.sum(), min=1e-12)))
    log_lik = (torch.log(feat_count + smoothing)
               - torch.log(feat_count.sum(1, keepdim=True)
                           + smoothing * d))
    return log_prior, log_lik


def naive_bayes_predict_log_proba(log_prior: torch.Tensor,
                                  log_lik: torch.Tensor, X: torch.Tensor
                                  ) -> torch.Tensor:
    """Per-class log posteriors (N, K) of the clipped matrix."""
    Xc = torch.clamp(X.to(torch.float32), min=0.0)
    joint = Xc @ log_lik.to(Xc.device).T + log_prior.to(Xc.device)
    return joint - torch.logsumexp(joint, dim=1, keepdim=True)
