"""Multilayer perceptron classifier (counterpart of
``transmogrifai_tpu.models.mlp``): Spark's feed-forward network
(OpMultilayerPerceptronClassifier.scala:48) with sigmoid hidden units and
a softmax output, ``layers = [in, hidden..., out]``, on standardized
inputs (unless ``standardization=False``).

The network is an ``nn.Module`` (``MLPNet``) whose layer weights keep the
JAX package's (fan_in, fan_out) layout, so fitted weights cross between
the packages as they are.  ``fit_mlp`` is full-batch Adam over the
weighted cross-entropy with gradients from ``torch.autograd``; it stops
after ``max_iter`` steps or when the loss moves by less than ``tol``, a
test that reads the loss back to the host every step (a CUDA graph of the
loop is later work).  Initial weights are Glorot-uniform from an explicit
``torch.Generator`` (``init_params``); they are not ``jax.random``'s bits,
so parity tests inject the JAX package's by replacing ``init_params``.
No kernel: the products are plain ``torch.matmul``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import as_device_tensor, resolve_device
from ..types.columns import ColumnarDataset
from .classification import _standardize_stats
from .prediction import PredictionBatch, PredictorEstimator, PredictorModel

__all__ = ["MLPNet", "init_params", "fit_mlp",
           "OpMultilayerPerceptronClassifier", "MLPClassificationModel"]


class MLPNet(nn.Module):
    """Sigmoid hidden layers and linear logits at the top; layer i is
    ``h @ W_i + b_i`` with ``W_i`` (fan_in, fan_out)."""

    def __init__(self, params: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.W = nn.ParameterList([nn.Parameter(W) for W, _ in params])
        self.b = nn.ParameterList([nn.Parameter(b) for _, b in params])

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        h = X
        last = len(self.W) - 1
        for i, (W, b) in enumerate(zip(self.W, self.b)):
            h = h @ W + b
            if i < last:
                h = torch.sigmoid(h)
        return h


def init_params(sizes: Sequence[int], seed: int, device
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Glorot-uniform weights (fan_in, fan_out) in [-lim, lim], lim =
    sqrt(6 / (fan_in + fan_out)), and zero biases, per layer, drawn from
    a generator on ``device`` seeded by ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
        W = (torch.rand((fan_in, fan_out), generator=gen, device=device)
             * (2 * lim) - lim)
        out.append((W, torch.zeros(fan_out, device=device)))
    return out


def _loss(net: MLPNet, X, Y, w) -> torch.Tensor:
    """Weighted mean cross-entropy of the softmax of the logits."""
    logp = torch.log_softmax(net(X), dim=1)
    return -(w * (Y * logp).sum(1)).sum() / torch.clamp(w.sum(), min=1e-12)


def fit_mlp(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor,
            params: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
            max_iter: int = 100, tol: float = 1e-6, step_size: float = 0.03
            ) -> Tuple[MLPNet, int, float]:
    """Full-batch Adam (beta 0.9 / 0.999, eps 1e-8, the JAX package's
    update in float32) from the initial ``params`` on standardized ``X``
    (N, D), one-hot ``Y`` (N, K) and row weights ``w`` (N,).  Stops after
    ``max_iter`` steps or at the first step whose loss differs from the
    last one's by less than ``tol``.  Returns (the fitted net, steps run,
    the last loss)."""
    net = MLPNet([(W.detach().clone().to(X.device, torch.float32),
                   b.detach().clone().to(X.device, torch.float32))
                  for W, b in params])
    ps = list(net.parameters())
    m = [torch.zeros_like(p) for p in ps]
    v = [torch.zeros_like(p) for p in ps]
    b1 = torch.tensor(0.9, dtype=torch.float32, device=X.device)
    b2 = torch.tensor(0.999, dtype=torch.float32, device=X.device)
    prev, loss_v, it = float("inf"), float("inf"), 0
    while it < max_iter:
        loss = _loss(net, X, Y, w)
        grads = torch.autograd.grad(loss, ps)
        t = torch.tensor(it + 1, dtype=torch.float32, device=X.device)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        with torch.no_grad():
            for p, g, mi, vi in zip(ps, grads, m, v):
                mi.mul_(0.9).add_(0.1 * g)
                vi.mul_(0.999).add_(0.001 * g * g)
                p.sub_(step_size * (mi / bc1)
                       / (torch.sqrt(vi / bc2) + 1e-8))
        loss_v = float(loss.detach())
        it += 1
        if abs(prev - loss_v) < tol:
            break
        prev = loss_v
    return net, it, loss_v


class OpMultilayerPerceptronClassifier(PredictorEstimator):
    """Feed-forward MLP classifier, binary or multiclass.  ``layers`` is
    Spark's full spec ``[input, hidden..., output]`` (checked against the
    data); ``hidden_layers`` the grid-friendly alternative, the input and
    output widths taken from the data.  Inputs are standardized unless
    ``standardization`` is False.  The solver is full-batch Adam whatever
    ``solver`` and ``block_size`` say: both are Spark's options, kept and
    written in the params as the JAX package keeps them (it runs the same
    full-batch Adam)."""

    _op_name = "mlpCls"

    def __init__(self, layers: Optional[Sequence[int]] = None,
                 hidden_layers: Sequence[int] = (10,),
                 max_iter: int = 100, tol: float = 1e-6,
                 step_size: float = 0.03, block_size: int = 128,
                 solver: str = "adam", standardization: bool = True,
                 seed: int = 42, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name=self._op_name, uid=uid)
        self.layers = list(layers) if layers is not None else None
        self.hidden_layers = list(hidden_layers)
        self.max_iter = max_iter
        self.tol = tol
        self.step_size = step_size
        self.block_size = block_size
        self.solver = solver
        self.standardization = standardization
        self.seed = seed
        self.device = device

    def fit_columns(self, data: ColumnarDataset, label_col, features_col):
        y = np.nan_to_num(np.asarray(label_col.values, dtype=np.float32))
        return self.fit_raw(features_col.values, y)

    def _sizes(self, d: int, k: int) -> Tuple[int, ...]:
        """Layer sizes.  An explicit spec is the authority on the class
        count (a training fold missing the top class must not shrink the
        softmax head): only its input width is checked against the data,
        and the labels may not need more classes than it declares."""
        if self.layers is not None:
            sizes = tuple(int(s) for s in self.layers)
            if sizes[0] != d:
                raise ValueError(
                    f"layers {sizes} do not match data: input dim {d} "
                    f"(Spark MLP layers are [in, hidden..., out])")
            if sizes[-1] < k:
                raise ValueError(
                    f"layers {sizes} declare {sizes[-1]} classes but labels "
                    f"contain class {k - 1}")
            return sizes
        return (d, *map(int, self.hidden_layers), k)

    def fit_raw(self, X, y, w=None, device=None) -> "MLPClassificationModel":
        """Fit on a (N, D) matrix and labels in {0, .., K-1} (K = the
        largest label + 1, at least 2, unless ``layers`` says more), on
        ``device`` (else the stage's, else the default device).
        ``metadata["n_iter"]`` counts the Adam steps run."""
        dev = resolve_device(device if device is not None else self.device)
        X = torch.as_tensor(X, dtype=torch.float32).to(dev)
        y = np.asarray(y, np.float32)
        n, d = X.shape
        k = max(int(np.nanmax(y)) + 1 if len(y) else 2, 2)
        sizes = self._sizes(d, k)
        Y = torch.nn.functional.one_hot(
            torch.from_numpy(y.astype(np.int64)).to(dev),
            sizes[-1]).to(torch.float32)
        wv = (torch.ones(n, dtype=torch.float32, device=dev) if w is None
              else torch.as_tensor(np.asarray(w, np.float32)).to(dev))
        if self.standardization:
            mu, sigma = _standardize_stats(X, wv)
        else:
            mu = torch.zeros(d, dtype=torch.float32, device=dev)
            sigma = torch.ones(d, dtype=torch.float32, device=dev)
        net, n_iter, _ = fit_mlp(
            (X - mu) / sigma, Y, wv, init_params(sizes, self.seed, dev),
            max_iter=self.max_iter, tol=self.tol, step_size=self.step_size)
        self.metadata["n_iter"] = n_iter
        return MLPClassificationModel(
            weights=[[W.detach(), b.detach()] for W, b in zip(net.W, net.b)],
            mu=mu, sigma=sigma)


class MLPClassificationModel(PredictorModel):
    """Fitted MLP: per layer ``[W (fan_in, fan_out), b (fan_out,)]`` and the
    input standardization ``mu``/``sigma`` (D,), as tensors on the model's
    device (arrays and lists — a loaded artifact's — go to ``device``,
    else the default device).  The network is built once, here, over
    those tensors; inputs are scored on the model's device."""

    def __init__(self, weights, mu, sigma, device: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="mlpCls", uid=uid)
        self.weights = [[as_device_tensor(W, torch.float32, device),
                         as_device_tensor(b, torch.float32, device)]
                        for W, b in weights]
        self.mu = as_device_tensor(mu, torch.float32, device)
        self.sigma = as_device_tensor(sigma, torch.float32, device)
        self.device = device
        self._net = MLPNet(self.weights).requires_grad_(False)

    def predict_batch(self, X: torch.Tensor) -> PredictionBatch:
        X = X.to(self.mu.device, torch.float32)
        with torch.no_grad():
            z = self._net((X - self.mu) / self.sigma)
        proba = torch.softmax(z, dim=1)
        return PredictionBatch(
            prediction=proba.argmax(dim=1).to(torch.float64),
            raw_prediction=z, probability=proba)
