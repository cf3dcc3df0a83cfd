"""Logistic regression as a DataFrame workload (BASELINE config 5).

The port's counterpart of ``tensorframes_tpu/models/logreg.py``. The
training step is expressed through the frame's own ops, as the k-means
demo drives them: the model rides into the computation as constants,
``map_blocks`` scores blocks of rows, and the gradient is a
``reduce_blocks`` sum across partitions, combined on the host.

Parameters are ``{"w": [d], "b": []}`` tensors on the model's device
(``None``: the package default). The single-program step also runs over
a data mesh (``make_sharded_train_step(mesh)``): batch rows split over the
data shards, the gradient the global mean summed across shards in shard
order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .transformer import _named_args_fn, as_mesh

__all__ = ["LogisticRegression"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _nll(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy ``log(1 + e^z) - y z``, numerically stable."""
    return torch.clamp_min(z, 0.0) - z * y + torch.log1p(torch.exp(-z.abs()))


class LogisticRegression:
    """Binary logistic regression over a feature-vector column. The
    instance carries hyperparameters and the device; every method takes
    the parameters explicitly."""

    def __init__(self, num_features: int, l2: float = 0.0,
                 device: Optional[Union[str, torch.device]] = None):
        self.num_features = int(num_features)
        self.l2 = float(l2)
        self.device = resolve_device(device)

    def init(self, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """``w`` normal times 0.01 from ``generator`` (a CPU
        ``torch.Generator``; seed 0 if ``None``), ``b`` zero; f32."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        w = torch.randn(self.num_features, generator=generator) * 0.01
        return {"w": w.to(self.device),
                "b": torch.zeros((), dtype=torch.float32,
                                 device=self.device)}

    # -- plain model math ---------------------------------------------------
    def _params(self, params, like: torch.Tensor) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
        return (torch.as_tensor(params["w"]).to(like.device, like.dtype),
                torch.as_tensor(params["b"]).to(like.device, like.dtype))

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        w, b = self._params(params, x)
        return x @ w + b

    def loss(self, params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean sigmoid cross-entropy over the batch (+ L2)."""
        w, b = self._params(params, x)
        z = x @ w + b
        return torch.mean(_nll(z, y)) + 0.5 * self.l2 * torch.sum(w * w)

    def grads(self, params, x: torch.Tensor, y: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        """Gradients of :meth:`loss` by autograd, in the parameters'
        dtypes."""
        leaves = {k: torch.as_tensor(v).detach().to(self.device)
                  .requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            x = torch.as_tensor(x).to(self.device, leaves["w"].dtype)
            y = torch.as_tensor(y).to(self.device, leaves["w"].dtype)
            loss = self.loss(leaves, x, y)
            g = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, g))

    def sgd_step(self, params, x, y, lr: float = 0.1):
        g = self.grads(params, x, y)
        return {k: torch.as_tensor(p).to(self.device) - lr * g[k]
                for k, p in params.items()}

    # -- DataFrame-op formulation (the BASELINE workload) -------------------
    def gradient_via_frame(self, params, df, features: str = "features",
                           label: str = "label",
                           ) -> Tuple[Dict[str, np.ndarray], float]:
        """One gradient evaluation driven through the frame's ops.

        ``map_blocks`` computes per-row gradient contributions (the
        parameters ride into the program as constants on the package's
        default device, in the features' dtype), then ``reduce_blocks``
        sums them across partitions; its fetches come back sorted by name.
        Returns ``({'w': gw, 'b': gb}, loss)`` as numpy and a float."""
        w = _host(params["w"])
        b = _host(params["b"])
        n_total = df.count()
        dev = resolve_device(None)
        wt = torch.as_tensor(w, device=dev)
        bt = torch.as_tensor(b, device=dev)

        def per_row(**cols):
            x, y = cols[features], cols[label]
            z = x @ wt.to(x.dtype) + bt.to(x.dtype)
            err = (torch.sigmoid(z) - y)[:, None]
            return {"gw": err * x, "gb": err[:, 0], "nll": _nll(z, y)}

        fn = _named_args_fn(per_row, [features, label])
        scored = df.map_blocks(fn, trim=True)
        gb_s, gw_s, nll_s = scored.reduce_blocks(
            lambda gw_input, gb_input, nll_input: {
                "gw": gw_input.sum(0),
                "gb": gb_input.sum(0),
                "nll": nll_input.sum(0)})
        grad = {"w": gw_s / n_total + self.l2 * w,
                "b": gb_s / n_total}
        loss = float(nll_s / n_total + 0.5 * self.l2 * np.sum(w ** 2))
        return grad, loss

    def fit_via_frame(self, df, steps: int = 10, lr: float = 0.5,
                      features: str = "features", label: str = "label",
                      params=None):
        """Driver-side iteration loop, k-means-demo style: the parameters
        live on the host between rounds, re-embedded as constants each
        round. Returns ``(params, losses)`` (numpy, one loss a step)."""
        params = params if params is not None else self.init()
        params = {k: _host(v) for k, v in params.items()}
        losses = []
        for _ in range(steps):
            grad, loss = self.gradient_via_frame(
                params, df, features=features, label=label)
            params = {"w": params["w"] - lr * grad["w"],
                      "b": params["b"] - lr * grad["b"]}
            losses.append(loss)
        return params, losses

    # -- the single-program step ----------------------------------------------
    def make_sharded_train_step(self, mesh=None, lr: float = 0.1):
        """The train step as one program: ``params, loss = step(params, x,
        y)``, plain gradient descent, the loss that of the parameters it
        was given.

        ``mesh`` ``None`` (or of one device): on the model's device. A
        ``DeviceMesh`` (or a list of devices) of more: the batch rows are
        split over the data axis in contiguous blocks, each shard's
        summed loss and its gradients computed on its device, then summed
        across shards in shard order and divided by the batch's rows: the
        global mean the JAX package's allreduce gives. The new parameters
        and the loss come back on the model's device."""
        mesh = as_mesh(mesh)
        if mesh is None or mesh.num_devices == 1:
            def step(params, x, y):
                x = torch.as_tensor(x).to(self.device)
                y = torch.as_tensor(y).to(self.device)
                with torch.no_grad():
                    loss = self.loss(params, x, y)
                return self.sgd_step(params, x, y, lr=lr), loss

            return step
        devs = mesh.shard_devices()

        def step(params, x, y):
            x, y = torch.as_tensor(x), torch.as_tensor(y)
            n = x.shape[0]
            grads = {}
            nll = None
            for dev, xb, yb in zip(devs, torch.tensor_split(x, len(devs)),
                                   torch.tensor_split(y, len(devs))):
                leaves = {k: torch.as_tensor(v).detach().to(dev)
                          .requires_grad_() for k, v in params.items()}
                with torch.enable_grad():
                    xb = xb.to(dev, leaves["w"].dtype)
                    yb = yb.to(dev, leaves["w"].dtype)
                    z = xb @ leaves["w"] + leaves["b"]
                    s = torch.sum(_nll(z, yb))
                    g = torch.autograd.grad(s, list(leaves.values()))
                for k, gk in zip(leaves, g):
                    gk = gk.to(self.device)
                    grads[k] = gk if k not in grads else grads[k] + gk
                s = s.detach().to(self.device)
                nll = s if nll is None else nll + s
            w = torch.as_tensor(params["w"]).to(self.device)
            reg = 0.5 * self.l2 * torch.sum(w * w)
            grads["w"] = grads["w"] / n + self.l2 * w
            grads["b"] = grads["b"] / n
            new = {k: torch.as_tensor(p).to(self.device) - lr * grads[k]
                   for k, p in params.items()}
            return new, nll / n + reg

        return step
