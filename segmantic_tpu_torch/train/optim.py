"""Optimizer factory + validation-epoch LR schedulers.

Port of ``segmantic_tpu/train/optim.py``: the same config dicts
(SGD / Adam / amsgrad / AdaBelief; Constant / ReduceOnPlateau / Cosine) and
the same updates as the optax transforms the JAX package builds. SGD with
momentum and Adam are ``torch.optim.SGD`` / ``torch.optim.Adam``, whose
updates equal optax's (Adam's eps sits outside the square root in both).
amsgrad and AdaBelief are written here: torch's amsgrad takes the running
maximum of the raw second moment where optax takes it of the bias-corrected
one, and torch has no AdaBelief. The learning rate lives in the param groups,
so :func:`set_learning_rate` changes it between steps.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import torch

__all__ = [
    "DEFAULT_OPTIMIZER", "DEFAULT_LR_SCHEDULING", "make_optimizer",
    "set_learning_rate", "LRScheduler", "AmsGrad", "AdaBelief",
]

DEFAULT_OPTIMIZER: Dict[str, Any] = {
    "optimizer": "Adam",
    "lr": 1e-4,
    "momentum": 0.9,
    "epsilon": 1e-8,
    "amsgrad": False,
    "weight_decouple": False,
}

DEFAULT_LR_SCHEDULING: Dict[str, Any] = {
    "scheduler": "Constant",
    "factor": 0.5,
    "patience": 10,
    "T_0": 50,
    "T_multi": 1,
}


class _Moments(torch.optim.Optimizer):
    """Adam-family base: first moment ``mu`` and second moment ``nu`` with
    optax's bias correction ``m / (1 - b^t)``; subclasses give the update."""

    def __init__(self, params, lr: float, b1: float, b2: float, eps: float,
                 eps_root: float):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                    self._init_extra(state, p)
                state["count"] += 1
                g = p.grad
                state["mu"].mul_(b1).add_(g, alpha=1 - b1)
                update = self._update(state, g, group)
                p.add_(update, alpha=-group["lr"])
        return None

    def _init_extra(self, state, p) -> None:
        pass

    def _update(self, state, g, group) -> torch.Tensor:
        raise NotImplementedError


class AmsGrad(_Moments):
    """optax ``amsgrad``: ``nu_max = max(nu_max, nu_hat)`` of the
    bias-corrected second moment; update ``mu_hat / (sqrt(nu_max + eps_root)
    + eps)``."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        super().__init__(params, lr, b1, b2, eps, eps_root)

    def _init_extra(self, state, p) -> None:
        state["nu_max"] = torch.zeros_like(p)

    def _update(self, state, g, group):
        b1, b2, t = group["b1"], group["b2"], state["count"]
        state["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
        nu_hat = state["nu"] / (1 - b2**t)
        torch.maximum(state["nu_max"], nu_hat, out=state["nu_max"])
        mu_hat = state["mu"] / (1 - b1**t)
        return mu_hat / (torch.sqrt(state["nu_max"] + group["eps_root"]) + group["eps"])


class AdaBelief(_Moments):
    """optax ``adabelief``: second moment of the prediction error
    ``g - mu`` plus ``eps_root``; update ``mu_hat / (sqrt(nu_hat) + eps)``."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-16, eps_root: float = 1e-16):
        super().__init__(params, lr, b1, b2, eps, eps_root)

    def _update(self, state, g, group):
        b1, b2, t = group["b1"], group["b2"], state["count"]
        err = g - state["mu"]
        state["nu"].mul_(b2).addcmul_(err, err, value=1 - b2).add_(group["eps_root"])
        mu_hat = state["mu"] / (1 - b1**t)
        nu_hat = state["nu"] / (1 - b2**t)
        return mu_hat / (torch.sqrt(nu_hat) + group["eps"])


def make_optimizer(params: Iterable[torch.Tensor],
                   config: Optional[Dict[str, Any]] = None) -> torch.optim.Optimizer:
    """The configured optimizer over ``params`` (lr in its param groups)."""
    cfg = dict(DEFAULT_OPTIMIZER)
    cfg.update(config or {})
    name = cfg["optimizer"]
    lr = float(cfg["lr"])
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=float(cfg["momentum"]))
    if name == "Adam":
        if cfg.get("amsgrad", False):
            return AmsGrad(params, lr=lr)  # optax.amsgrad's own eps (1e-8)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                eps=float(cfg.get("epsilon", 1e-8)))
    if name == "AdaBelief":
        return AdaBelief(params, lr=lr, eps=float(cfg.get("epsilon", 1e-8)))
    raise ValueError(f"unsupported optimizer {name!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every param group (takes effect next step)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


class LRScheduler:
    """Per-validation-epoch LR schedule state machine.

    ``step(val_loss)`` is called once per validation epoch and returns the
    new learning rate.
    """

    def __init__(self, base_lr: float, config: Optional[Dict[str, Any]] = None):
        cfg = dict(DEFAULT_LR_SCHEDULING)
        cfg.update(config or {})
        self.kind = cfg["scheduler"]
        self.base_lr = float(base_lr)
        self.factor = float(cfg.get("factor", 0.5))
        self.patience = int(cfg.get("patience", 10))
        self.t0 = int(cfg.get("T_0", 50))
        self.t_mult = int(cfg.get("T_multi", 1))
        self.lr = self.base_lr
        self._best = math.inf
        self._bad_epochs = 0
        self._epoch = 0
        if self.kind not in ("Constant", "ReduceOnPlateau", "Cosine"):
            raise ValueError(f"unsupported scheduler {self.kind!r}")

    def step(self, val_loss: Optional[float] = None) -> float:
        self._epoch += 1
        if self.kind == "Constant":
            return self.lr
        if self.kind == "ReduceOnPlateau":
            if val_loss is None:
                return self.lr
            if val_loss < self._best - 1e-8:
                self._best = val_loss
                self._bad_epochs = 0
            else:
                self._bad_epochs += 1
                if self._bad_epochs > self.patience:
                    self.lr *= self.factor
                    self._bad_epochs = 0
            return self.lr
        # CosineAnnealingWarmRestarts (eta_min = 0)
        if self.t_mult <= 1:
            period = self.t0
            t = self._epoch % period
        else:
            t, period = self._epoch, self.t0
            while t >= period:
                t -= period
                period *= self.t_mult
        self.lr = 0.5 * self.base_lr * (1 + math.cos(math.pi * t / period))
        return self.lr
