"""Train state: the generator, discriminator, latent classifier and frozen
CREPE, with their optimizers.

Counterpart of ``td_vc_gan_tpu/training/state.py``. Where the JAX package
keeps one immutable pytree, the port keeps the modules and ``torch.optim``
optimizers and updates them in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


class Updater:
    """One network's optimizer step: optional global-norm clipping of the
    trainable parameters' gradients (as ``optax.clip_by_global_norm``:
    scaled by max_norm / norm when norm >= max_norm), then the optimizer.
    A trainable parameter the loss does not reach gets a zero gradient, so
    that it decays and its moments advance as in optax (torch would skip
    it). Parameters under a frozen prefix are not in the optimizer and get
    no update."""

    def __init__(self, optimizer: torch.optim.Optimizer, max_norm: float | None = None):
        self.optimizer = optimizer
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.max_norm = max_norm

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm is not None:
            grads = [p.grad for p in self.params]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads]))
            scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
            torch._foreach_mul_(grads, scale)
        self.optimizer.step()


def trainable(module: nn.Module, frozen_prefixes=()) -> list[nn.Parameter]:
    """The parameters whose dotted names start with none of the prefixes
    (given '/'-joined, as in the JAX package's config)."""
    prefixes = tuple(p.replace("/", ".") for p in frozen_prefixes)
    return [p for name, p in module.named_parameters()
            if not any(name.startswith(pre) for pre in prefixes)]


def make_optimizers(cfg, G: nn.Module, D: nn.Module, C: nn.Module | None = None):
    """AdamW (lr, betas, weight decay 0.01, eps 1e-8) for G and D, Adam for C,
    as the JAX package's ``make_optimizers``; G's ``encoder.wavlm`` and the
    config's ``freeze_subnets`` are frozen."""
    t = cfg.train
    betas = tuple(t.adam_beta)
    frozen = ["encoder/wavlm", *(t.freeze_subnets or [])]
    g_opt = Updater(torch.optim.AdamW(trainable(G, frozen), lr=t.lr_g, betas=betas,
                                      weight_decay=0.01), t.grad_max_norm_G)
    d_opt = Updater(torch.optim.AdamW(D.parameters(), lr=t.lr_d, betas=betas,
                                      weight_decay=0.01), t.grad_max_norm_D)
    c_opt = (Updater(torch.optim.Adam(C.parameters(), lr=t.lr_d, betas=betas))
             if C is not None else None)
    return g_opt, d_opt, c_opt


@dataclass
class TrainState:
    G: nn.Module
    D: nn.Module
    C: nn.Module | None
    crepe: nn.Module
    opt_g: Updater
    opt_d: Updater
    opt_c: Updater | None
    step: int = 0


def create_train_state(cfg, G, D, C=None, crepe=None) -> TrainState:
    """The state with fresh optimizers; CREPE is frozen (no gradients)."""
    if crepe is not None:
        crepe.requires_grad_(False).eval()
    return TrainState(G, D, C, crepe, *make_optimizers(cfg, G, D, C))
