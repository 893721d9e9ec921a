"""AdamW as Loshchilov and Hutter (2019) publish it, in the form
``torch.optim.AdamW`` documents: decoupled decay ``p *= 1 - lr*wd``, then
``p -= lr / (1 - b1^t) * m / (sqrt(v / (1 - b2^t)) + eps)``."""

from __future__ import annotations

import math

import torch


class AdamW:
    def __init__(self, leaves, lr, betas, eps, weight_decay):
        self.leaves = list(leaves)
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd = eps, weight_decay
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = math.sqrt(1 - self.b2 ** self.t)
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, v.sqrt().div_(c2).add_(self.eps),
                       value=-self.lr / c1)
