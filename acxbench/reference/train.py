"""The training reference: the mean next-token cross-entropy of a
family's plain forward, its gradients by autograd a microbatch at a time,
and AdamW (``reference/adamw.py``) stepping float32 weights."""

from __future__ import annotations

import torch.nn.functional as F


def loss_and_grads(ref, params, cfg, tokens, targets, mm):
    """tokens/targets [M, mb, S] (long) -> (mean loss over every token,
    gradients in ``leaves(params)`` order). ``params`` leaves must
    require grad; their ``.grad`` is left empty."""
    leaves = list(iter_leaves(params))
    M = tokens.shape[0]
    total = 0.0
    for m in range(M):
        h = ref.hidden(params, cfg, tokens[m], mm)
        logits = mm(h, ref.head(params).T)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets[m].reshape(-1))
        (loss / M).backward()
        total += loss.item() / M
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return total, grads


def iter_leaves(tree):
    """The tensors of a nested dict, in its order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from iter_leaves(v)
        else:
            yield v


def leaf_names(tree, prefix=""):
    """Dotted names of a nested dict's tensors, in :func:`iter_leaves`
    order."""
    out = []
    for k, v in tree.items():
        out.extend(leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else [prefix + k])
    return out
