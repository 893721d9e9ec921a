"""Mixture-of-experts layer: the JAX package's ``models/moe.py`` in
PyTorch.

Top-k routing (k = 1 Switch-style, k = 2 GShard-style) with a static
capacity factor: dispatch and combine are einsums against a one-hot
dispatch tensor ``[T, E, C]``, as in the JAX package, so both compute the
same function. A token past its expert's capacity is dropped from that
expert (its dispatch and combine rows are zero). The router and the
expert FFN run in f32 whatever the parameters' dtype, as JAX's promotion
of bf16 weights against the f32 dispatch queues does: the casts are
written out here because PyTorch refuses mixed-dtype products.

Expert parallelism over a mesh axis comes in two forms in the JAX
package. The replicated-token form (``moe_layer_replicated_ep``: every
rank routes all tokens, runs its local experts, one ``psum``) goes
through :mod:`mpi_acx_torch.parallel.collective`, on any mesh; the train
step uses it. The forms that move tokens with ``all_to_all`` (``moe_layer``
with ``ep_axis``, ``moe_layer_sharded_dispatch``, ``make_moe_train_step``)
raise ``NotImplementedError`` ('multi-rank training').
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.parallel import collective as col

ALL_TO_ALL = ("needs all_to_all across ranks, which is not ported yet "
              "(ROADMAP.md §A, 'multi-rank training')")


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int = 128
    d_ff: int = 256
    n_experts: int = 8
    capacity_factor: float = 2.0
    top_k: int = 1     # experts per token (1 = Switch, 2 = GShard-style)


def init_moe_params(cfg: MoeConfig, seed: int = 0, device=None,
                    dtype=torch.float32) -> Dict[str, Any]:
    """``gate`` [d, E], ``w1`` [E, d, ff], ``w2`` [E, ff, d], each N(0,
    0.02) drawn on ``device`` (``None`` means the GPU) from a
    ``torch.Generator`` there seeded with ``seed`` — the JAX package's
    scheme, not its numbers."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff

    def nrm(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=dtype).mul_(0.02)

    return {"gate": nrm(d, E), "w1": nrm(E, d, ff), "w2": nrm(E, ff, d)}


def _top_k(gates, k: int):
    """The indices of the ``k`` largest gates of each row, ties to the
    lower expert index (``lax.top_k``'s order; ``torch.topk`` documents
    none)."""
    return torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :k]


def _dispatch_tensors(gates, capacity: int, k: int = 1):
    """gates [T, E] -> (dispatch [T, E, C] one-hot, combine [T, E, C]), f32.

    Choice rank 0 (every token's best expert) claims queue positions
    first, then rank 1: adding second choices never evicts a first choice.
    A token's queue position is a cumulative sum over the rows in order.
    Tokens past an expert's capacity are dropped from it (zero rows).
    Combine weights are the router's softmax probabilities of the
    surviving choices, not renormalized (the Switch/GShard convention)."""
    T, E = gates.shape
    probs = torch.softmax(gates, dim=-1)                      # [T, E]
    idx = _top_k(gates, k)                                    # [T, k]
    slots = torch.arange(capacity, device=gates.device)
    dispatch = gates.new_zeros((T, E, capacity), dtype=torch.float32)
    combine = gates.new_zeros((T, E, capacity), dtype=torch.float32)
    counts = gates.new_zeros((E,), dtype=torch.float32)
    for c in range(k):
        onehot = F.one_hot(idx[:, c], E).float()              # [T, E]
        pos = ((onehot.cumsum(0) - 1.0) + counts) * onehot
        onehot = onehot * (pos < capacity)
        # A position past the capacity matches no slot: a zero row, as
        # jax.nn.one_hot gives (F.one_hot would raise).
        posc = (pos.sum(-1).long()[:, None] == slots).float()   # [T, C]
        d_c = onehot[:, :, None] * posc[:, None, :]           # [T, E, C]
        prob = (probs * onehot).sum(-1)                       # [T]
        dispatch = dispatch + d_c
        combine = combine + d_c * prob[:, None, None]
        counts = counts + onehot.sum(0)
    return dispatch, combine


def load_balance_loss(gates, k: int = 1):
    """Switch-Transformer load-balancing loss on router logits [T, E]:
    ``E * sum_e f_e * p_e``, f_e the fraction of (token, choice)
    assignments routed to expert e (before capacity), p_e the mean router
    probability. 1.0 at uniform routing."""
    T, E = gates.shape
    probs = torch.softmax(gates, dim=-1)
    f = F.one_hot(_top_k(gates, k), E).float().sum(1).mean(0)   # [E]
    return E * (f / k * probs.mean(0)).sum()


def router_z_loss(gates):
    """Mean squared router logsumexp of [T, E] logits (the ST-MoE
    z-loss)."""
    return torch.logsumexp(gates.float(), dim=-1).square().mean()


def _route(params, x, cfg: MoeConfig, E: int):
    """The routing prologue every path shares: (gates [T, E] f32,
    dispatch, combine, capacity). The one capacity formula."""
    gates = x.float() @ params["gate"].float()
    cap = int(cfg.capacity_factor * x.shape[0] / E + 1)
    dispatch, combine = _dispatch_tensors(gates, cap, cfg.top_k)
    return gates, dispatch, combine, cap


def _promote(a, w):
    """``w`` in the dtype JAX's promotion gives ``a`` against ``w``."""
    return w.to(torch.promote_types(a.dtype, w.dtype))


def _expert_ffn(xin, params):
    """The expert MLP on [..., E, C, d] queues; GELU is the tanh
    approximation (``jax.nn.gelu``'s default)."""
    h = F.gelu(torch.einsum("...ecd,edf->...ecf", xin,
                            _promote(xin, params["w1"])), approximate="tanh")
    return torch.einsum("...ecf,efd->...ecd", h, _promote(h, params["w2"]))


def _moe_forward(params, x, cfg: MoeConfig, ep_axis):
    """The single-device forward: (y [T, d] in x's dtype, gates [T, E]
    f32 logits)."""
    if ep_axis is not None:
        raise NotImplementedError(f"moe_layer with ep_axis={ep_axis!r} "
                                  f"{ALL_TO_ALL}")
    E = params["w1"].shape[0]
    gates, dispatch, combine, _ = _route(params, x, cfg, E)
    xin = torch.einsum("td,tec->ecd", x.float(), dispatch)
    out = _expert_ffn(xin, params)
    return torch.einsum("ecd,tec->td", out, combine).to(x.dtype), gates


def moe_layer(params: Dict[str, Any], x, cfg: MoeConfig,
              ep_axis: str | None = None):
    """x [T, d] -> [T, d]. ``ep_axis`` (experts sharded over a mesh axis,
    tokens moved by all_to_all) raises."""
    return _moe_forward(params, x, cfg, ep_axis)[0]


def _aux(gates, cfg: MoeConfig) -> Dict[str, Any]:
    return {"load_balance": load_balance_loss(gates, cfg.top_k),
            "router_z": router_z_loss(gates)}


def moe_layer_and_aux(params: Dict[str, Any], x, cfg: MoeConfig,
                      ep_axis: str | None = None):
    """:func:`moe_layer` and the training auxiliaries of its router:
    ``(y, {"load_balance": .., "router_z": ..})``."""
    y, gates = _moe_forward(params, x, cfg, ep_axis)
    return y, _aux(gates, cfg)


def _moe_forward_replicated(params, x, cfg: MoeConfig, ep_axis: str):
    """Replicated-token EP forward: every rank routes all T tokens, runs
    its local expert block ``params['w1'/'w2']`` [E / ep, ...], and one
    psum over ``ep_axis`` assembles the output. Returns (y, gates)."""
    e_local = params["w1"].shape[0]
    E = e_local * col.axis_size(ep_axis)
    gates, dispatch, combine, _ = _route(params, x, cfg, E)
    e0 = col.axis_index(ep_axis) * e_local
    xin = torch.einsum("td,tec->ecd", x.float(),
                       dispatch[:, e0:e0 + e_local])
    out = _expert_ffn(xin, params)
    part = torch.einsum("ecd,tec->td", out, combine[:, e0:e0 + e_local])
    return col.psum(part, ep_axis).to(x.dtype), gates


def moe_layer_replicated_ep(params: Dict[str, Any], x, cfg: MoeConfig,
                            ep_axis: str):
    """Expert parallelism for tokens every rank already holds (the train
    step's blocks): routing equals the single-device layer's."""
    return _moe_forward_replicated(params, x, cfg, ep_axis)[0]


def moe_layer_replicated_ep_and_aux(params: Dict[str, Any], x,
                                    cfg: MoeConfig, ep_axis: str):
    """:func:`moe_layer_replicated_ep` and the auxiliaries of the full
    (replicated) gates."""
    y, gates = _moe_forward_replicated(params, x, cfg, ep_axis)
    return y, _aux(gates, cfg)


def moe_layer_sharded_dispatch(params, x, cfg: MoeConfig, ep_axis: str):
    """Each rank routes its exclusive token slice through all_to_all:
    raises."""
    raise NotImplementedError(f"moe_layer_sharded_dispatch {ALL_TO_ALL}")


def make_moe_train_step(cfg: MoeConfig, mesh, ep_axis: str = "ep",
                        lr: float = 0.1, aux_weight: float = 1e-2,
                        z_weight: float = 1e-3):
    """The expert-parallel SGD step over an 'ep' mesh: raises."""
    raise NotImplementedError(f"make_moe_train_step {ALL_TO_ALL}")
