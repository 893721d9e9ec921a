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

Expert parallelism over a mesh axis (:mod:`mpi_acx_torch.parallel.collective`,
one process a rank, the rank holding its ``E / ep`` experts): with
``ep_axis`` :func:`moe_layer` routes this rank's tokens, and
``all_to_all`` carries each expert's queue to the expert's rank and the
results back (the dp+ep layout); :func:`moe_layer_sharded_dispatch` does
the same for tokens every rank holds, each rank routing its exclusive
slice, and one ``all_gather`` replicates the result;
``moe_layer_replicated_ep`` has every rank route all tokens, run its
local experts, and one ``psum`` assemble the output.
:func:`make_moe_train_step` is the expert-parallel SGD step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.parallel import collective as col

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
    """The forward: (y [T, d] in x's dtype, gates [T, E] f32 logits).
    With ``ep_axis`` the experts of ``params`` are this rank's block and
    the queues travel by all_to_all."""
    T, d = x.shape
    e_local = params["w1"].shape[0]
    if ep_axis is None:
        gates, dispatch, combine, _ = _route(params, x, cfg, e_local)
        xin = torch.einsum("td,tec->ecd", x.float(), dispatch)
        out = _expert_ffn(xin, params)
        return torch.einsum("ecd,tec->td", out, combine).to(x.dtype), gates
    ep = col.axis_size(ep_axis)
    E = e_local * ep
    # Capacity is per dispatch group (this rank's T tokens), as in GShard.
    gates, dispatch, combine, cap = _route(params, x, cfg, E)
    xin = torch.einsum("td,tec->ecd", x.float(), dispatch)
    # [E, C, d] -> [ep, E_local, C, d]: after the all_to_all part j holds
    # sender j's queues for this rank's experts.
    xin = col.all_to_all(xin.reshape(ep, e_local, cap, d), ep_axis)
    out = col.all_to_all(_expert_ffn(xin, params), ep_axis)
    out = out.reshape(E, cap, d)
    return torch.einsum("ecd,tec->td", out, combine).to(x.dtype), gates


def moe_layer(params: Dict[str, Any], x, cfg: MoeConfig,
              ep_axis: str | None = None):
    """x [T, d] -> [T, d]. With ``ep_axis`` (under an active mesh) the
    expert tensors of ``params`` are this rank's [E / ep, ...] block and
    the dispatched queues [E, C, d] regroup to [ep, E_local, C, d] and
    travel by all_to_all to their expert's rank and back. ``x`` may be
    the rank's own token shard (the dp+ep layout) or tokens every rank
    holds (each rank then routes the same tokens)."""
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


def moe_layer_sharded_dispatch(params: Dict[str, Any], x, cfg: MoeConfig,
                               ep_axis: str):
    """Expert parallelism for tokens every rank holds, with the routing
    sharded: each rank takes its exclusive T / ep slice of ``x`` [T, d],
    routes it through :func:`moe_layer` with ``ep_axis`` (all_to_all to
    the experts and back), and one tiled all_gather replicates the
    result. Capacity is per rank's slice, so the output equals the
    single-device layer's where no token drops (``capacity_factor >=
    n_experts``). Raises ``ValueError`` unless ``T % ep == 0``."""
    ep = col.axis_size(ep_axis)
    T = x.shape[0]
    if T % ep != 0:
        raise ValueError(
            f"sharded EP dispatch needs tokens ({T}) % ep ({ep}) == 0; "
            f"use moe_layer_replicated_ep for indivisible shapes")
    Tl = T // ep
    r = col.axis_index(ep_axis)
    yl = moe_layer(params, x[r * Tl:(r + 1) * Tl], cfg, ep_axis=ep_axis)
    return col.all_gather(yl, ep_axis, axis=0, tiled=True)


def make_moe_train_step(cfg: MoeConfig, mesh, ep_axis: str = "ep",
                        lr: float = 0.1, aux_weight: float = 1e-2,
                        z_weight: float = 1e-3, device=None):
    """Expert-parallel SGD step over the mesh's ``ep_axis``:
    ``step(params, x, targets) -> (loss, params)`` run by every rank on
    its shard: ``params`` with the gate whole and ``w1``/``w2`` this rank's
    [E / ep, ...] block, ``x``/``targets`` [T / ep, d] this rank's tokens.
    Loss = the global mean squared error + ``aux_weight`` * load balance +
    ``z_weight`` * router z (each rank's router terms over its tokens,
    averaged). The parameters are updated **in place** and returned.

    The gradient is built as the JAX package builds it: each rank's loss
    terms cover its exclusive tokens and a psum assembles the scalar;
    the psum's backward seeds every rank's terms with ``ep``, which the
    division undoes; the gate's gradient is then psummed and the expert
    blocks' are complete already (their all_to_all backward brought
    every rank's tokens). ``device=None`` means the GPU."""
    ep_n = mesh.shape[ep_axis]
    if cfg.n_experts % ep_n:
        raise ValueError(f"n_experts ({cfg.n_experts}) must divide by the "
                         f"{ep_axis!r} mesh axis ({ep_n})")
    dev = resolve_device(device)

    def step(params, x, tgt):
        x = torch.as_tensor(x, device=dev)
        tgt = torch.as_tensor(tgt, device=dev)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with mesh, torch.enable_grad():
            with col.tape(dev) as tape:
                y, aux = moe_layer_and_aux(leaves, x, cfg, ep_axis=ep_axis)
                se = (y.float() - tgt.float()).square().sum()
                raw = (se / (x.shape[1] * x.shape[0] * ep_n)
                       + (aux_weight * aux["load_balance"]
                          + z_weight * aux["router_z"]) / ep_n)
                loss = col.psum(raw, ep_axis)
                sunk = tape.sink(loss)
            grads = torch.autograd.grad(sunk, list(leaves.values()))
            g = {k: gr / ep_n for k, gr in zip(leaves, grads)}
            g["gate"] = col.psum(g["gate"], ep_axis)
        with torch.no_grad():
            for k, p in params.items():
                p.sub_(lr * g[k])
        return loss.detach(), params

    return step
