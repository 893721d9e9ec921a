"""Switch-style MoE transformer (GPT-2 attention, mixture-of-experts FFN):
the JAX package's ``models/moe_transformer.py`` in PyTorch.

Every block is GPT-2's causal self-attention (``models/transformer.py``:
K1 in prefill and the forward, K2 in decode on the GPU) followed by a
top-k routed expert FFN (``models/moe.py``). Parameters are the JAX
package's stacked-layer dict: every per-layer tensor has a leading
``[n_layers]`` axis and the expert tensors an ``[n_experts]`` axis after
it. Prefill and decode are GPT-2's scaffold with the routed FFN plugged
into its ``ffn`` hook, so the KV cache is GPT-2's, int8 form included.

The router's dispatch group is the rows one call sees: the ``B * S``
tokens of a forward or prefill (bucket padding included), the ``B`` slots
of a decode step (idle slots included). Cached decode reproduces the dense
computation only where no token is dropped: serve with ``capacity_factor
>= n_experts``.

With ``ep_axis`` the blocks run expert-parallel: this rank's tokens
through ``moe_layer_and_aux(ep_axis)``, whose all_to_all carries them to
their expert's rank. :func:`make_moe_transformer_train_step` is the
DP+EP step on one mesh axis (:func:`param_specs`); the framework's train
step (``mpi_acx_torch/train.py``) trains this family on any dp x pp x tp
mesh, its experts split over 'tp' (``train.moe_param_specs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.models import transformer as tfm
from mpi_acx_torch.models.decoding import greedy_generate, sample_generate
from mpi_acx_torch.models.moe import (MoeConfig, moe_layer,
                                      moe_layer_and_aux,
                                      moe_layer_replicated_ep,
                                      moe_layer_replicated_ep_and_aux,
                                      moe_layer_sharded_dispatch)
# The JAX tree's converter and the device check are GPT-2's, leaf for leaf
# (re-exported under the JAX package's names).
from mpi_acx_torch.models.transformer import (  # noqa: F401
    check_device, params_from_jax)
from mpi_acx_torch.ops.wquant import wread
from mpi_acx_torch.ops.xent import chunked_xent_ll
from mpi_acx_torch.parallel import collective as col
from mpi_acx_torch.parallel.mesh import PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class MoeTransformerConfig:
    vocab: int = 50257
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072          # per-expert FFN width
    n_experts: int = 8
    top_k: int = 1
    capacity_factor: float = 2.0
    max_seq: int = 1024
    dtype: Any = torch.bfloat16  # compute dtype
    # Prefill and decode attention, as in transformer.TransformerConfig.
    use_flash: Optional[bool] = None
    decode_flash: Optional[bool] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def moe(self) -> MoeConfig:
        return MoeConfig(d_model=self.d_model, d_ff=self.d_ff,
                         n_experts=self.n_experts,
                         capacity_factor=self.capacity_factor,
                         top_k=self.top_k)


def tiny_moe_config(vocab: int = 256, d_model: int = 32, n_heads: int = 2,
                    n_layers: int = 2, d_ff: int = 64, n_experts: int = 8,
                    top_k: int = 1, capacity_factor: float = 2.0,
                    max_seq: int = 64) -> MoeTransformerConfig:
    return MoeTransformerConfig(
        vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        d_ff=d_ff, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, max_seq=max_seq)


Params = Dict[str, Any]


def init_params(cfg: MoeTransformerConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> Params:
    """Stacked-layer parameters in ``dtype`` on ``device`` (``None`` means
    the GPU): every weight N(0, 0.02), norms at 1/0 — the JAX package's
    scheme, not its numbers. Each leaf is drawn on the device itself, one
    after the other, from a ``torch.Generator`` there seeded with
    ``seed``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, d, ff, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts

    def nrm(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=dtype).mul_(0.02)

    def full(value, *shape):
        return torch.full(shape, value, device=dev, dtype=dtype)

    return {
        "embed": nrm(cfg.vocab, d),
        "pos": nrm(cfg.max_seq, d),
        "lnf_g": full(1.0, d), "lnf_b": full(0.0, d),
        "layers": {
            "ln1_g": full(1.0, L, d), "ln1_b": full(0.0, L, d),
            "wqkv": nrm(L, d, 3 * d),
            "wo": nrm(L, d, d),
            "ln2_g": full(1.0, L, d), "ln2_b": full(0.0, L, d),
            "gate": nrm(L, d, E),
            "w1": nrm(L, E, d, ff),
            "w2": nrm(L, E, ff, d),
        },
    }


def _reject_quantized_experts(lp: Params) -> None:
    """The expert einsums read w1/w2 directly: refuse int8 weight-only
    checkpoints rather than multiply codes without their scales."""
    if "w1_scale" in lp or "w2_scale" in lp:
        raise ValueError(
            "MoE expert weights do not support int8 weight-only "
            "quantization (ops/wquant.py is the dense serving path)")


def _experts(lp: Params) -> Params:
    return {"gate": lp["gate"], "w1": lp["w1"], "w2": lp["w2"]}


def block(cfg: MoeTransformerConfig, lp: Params, h,
          ep_axis: str | None = None):
    """One block on h [B, S, d]: ``(h, (load_balance, router_z))`` of this
    block's router. With ``ep_axis`` (under an active mesh) ``lp``'s gate
    is whole and its w1/w2 this rank's expert block; the tokens travel by
    all_to_all."""
    B, S, d = h.shape
    _reject_quantized_experts(lp)
    q, k, v = tfm._qkv(cfg, lp, h)
    h = h + tfm._attend(cfg, q, k, v) @ wread(lp, "wo", h.dtype)
    hn = tfm.layernorm(h, lp["ln2_g"], lp["ln2_b"])
    y, aux = moe_layer_and_aux(_experts(lp), hn.reshape(B * S, d), cfg.moe,
                               ep_axis=ep_axis)
    return h + y.reshape(B, S, d), (aux["load_balance"], aux["router_z"])


def _hidden(params: Params, cfg: MoeTransformerConfig, tokens,
            ep_axis: str | None = None):
    """tokens [B, S] -> (final-normed hidden states [B, S, d], the
    per-layer mean router losses ``{"load_balance", "router_z"}``)."""
    S = tokens.shape[1]
    h = (params["embed"][tokens] + params["pos"][:S]).to(cfg.dtype)
    lb = rz = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        h, (b_lb, b_rz) = block(cfg, tfm._layer(params, i), h,
                                ep_axis=ep_axis)
        lb, rz = lb + b_lb, rz + b_rz
    h = tfm.layernorm(h, params["lnf_g"], params["lnf_b"])
    L = cfg.n_layers
    return h, {"load_balance": lb / L, "router_z": rz / L}


def forward(params: Params, cfg: MoeTransformerConfig, tokens,
            ep_axis: str | None = None):
    """tokens [B, S] -> (logits [B, S, vocab] f32, aux), aux the per-layer
    mean router losses."""
    h, aux = _hidden(params, cfg, tokens, ep_axis=ep_axis)
    return tfm._unembed(h, params["embed"]), aux


def loss_fn(params: Params, cfg: MoeTransformerConfig, tokens, targets,
            aux_weight: float = 1e-2, z_weight: float = 1e-3,
            ep_axis: str | None = None, xent_chunk: int | None = None):
    """Mean token cross-entropy plus the weighted router auxiliaries;
    ``xent_chunk`` selects the chunked-vocab CE (ops/xent.py)."""
    targets = targets.long()
    if xent_chunk is not None:
        B, S = tokens.shape
        h, aux = _hidden(params, cfg, tokens, ep_axis=ep_axis)
        ll = chunked_xent_ll(h.reshape(B * S, -1), params["embed"],
                             targets.reshape(-1), xent_chunk)
    else:
        logits, aux = forward(params, cfg, tokens, ep_axis=ep_axis)
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(-1, targets[..., None])[..., 0]
    return (-ll.mean() + aux_weight * aux["load_balance"]
            + z_weight * aux["router_z"])


# -- KV-cache decode -------------------------------------------------------


def _moe_ffn(cfg: MoeTransformerConfig, lp: Params, h,
             ep_axis: str | None = None, replicated: bool = False,
             sharded_dispatch: bool = False, with_aux: bool = False):
    """The block's routed FFN half on h [B, S, d] (the token axis
    flattened for the router): ``h + moe(layernorm(h))``, and with
    ``with_aux`` this router's ``(load_balance, router_z)`` too.
    With ``ep_axis``: ``replicated=True`` when h is on every rank and each
    routes all tokens (the train step's blocks: local experts, one psum);
    ``sharded_dispatch=True`` when h is on every rank and each routes its
    exclusive 1/ep slice through all_to_all (tensor-parallel serving,
    ``moe.moe_layer_sharded_dispatch``); neither when the tokens are this
    rank's own (the all_to_all moves them)."""
    if replicated and sharded_dispatch:
        raise ValueError("replicated and sharded_dispatch exclude each other")
    if sharded_dispatch and with_aux:
        raise ValueError("the auxiliaries need the full gates: use "
                         "replicated")
    _reject_quantized_experts(lp)
    B, S, d = h.shape
    hn = tfm.layernorm(h, lp["ln2_g"], lp["ln2_b"])
    mp = _experts(lp)
    flat = hn.reshape(B * S, d)
    if ep_axis is not None and sharded_dispatch:
        y = moe_layer_sharded_dispatch(mp, flat, cfg.moe, ep_axis)
    elif ep_axis is not None and replicated:
        if with_aux:
            y, aux = moe_layer_replicated_ep_and_aux(mp, flat, cfg.moe,
                                                     ep_axis)
        else:
            y = moe_layer_replicated_ep(mp, flat, cfg.moe, ep_axis)
    elif with_aux:
        y, aux = moe_layer_and_aux(mp, flat, cfg.moe, ep_axis=ep_axis)
    else:
        y = moe_layer(mp, flat, cfg.moe, ep_axis=ep_axis)
    out = h + y.reshape(B, S, d)
    if with_aux:
        return out, (aux["load_balance"], aux["router_z"])
    return out


def init_kv_cache(cfg: MoeTransformerConfig, batch: int, max_len: int,
                  kv_int8: bool = False, device=None):
    """GPT-2's cache layout (the config duck-types), int8 form included;
    ``device=None`` means the GPU."""
    return tfm.init_kv_cache(cfg, batch, max_len, kv_int8=kv_int8,
                             device=device)


def prefill(params: Params, cfg: MoeTransformerConfig, tokens,
            max_len: int, last_only: bool = False, kv_int8: bool = False,
            last_index: Optional[int] = None, seat=None):
    """GPT-2's prefill with the routed FFN (``seat`` as there): the
    router's dispatch group is the B * S prompt rows, padding included, as
    in :func:`forward`."""
    return tfm.prefill(params, cfg, tokens, max_len, last_only,
                       ffn=_moe_ffn, kv_int8=kv_int8, last_index=last_index,
                       seat=seat)


def decode_step(params: Params, cfg: MoeTransformerConfig, cache, token):
    """GPT-2's decode step with the routed FFN (cache updated in place).
    The router sees the B decode tokens as its dispatch group (capacity
    cf * B / E + 1), so a served step equals the solo run only where no
    token is dropped: ``capacity_factor >= n_experts``."""
    return tfm.decode_step(params, cfg, cache, token, ffn=_moe_ffn)


def generate(params: Params, cfg: MoeTransformerConfig, prompt, n_new: int,
             max_len: Optional[int] = None, kv_int8: bool = False,
             device=None):
    """Greedy decode: prompt [B, S] -> [B, S + n_new] on ``device``
    (``None`` means the GPU; the parameters must already be there).
    ``kv_int8`` decodes from the int8 cache."""
    dev = resolve_device(device)
    check_device(params, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    return greedy_generate(
        lambda t, ml, lo: prefill(params, cfg, t, ml, last_only=lo,
                                  kv_int8=kv_int8),
        lambda c, t: decode_step(params, cfg, c, t),
        prompt, n_new, cfg.max_seq, max_len)


def generate_sample(params: Params, cfg: MoeTransformerConfig, prompt,
                    n_new: int, key: torch.Generator,
                    temperature: float = 1.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    max_len: Optional[int] = None, kv_int8: bool = False,
                    device=None):
    """Stochastic decode (temperature / top-k / top-p nucleus) from
    ``key``, a ``torch.Generator`` on ``device`` (``None`` means the
    GPU)."""
    dev = resolve_device(device)
    check_device(params, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    return sample_generate(
        lambda t, ml, lo: prefill(params, cfg, t, ml, last_only=lo,
                                  kv_int8=kv_int8),
        lambda c, t: decode_step(params, cfg, c, t),
        prompt, n_new, cfg.max_seq, key, temperature, top_k, top_p, max_len)


def param_specs(ep_axis: str = "dp") -> Dict[str, Any]:
    """PartitionSpecs of the DP+EP layout: the expert tensors split their
    [n_experts] dim over ``ep_axis``, everything else replicated."""
    return {
        "embed": P(), "pos": P(), "lnf_g": P(), "lnf_b": P(),
        "layers": {
            "ln1_g": P(), "ln1_b": P(), "wqkv": P(), "wo": P(),
            "ln2_g": P(), "ln2_b": P(), "gate": P(),
            "w1": P(None, ep_axis), "w2": P(None, ep_axis),
        },
    }


def make_moe_transformer_train_step(cfg: MoeTransformerConfig, mesh,
                                    axis: str = "dp", lr: float = 0.1,
                                    aux_weight: float = 1e-2,
                                    z_weight: float = 1e-3, device=None):
    """The DP+EP SGD step: one mesh axis splits both the batch and the
    experts (each rank runs the dense parts on its batch shard and hosts
    E / n experts that serve every rank's tokens through all_to_all).

    ``step(params, tokens, targets) -> (loss, params)`` is run by every
    rank on its shard: ``params`` laid out by :func:`param_specs`
    (``train.shard_params(params, param_specs(axis), mesh)``),
    ``tokens``/``targets`` [B / n, S] this rank's rows. The parameters
    are updated **in place** and returned. As in the JAX package each
    rank's loss covers its exclusive rows, a psum assembles the scalar
    (the division by n undoes its backward's seed), the replicated leaves
    psum their gradients and the expert blocks keep theirs (the
    all_to_all backward brought every rank's tokens). ``device=None``
    means the GPU."""
    n = mesh.shape[axis]
    if cfg.n_experts % n:
        raise ValueError(f"n_experts ({cfg.n_experts}) must divide by the "
                         f"{axis!r} mesh axis ({n})")
    dev = resolve_device(device)

    def step(params, tokens, targets):
        check_device(params, dev)
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        tree = {k: ({n: w.detach().requires_grad_(True)
                     for n, w in v.items()} if k == "layers"
                    else v.detach().requires_grad_(True))
                for k, v in params.items()}
        # (the dict of params holding the leaf, its name, its grad leaf)
        slots = [(params, k, v) for k, v in tree.items() if k != "layers"] \
            + [(params["layers"], k, v) for k, v in tree["layers"].items()]
        with mesh, torch.enable_grad():
            with col.tape(dev) as tape:
                loss = col.psum(loss_fn(tree, cfg, tokens, targets,
                                        aux_weight, z_weight,
                                        ep_axis=axis) / n, axis)
                sunk = tape.sink(loss)
            grads = torch.autograd.grad(sunk, [v for _, _, v in slots])
            grads = [g / n if k in ("w1", "w2") else col.psum(g / n, axis)
                     for (_, k, _), g in zip(slots, grads)]
        with torch.no_grad():
            for (holder, k, _), g in zip(slots, grads):
                holder[k].sub_(lr * g)
        return loss.detach(), params

    return step
