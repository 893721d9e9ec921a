"""The train step of the framework (the JAX package's ``train.py``) in
PyTorch: GPT-2, the Llama family and the MoE family through the dp x pp x
tp/sp composition.

The step is the JAX step's per-shard body, run by every rank of a
('dp', 'pp', 'tp') mesh (:func:`parallel.mesh.mesh_from_devices`) on its
own shard: embed, the GPipe pipeline over 'pp'
(:func:`parallel.pipeline.pipeline_forward`), in each stage every layer's
attention sequence-parallel over 'tp' by ring attention
(:func:`parallel.ring_attention.ring_attention_batched`, whose blocks run
B10's kernel on the card; Llama's K/V stay at their KV groups and are
broadcast per block) and the MLP tensor-parallel with one psum (MoE: the
routed FFN with its experts sharded over 'tp', tokens replicated, its
router losses carried through the pipeline), the exclusive-path loss, and
the gradient reduction rule. The backward is autograd through that
program, the collectives' backwards being JAX's transposes
(:mod:`parallel.collective`); attention's is the blockwise flash backward.
On a 1x1x1 mesh every collective is the identity and no
``torch.distributed`` world is needed.

The JAX step's options are here too: ``remat=True`` (each layer body
under ``torch.utils.checkpoint``), ``n_virtual > 1`` (the interleaved
pipeline over :func:`models.transformer.stage_slice_interleaved` params),
``schedule="1f1b"`` (the 1F1B slot engine of :mod:`parallel.pipeline`),
alone and combined, and ``dp_quant_bits=8`` (the dp gradient sync through
the int8 ring all-reduce of :mod:`parallel.quantized`).

Parameters are a dict of tensors: this rank's shard
(:func:`shard_params`) of the stage-sliced parameters
(:func:`models.transformer.stage_slice`, or
:func:`models.transformer.stage_slice_interleaved` with ``n_virtual >
1``), laid out by :func:`step_specs`; the batch is this rank's shard
(:func:`shard_batch`, the micro-batch axis split over 'dp'). The steps
update the parameters **in place**.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from mpi_acx_torch import profiling
from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.models import llama as lm
from mpi_acx_torch.models import moe_transformer as mtf
from mpi_acx_torch.models import transformer as tfm
from mpi_acx_torch.ops.xent import chunked_xent_ll
from mpi_acx_torch.parallel import collective as col
from mpi_acx_torch.parallel.mesh import PartitionSpec as P
from mpi_acx_torch.parallel.pipeline import (_pipeline_1f1b_engine,
                                             pipeline_forward,
                                             pipeline_forward_interleaved)
from mpi_acx_torch.parallel.quantized import quantized_pmean
from mpi_acx_torch.parallel.ring_attention import ring_attention_batched


def _gpt2_attn_sp(cfg, lp: Dict[str, Any], h, tp_axis: str):
    """The GPT-2 attention half under sequence parallelism: each tp rank
    projects q/k/v for its sequence block, ring attention rotates K/V
    blocks, and one all_gather re-assembles the outputs."""
    tpn = col.axis_size(tp_axis)
    ti = col.axis_index(tp_axis)
    mb, S, d = h.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    blk = S // tpn

    hn = tfm.layernorm(h, lp["ln1_g"], lp["ln1_b"])
    loc = hn[:, ti * blk:(ti + 1) * blk]                       # [mb,blk,d]
    qkv = loc @ lp["wqkv"].to(h.dtype)
    q, k, v = (x.reshape(mb, blk, H, Dh) for x in qkv.split(d, dim=-1))
    o = ring_attention_batched(q, k, v, tp_axis, causal=True,
                               use_flash=cfg.use_flash).reshape(mb, blk, d)
    o = o @ lp["wo"].to(h.dtype)
    return h + col.all_gather(o, tp_axis, axis=1, tiled=True)  # [mb,S,d]


def _block_sp_tp(cfg: tfm.TransformerConfig, lp: Dict[str, Any], h,
                 tp_axis: str):
    """Transformer block: sequence-parallel attention, then the MLP with
    its FFN dim sharded over tp (lp's w1/b1/w2 are the local slices) and
    one psum."""
    h = _gpt2_attn_sp(cfg, lp, h, tp_axis)
    hn = tfm.layernorm(h, lp["ln2_g"], lp["ln2_b"])
    # jax.nn.gelu defaults to the tanh approximation.
    y = F.gelu(hn @ lp["w1"].to(h.dtype) + lp["b1"].to(h.dtype),
               approximate="tanh")                             # [mb,S,ff/tp]
    part = y @ lp["w2"].to(h.dtype)
    return h + col.psum(part, tp_axis) + lp["b2"].to(h.dtype)


def _moe_block_sp_tp(cfg, lp: Dict[str, Any], h, tp_axis: str):
    """MoE block: the GPT-2 attention half (sequence-parallel), then the
    routed FFN with its experts sharded over tp. Tokens are replicated
    over tp, so each rank routes all of them, runs its local experts, and
    one psum assembles the output (routing equals the single-device
    layer's). Returns ``(h, (load_balance, router_z))``."""
    h = _gpt2_attn_sp(cfg, lp, h, tp_axis)
    return mtf._moe_ffn(cfg, lp, h, ep_axis=tp_axis, replicated=True,
                        with_aux=True)


def _llama_block_sp_tp(cfg, lp: Dict[str, Any], h, tp_axis: str):
    """Llama block (RMSNorm, RoPE, GQA, SwiGLU): sequence-parallel
    attention, then the SwiGLU MLP with its FFN dim sharded over tp (lp's
    w_gate/w_up/w_down are the local slices) and one psum. RoPE rotates
    each rank's block at its global positions ``ti * blk + arange(blk)``,
    so the sharded rotation equals the single-device one; K/V stay at
    ``n_kv_heads`` and the ring broadcasts them to the query heads per
    block."""
    tpn = col.axis_size(tp_axis)
    ti = col.axis_index(tp_axis)
    mb, S, d = h.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    blk = S // tpn

    hn = lm.rmsnorm(h, lp["attn_norm"])
    loc = hn[:, ti * blk:(ti + 1) * blk]                       # [mb,blk,d]
    q = (loc @ lp["wq"].to(h.dtype)).reshape(mb, blk, Hq, Dh)
    k = (loc @ lp["wk"].to(h.dtype)).reshape(mb, blk, Hkv, Dh)
    v = (loc @ lp["wv"].to(h.dtype)).reshape(mb, blk, Hkv, Dh)
    positions = ti * blk + torch.arange(blk, device=h.device)
    q = lm.rope(q, positions, cfg.rope_theta)
    k = lm.rope(k, positions, cfg.rope_theta)
    o = ring_attention_batched(q, k, v, tp_axis, causal=True,
                               use_flash=cfg.use_flash, kv_repeat=Hq // Hkv)
    o = o.reshape(mb, blk, Hq * Dh) @ lp["wo"].to(h.dtype)
    h = h + col.all_gather(o, tp_axis, axis=1, tiled=True)     # [mb,S,d]

    hn = lm.rmsnorm(h, lp["mlp_norm"])
    gate = F.silu(hn @ lp["w_gate"].to(h.dtype))              # [mb,S,ff/tp]
    up = hn @ lp["w_up"].to(h.dtype)
    part = (gate * up) @ lp["w_down"].to(h.dtype)
    return h + col.psum(part, tp_axis)


def param_specs(stage: bool = True) -> Dict[str, Any]:
    """How the stage-sliced GPT-2 parameters lie on the mesh: layers carry
    a leading 'pp' stage axis; the FFN dims of w1/b1/w2 split over 'tp';
    everything else is replicated."""
    pp = "pp" if stage else None
    return {
        "embed": P(), "pos": P(), "lnf_g": P(), "lnf_b": P(),
        "layers": {
            "ln1_g": P(pp), "ln1_b": P(pp),
            "wqkv": P(pp), "wo": P(pp),
            "ln2_g": P(pp), "ln2_b": P(pp),
            "w1": P(pp, None, None, "tp"), "b1": P(pp, None, "tp"),
            "w2": P(pp, None, "tp", None), "b2": P(pp),
        },
    }


def llama_param_specs(stage: bool = True) -> Dict[str, Any]:
    """The same for the Llama family: the SwiGLU FFN dims split over 'tp';
    attention and norms are replicated per stage."""
    pp = "pp" if stage else None
    return {
        "embed": P(), "final_norm": P(), "unembed": P(),
        "layers": {
            "attn_norm": P(pp), "wq": P(pp), "wk": P(pp), "wv": P(pp),
            "wo": P(pp), "mlp_norm": P(pp),
            "w_gate": P(pp, None, None, "tp"),
            "w_up": P(pp, None, None, "tp"),
            "w_down": P(pp, None, "tp", None),
        },
    }


def moe_param_specs(stage: bool = True) -> Dict[str, Any]:
    """The same for the MoE family: the expert dim of w1/w2 splits over
    'tp' (expert parallelism on the tp axis); attention, norms and the
    gate are replicated per stage."""
    pp = "pp" if stage else None
    return {
        "embed": P(), "pos": P(), "lnf_g": P(), "lnf_b": P(),
        "layers": {
            "ln1_g": P(pp), "ln1_b": P(pp),
            "wqkv": P(pp), "wo": P(pp),
            "ln2_g": P(pp), "ln2_b": P(pp),
            "gate": P(pp),
            "w1": P(pp, None, "tp"), "w2": P(pp, None, "tp"),
        },
    }


class _Family:
    """Model-family adapter: what make_loss_and_grads needs to run a
    family through the composition."""

    def __init__(self, block, embed, final, head, specs, tp_sharded,
                 has_aux=False):
        self.block = block            # (cfg, lp, h, tp_axis) -> h | (h, aux)
        self.embed = embed            # (params, cfg, tokens) -> x [...,S,d]
        self.final = final            # (params, ys) -> ys
        self.head = head              # (params) -> [vocab, d] logits matrix
        self.specs = specs            # () -> PartitionSpec tree
        self.tp_sharded = tp_sharded  # layer-leaf name -> bool
        self.has_aux = has_aux        # block returns (h, (balance, z))


def _family(cfg) -> _Family:
    """The family's adapter. Llama: its own embedding (no positions),
    final RMSNorm, untied head and tp-sharded SwiGLU leaves. GPT-2's; the
    MoE family shares its embedding, final norm, tied head and tp-sharded
    leaf names (w1, w2: the experts)."""
    if isinstance(cfg, lm.LlamaConfig):
        return _Family(
            block=_llama_block_sp_tp,
            embed=lambda p, c, t: p["embed"][t].to(c.dtype),
            final=lambda p, ys: lm.rmsnorm(ys, p["final_norm"]),
            head=lambda p: p["unembed"],
            specs=llama_param_specs,
            tp_sharded=lambda k: k in ("w_gate", "w_up", "w_down"),
        )
    moe = isinstance(cfg, mtf.MoeTransformerConfig)
    if not moe and not isinstance(cfg, tfm.TransformerConfig):
        raise TypeError(f"{type(cfg).__name__}: no model family trains "
                        f"with this config")
    return _Family(
        block=_moe_block_sp_tp if moe else _block_sp_tp,
        embed=lambda p, c, t: (p["embed"][t] +
                               p["pos"][:t.shape[-1]]).to(c.dtype),
        final=lambda p, ys: tfm.layernorm(ys, p["lnf_g"], p["lnf_b"]),
        head=lambda p: p["embed"],
        specs=moe_param_specs if moe else param_specs,
        tp_sharded=lambda k: k in ("w1", "b1", "w2"),
        has_aux=moe,
    )


def step_specs(cfg, n_virtual: int = 1) -> Dict[str, Any]:
    """The layout of the train step's parameters for ``cfg``'s family: its
    specs, with the chunk axis after 'pp' on the layer leaves when
    ``n_virtual > 1`` (the JAX step's rule)."""
    specs = _family(cfg).specs()
    if n_virtual > 1:
        specs = dict(specs, layers={k: P(s[0], None, *s[1:])
                                    for k, s in specs["layers"].items()})
    return specs


def _map(fn, tree, specs):
    return {k: _map(fn, v, specs[k]) if isinstance(v, dict)
            else fn(v, specs[k]) for k, v in tree.items()}


def _split(spec, mesh_shape):
    """(dim, axis) of every dimension that ``spec`` splits over an axis
    larger than 1."""
    return [(i, a) for i, a in enumerate(spec)
            if a is not None and mesh_shape[a] > 1]


def _shard(x, spec, mesh):
    """This rank's block of the global tensor ``x`` laid out by ``spec``
    (a copy of its own: contiguous, detached, with ``x``'s
    ``requires_grad``)."""
    for dim, axis in _split(spec, mesh.shape):
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {axis}={n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[axis] * size, size)
    return x.detach().clone().requires_grad_(x.requires_grad)


def shard_params(params, specs, mesh):
    """This rank's shard of the stage-sliced global parameters (``specs``
    from :func:`step_specs`): what its train step takes."""
    return _map(lambda x, spec: _shard(x, spec, mesh), params, specs)


def shard_batch(tokens, mesh):
    """This rank's shard of a global ``[n_micro, micro_batch, S]`` batch:
    the JAX step's ``P(None, "dp")``, each dp rank its block of the
    micro-batch axis."""
    return _shard(torch.as_tensor(tokens), P(None, "dp"), mesh)


def unshard_params(shards, specs, mesh_shape):
    """The inverse of :func:`shard_params`: the global tree from the
    ranks' shards, ``shards[rank]`` being rank ``rank``'s tree. Of each
    leaf only the blocks of the ranks whose coordinates are 0 on every
    axis that does not split it are read (rank 0's always), so the other
    ranks' entries may be missing. ``mesh_shape`` maps axis names to
    sizes, in the mesh's order."""
    names = list(mesh_shape)
    strides = {a: math.prod(mesh_shape[b] for b in names[i + 1:])
               for i, a in enumerate(names)}
    first = shards[0]

    def leaf_of(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def build(path, spec):
        split = _split(spec, mesh_shape)
        block = leaf_of(first, path)
        shape = list(block.shape)
        for dim, axis in split:
            shape[dim] *= mesh_shape[axis]
        out = block.new_empty(shape)
        for coords in itertools.product(
                *(range(mesh_shape[a]) for _, a in split)):
            rank = sum(strides[a] * c for (_, a), c in zip(split, coords))
            view = out
            part = leaf_of(shards[rank], path)
            for (dim, _), c in zip(split, coords):
                view = view.narrow(dim, c * part.shape[dim], part.shape[dim])
            view.copy_(part.detach())
        return out

    def walk(tree, sp, path):
        return {k: walk(v, sp[k], path + (k,)) if isinstance(v, dict)
                else build(path + (k,), sp[k]) for k, v in tree.items()}

    return walk(first, specs, ())


def param_leaves(params):
    """The parameter tensors of a (nested) parameter dict, in its order:
    what to build a ``torch.optim`` optimizer over for
    :func:`make_train_step_optim`."""
    out = []
    for v in params.values():
        out.extend(param_leaves(v) if isinstance(v, dict) else [v])
    return out


def _rebuild(tree, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it)
            for k, v in tree.items()}


def make_loss_and_grads(cfg, mesh, n_micro: int, n_virtual: int = 1,
                        remat: bool = False,
                        dp_quant_bits: int | None = None,
                        aux_weight: float = 1e-2, z_weight: float = 1e-3,
                        schedule: str = "gpipe",
                        xent_chunk: int | None = None, device=None):
    """Builds ``(params, tokens, targets) -> (loss, grads)`` over a
    ('dp', 'pp', 'tp') mesh — the core every optimizer shares — and
    returns it with the number of pipeline stages. Every rank of the mesh
    calls it with its own shards.

    ``params`` must be this rank's shard (:func:`shard_params` over
    :func:`step_specs`) of ``stage_slice(params, n_stages)`` on ``device``
    (``None`` means the GPU), or of ``stage_slice_interleaved(params,
    n_stages, n_virtual)`` when ``n_virtual > 1`` selects the interleaved
    pipeline (needs n_micro % pp == 0); tokens/targets are this rank's
    ``[n_micro, micro_batch / dp, S]`` integers (:func:`shard_batch`).
    ``grads`` has the structure of ``params``, reduced as the JAX step
    reduces them (equal on the ranks that hold the same shard); the loss
    is a detached f32 scalar, the mean over the global batch.
    ``xent_chunk`` selects the chunked-vocab CE (ops/xent.py).

    ``dp_quant_bits=8`` replaces the exact dp-gradient pmean with the int8
    ring all-reduce of :func:`parallel.quantized.quantized_pmean` (about
    4x fewer bytes on the dp axis, at under 1% gradient error).

    ``remat=True`` runs each layer body under
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant, without early
    stop, so that the recompute runs every collective of the layer on
    every rank): its activations are recomputed in the backward instead of
    kept, the same function for about a third more work, so each layer's
    attention kernel and collectives run again in the recompute.

    ``schedule="1f1b"`` replaces autograd through the pipeline with the
    1F1B slot engine (:func:`parallel.pipeline._pipeline_1f1b_engine`):
    each microbatch's forward runs without autograd and banks its stage
    input, and its backward re-runs the stage from that input and
    back-propagates at once, so the activations alive do not grow with
    n_micro. The same loss and gradients as GPipe; it composes with
    ``n_virtual > 1`` (interleaved 1F1B) and with ``remat``.

    ``cfg`` selects the family (``transformer.TransformerConfig``,
    ``llama.LlamaConfig`` or ``moe_transformer.MoeTransformerConfig``);
    at n_micro = 1 the loss equals the family's ``loss_fn``. For MoE the
    loss is CE + ``aux_weight`` * load-balance + ``z_weight`` * router-z,
    the router losses carried through the pipeline
    (``pipeline_forward(with_aux=True)``; under 1F1B seeded in each
    backward) and normalized per router call, one per (layer,
    microbatch). GPT-2 and Llama ignore the weights."""
    dev = resolve_device(device)
    if n_virtual < 1:
        raise ValueError(f"n_virtual={n_virtual}: need at least 1")
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if dp_quant_bits not in (None, 8):
        raise ValueError(f"dp_quant_bits={dp_quant_bits}: int8 (8) is the "
                         f"quantized sync's one wire format")
    fam = _family(cfg)
    n_stages = mesh.shape["pp"]
    # Only across ranks does a collective move data. There remat's
    # recompute re-runs the whole layer (early stop off) from outputs on
    # the tape, so every rank issues the same backward collectives; on one
    # rank it is torch's plain checkpoint (and the tape records nothing).
    multi_rank = any(n > 1 for n in mesh.shape.values())
    if isinstance(cfg, mtf.MoeTransformerConfig) and \
            cfg.n_experts % mesh.shape["tp"]:
        raise ValueError(f"n_experts ({cfg.n_experts}) must divide by the "
                         f"'tp' mesh axis ({mesh.shape['tp']}): experts "
                         f"split over tp")

    def ll_sum(head_mat, ys_blk, tg_blk):
        """Summed target log-likelihood of a rank's exclusive slice."""
        if xent_chunk is None:
            logits = ys_blk.float() @ head_mat.T
            logp = torch.log_softmax(logits, dim=-1)
            return logp.gather(-1, tg_blk[..., None]).sum()
        d = ys_blk.shape[-1]
        return chunked_xent_ll(ys_blk.reshape(-1, d), head_mat,
                               tg_blk.reshape(-1), xent_chunk).sum()

    def reduce_grad(g, tp_sharded: bool, pp_sharded: bool):
        """pmean over dp, psum over every axis the leaf is replicated on,
        nothing over the axes it is sharded on."""
        if dp_quant_bits is not None:
            g = quantized_pmean(g, "dp", dp_quant_bits)
        else:
            g = col.pmean(g, "dp")
        if not tp_sharded:
            g = col.psum(g, "tp")
        if not pp_sharded:
            g = col.psum(g, "pp")
        return g

    def layer_fn(lp, h):
        if not remat:
            return fam.block(cfg, lp, h, "tp")
        if not multi_rank:
            return checkpoint(fam.block, cfg, lp, h, "tp",
                              use_reentrant=False)
        with set_checkpoint_early_stop(False):
            out = checkpoint(fam.block, cfg, lp, h, "tp",
                             use_reentrant=False)
        # Every output of the layer on the tape: each rank back-propagates
        # into it from the same outputs, so the recompute (with its
        # collectives) starts at the same point on every rank.
        col.retain(*(out if isinstance(out, tuple) else (out,)))
        return out

    def stage_fn(stage_layers, h):
        n = next(iter(stage_layers.values())).shape[0]
        lb = rz = h.new_zeros((), dtype=torch.float32)   # MoE router losses
        for i in range(n):
            h = layer_fn({k: a[i] for k, a in stage_layers.items()}, h)
            if fam.has_aux:
                h, (b_lb, b_rz) = h
                lb, rz = lb + b_lb, rz + b_rz
        return (h, (lb, rz)) if fam.has_aux else h

    def loss_fn(params, tokens, targets):
        # Every rank scores only its exclusive slice — its tp sequence
        # block, on the last pipeline stage — and psum assembles the sum,
        # so every parameter's cotangent path is unique.
        S = tokens.shape[-1]
        x = fam.embed(params, cfg, tokens)             # [M, mbl, S, d]
        if n_virtual > 1:
            ys = pipeline_forward_interleaved(
                stage_fn, params["layers"], x, "pp", n_virtual,
                with_aux=fam.has_aux)
        else:
            ys = pipeline_forward(stage_fn, params["layers"], x, "pp",
                                  with_aux=fam.has_aux)
        if fam.has_aux:
            ys, aux = ys
        tpn = col.axis_size("tp")
        ti = col.axis_index("tp")
        si = col.axis_index("pp")
        blk = S // tpn
        with profiling.annotate("acx.train.head"):
            ys = fam.final(params, ys)
            ys_blk = ys[:, :, ti * blk:(ti + 1) * blk]
            tg_blk = targets[:, :, ti * blk:(ti + 1) * blk]
            contrib = (ll_sum(fam.head(params), ys_blk, tg_blk)
                       if si == n_stages - 1
                       else ys.new_zeros((), dtype=torch.float32))
        total = col.psum(contrib, ("pp", "tp"))
        if not fam.has_aux:
            return -total / tokens.numel()
        # The router losses are replicated over tp: only tp rank 0 adds
        # them (the other ranks' weigh 0, as JAX's where gives: every rank
        # keeps the same graph), and the psum sums every stage's once. One
        # router call per (layer, microbatch).
        gate = float(ti == 0)
        lb, rz = (col.psum(a * gate, ("pp", "tp")) for a in aux)
        calls = cfg.n_layers * tokens.shape[0]
        return (-total / tokens.numel()
                + (aux_weight * lb + z_weight * rz) / calls)

    def reduce_all(grads):
        out = {k: reduce_grad(g, False, False)
               for k, g in grads.items() if k != "layers"}
        out["layers"] = {k: reduce_grad(g, fam.tp_sharded(k), True)
                         for k, g in grads["layers"].items()}
        return {k: out[k] for k in grads}

    def gpipe(params, tokens, targets):
        # Detached aliases that require grad: the caller's tensors are
        # left as they are, and may be updated in place afterwards.
        live = _rebuild(params, iter(
            p.detach().requires_grad_() for p in param_leaves(params)))
        # Every rank back-propagates through every collective it ran
        # (collective.tape); a leaf this rank's stage does not read (the
        # embedding past stage 0, the head before the last) gets zeros.
        with col.tape(tokens.device) as tp:
            with profiling.annotate("acx.train.forward"):
                loss = tp.sink(loss_fn(live, tokens, targets))
        with profiling.annotate("acx.train.backward"):
            flat = torch.autograd.grad(
                loss, param_leaves(live) + [tp.leaf], allow_unused=True,
                materialize_grads=True)[:-1]
        # The JAX step undoes the pp*tp scaling that its loss-assembly
        # psum puts on every cotangent; kept for the same structure.
        group = col.axis_size("pp") * col.axis_size("tp")
        grads = _rebuild(params, iter(g / group for g in flat))
        return col.pmean(loss.detach(), "dp"), reduce_all(grads)

    def one_f_one_b(params, tokens, targets):
        """The 1F1B counterpart of ``gpipe`` over the slot engine: the
        tail (final norm and head) loss at the last global stage, the
        embedding's backward at global stage 0, and the MoE router-aux
        seeds gated to tp rank 0 (the exclusive-path rule)."""
        M, mbl, S = tokens.shape
        ti = col.axis_index("tp")
        blk = S // col.axis_size("tp")
        n_tok = M * mbl * S
        calls = cfg.n_layers * M
        chunks = {k: p[0] for k, p in params["layers"].items()}
        if n_virtual == 1:
            chunks = {k: p[None] for k, p in chunks.items()}  # chunk axis
        tail = {k: v for k, v in params.items() if k != "layers"}
        with torch.no_grad():
            x_all = fam.embed(params, cfg, tokens)     # [M, mbl, S, d]

        def tail_grads(fn, cotangent):
            """``(fn(leaves), d fn / d leaves)`` over fresh leaves of the
            tail parameters (zeros for a leaf ``fn`` does not read)."""
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_()
                          for k, v in tail.items()}
                val, wrt = fn(leaves)
                gs = torch.autograd.grad(val, list(leaves.values()) + wrt,
                                         cotangent, allow_unused=True)
            d_tail = {k: torch.zeros_like(v) if g is None else g
                      for (k, v), g in zip(leaves.items(), gs)}
            return val.detach(), d_tail, gs[len(leaves):]

        def loss_side(y, m):
            yy = y.detach().requires_grad_()

            def ll(tp_):
                # This rank's exclusive share of microbatch m: its tp
                # block of the sequence.
                ys = fam.final(tp_, yy)
                sl = slice(ti * blk, (ti + 1) * blk)
                return ll_sum(fam.head(tp_), ys[:, sl],
                              targets[m][:, sl]), [yy]

            seed = torch.tensor(-1.0 / n_tok, dtype=torch.float32,
                                device=y.device)
            llsum, d_tail, (dy,) = tail_grads(ll, seed)
            return llsum, d_tail, dy.to(y.dtype)

        def embed_side(dx, m):
            return tail_grads(lambda tp_: (fam.embed(tp_, cfg, tokens[m]),
                                           []), dx.to(x_all.dtype))[1]

        aux_seed = aux_gate = None
        if fam.has_aux:
            gate = float(ti == 0)
            aux_seed = (aux_weight / calls * gate, z_weight / calls * gate)
            aux_gate = ti == 0
        lacc, aux_acc, gl, gt = _pipeline_1f1b_engine(
            stage_fn, chunks, x_all, "pp", n_virtual, loss_side=loss_side,
            zero_head=tail, embed_side=embed_side, aux_seed=aux_seed,
            aux_gate=aux_gate, lockstep=True)
        loss = -col.psum(lacc, ("pp", "tp")) / n_tok
        if fam.has_aux:
            lb, rz = (col.psum(a, ("pp", "tp")) for a in aux_acc)
            loss = loss + (aux_weight * lb + z_weight * rz) / calls
        # The chunk axis of one chunk stands where the stage axis goes;
        # interleaved grads gain the stage axis. These are the true local
        # grads (seeded exclusively, no assembly psum to undo).
        grads = dict(gt, layers={k: g if n_virtual == 1 else g[None]
                                 for k, g in gl.items()})
        return col.pmean(loss, "dp"), reduce_all(
            {k: grads[k] for k in params})

    body = one_f_one_b if schedule == "1f1b" else gpipe

    def grad_fn(params, tokens, targets):
        tfm.check_device(params, dev)
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        with mesh, torch.enable_grad():
            return body(params, tokens, targets)

    return grad_fn, n_stages


def make_train_step(cfg, mesh, n_micro: int,
                    lr: float = 1e-2, n_virtual: int = 1, remat: bool = False,
                    dp_quant_bits: int | None = None,
                    aux_weight: float = 1e-2, z_weight: float = 1e-3,
                    schedule: str = "gpipe", xent_chunk: int | None = None,
                    device=None):
    """``(params, tokens, targets) -> (loss, params)`` SGD step. The
    parameters are updated **in place** (``p -= lr * g``) and returned.
    Returns ``(step, n_stages)``; see :func:`make_loss_and_grads`."""
    grad_fn, n_stages = make_loss_and_grads(
        cfg, mesh, n_micro, n_virtual=n_virtual, remat=remat,
        dp_quant_bits=dp_quant_bits, aux_weight=aux_weight,
        z_weight=z_weight, schedule=schedule, xent_chunk=xent_chunk,
        device=device)

    def step(params, tokens, targets):
        loss, grads = grad_fn(params, tokens, targets)
        with torch.no_grad():
            for p, g in zip(param_leaves(params), param_leaves(grads)):
                p.sub_(lr * g)
        return loss, params

    return step, n_stages


def make_train_step_optim(cfg, mesh, n_micro: int,
                          optimizer: torch.optim.Optimizer,
                          n_virtual: int = 1, remat: bool = False,
                          dp_quant_bits: int | None = None,
                          aux_weight: float = 1e-2, z_weight: float = 1e-3,
                          schedule: str = "gpipe",
                          xent_chunk: int | None = None, device=None):
    """The train step with a ``torch.optim`` optimizer (the counterpart of
    the JAX package's ``make_train_step_optax``).

    ``optimizer`` must hold exactly the parameter tensors of the params
    the step is given (build it over :func:`param_leaves`). Returns
    ``(step, n_stages)``: ``step(params, tokens, targets) -> (loss,
    params)``, the parameters updated **in place** by
    ``optimizer.step()``; the optimizer keeps its own state."""
    grad_fn, n_stages = make_loss_and_grads(
        cfg, mesh, n_micro, n_virtual=n_virtual, remat=remat,
        dp_quant_bits=dp_quant_bits, aux_weight=aux_weight,
        z_weight=z_weight, schedule=schedule, xent_chunk=xent_chunk,
        device=device)
    held = {id(p) for group in optimizer.param_groups
            for p in group["params"]}

    def step(params, tokens, targets):
        leaves = param_leaves(params)
        if {id(p) for p in leaves} != held:
            raise ValueError("the optimizer does not hold exactly these "
                             "parameters (build it over param_leaves)")
        loss, grads = grad_fn(params, tokens, targets)
        for p, g in zip(leaves, param_leaves(grads)):
            p.grad = g
        with profiling.annotate("acx.train.optimizer"):
            optimizer.step()
        for p in leaves:
            p.grad = None
        return loss, params

    return step, n_stages
