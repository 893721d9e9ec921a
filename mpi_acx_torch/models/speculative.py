"""Speculative decoding (the JAX package's ``models/speculative.py``): a
small draft model proposes, the target model verifies k tokens in one
window pass.

Each round the draft runs k cached steps from the pending token (the k-th
only seats its cache row), the target scores the pending token and the
k-1 proposals in one k-wide window pass (one read of its weights for up
to k emitted tokens), and a ``decide`` hook keeps the accepted prefix and
adds the target's next token. Greedy acceptance (:func:`speculative_generate`)
emits the target's own greedy tokens, up to floating-point argmax ties
between the window pass and the one-token step; the accept/resample rule
(:func:`speculative_sample`) emits tokens distributed exactly as the
target's samples. Both KV caches keep their stale rows past a rejection:
the pass that next takes those positions rewrites them before any query
can see them.

The JAX package compiles one ``lax.while_loop`` a row and lifts it over B
rows with ``vmap``. Here one Python loop runs all B rows together: the
draft steps and the target's window pass take per-row positions ``pos
[B]`` (so the window pass runs K2 with W = k on every slot at its own
position), each round reads the rows' accepted counts to the host once,
and a row that has its ``n_new`` tokens is frozen: its buffer, counters
and pending token stop changing and its caches park at position 0 while
the others run on. Each row's tokens and stats are those of its own B = 1
run. Random draws are explicit tensors the loop draws from each row's
generator (per round: the k draft steps' Gumbel noise, then ``decide``'s
k-1 uniforms and its Gumbel noise), so the hooks can be fed any draws,
the JAX package's included.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.models import llama as lm
from mpi_acx_torch.models import moe_transformer as mtf
from mpi_acx_torch.models import transformer as tfm
from mpi_acx_torch.models.decoding import (check_key, decode_layer_scan,
                                           gumbel, grouped_decode_attend,
                                           split_generator)
from mpi_acx_torch.ops.wquant import wread


def _positions(pos, W):
    """The window's positions: [1, W] for a scalar ``pos``, [B, W] for
    ``pos [B]``."""
    return pos.reshape(-1, 1) + torch.arange(W, device=pos.device)


def _window_pass_llama(params, cfg, cache, tokens):
    """Llama's window pass: RoPE at each row's window positions and
    grouped-query attention (K2 with W = tokens.shape[1]) against the
    un-repeated cache; returns (logits [B, W, vocab] f32, cache with pos
    advanced by W)."""
    W = tokens.shape[1]
    pos = cache["pos"]
    max_len = cache["k"].shape[2]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    x = params["embed"][tokens].to(cfg.dtype)
    positions = _positions(pos, W)

    def qkv_fn(lp, x, _pos):
        return lm._qkv(cfg, lp, x, positions)

    def attend_fn(lp, x, q, kc, vc, _pos):
        o = grouped_decode_attend(q, kc, vc, pos, max_len, n_rep,
                                  flash=cfg.decode_flash)
        return lm._mlp(cfg, lp, x + o @ wread(lp, "wo", x.dtype))

    x, ks, vs = decode_layer_scan(params["layers"], x, cache["k"],
                                  cache["v"], pos, qkv_fn, attend_fn)
    x = lm.rmsnorm(x, params["final_norm"])
    return tfm._unembed(x, params["unembed"]), {"k": ks, "v": vs,
                                                 "pos": pos + W}


def _window_pass(params, cfg, cache, tokens, ffn=None):
    """GPT-2's window pass: tokens [B, W] at positions pos..pos+W-1 (a
    scalar or one per row) against the cache; row w attends entries <=
    pos + w, this window's rows written before they are read. Returns
    (logits [B, W, vocab] f32, cache with pos advanced by W). ``ffn(cfg,
    lp, x) -> x`` replaces the feed-forward half, as on
    ``transformer.prefill``/``decode_step``."""
    ffn = ffn or tfm._mlp
    W = tokens.shape[1]
    pos = cache["pos"]
    max_len = cache["k"].shape[2]
    # The position rows start where lax.dynamic_slice would: clamped so
    # the W rows fit the table.
    rows = _positions(pos.clamp(0, cfg.max_seq - W), W)
    x = (params["embed"][tokens] + params["pos"][rows]).to(cfg.dtype)

    def qkv_fn(lp, x, _pos):
        return tfm._qkv(cfg, lp, x)

    def attend_fn(lp, x, q, kc, vc, _pos):
        o = grouped_decode_attend(q, kc, vc, pos, max_len, n_rep=1,
                                  flash=cfg.decode_flash)
        return ffn(cfg, lp, x + o @ wread(lp, "wo", x.dtype))

    x, ks, vs = decode_layer_scan(params["layers"], x, cache["k"],
                                  cache["v"], pos, qkv_fn, attend_fn)
    x = tfm.layernorm(x, params["lnf_g"], params["lnf_b"])
    return tfm._unembed(x, params["embed"]), {"k": ks, "v": vs,
                                              "pos": pos + W}


def _rowwise_moe_ffn(cfg, lp, x):
    """The routed FFN with each row's tokens as one dispatch group: a B = 1
    run's routing, row by row (JAX's ``vmap`` of the B = 1 loop routes
    this way)."""
    return torch.cat([mtf._moe_ffn(cfg, lp, x[b:b + 1])
                      for b in range(x.shape[0])])


def _family_ops(cfg):
    """(prefill, decode_step, window_pass) for a config's model family."""
    if isinstance(cfg, lm.LlamaConfig):
        return lm.prefill, lm.decode_step, _window_pass_llama
    if isinstance(cfg, mtf.MoeTransformerConfig):
        # GPT-2's scaffold with the routed FFN in every pass.
        ffn = _rowwise_moe_ffn
        return (functools.partial(tfm.prefill, ffn=ffn),
                functools.partial(tfm.decode_step, ffn=ffn),
                functools.partial(_window_pass, ffn=ffn))
    if isinstance(cfg, tfm.TransformerConfig):
        return tfm.prefill, tfm.decode_step, _window_pass
    raise TypeError(
        f"speculative decoding supports the GPT-2, Llama, and "
        f"MoE-transformer families; got {type(cfg).__name__}")


def _row_draws(gens, active, shape, draw):
    """One draw of ``shape`` from each active row's generator (zeros for a
    frozen row), stacked [B, *shape]; None when the loop is greedy."""
    if gens is None:
        return None
    return torch.stack([draw(shape, g) if a else
                        torch.zeros(shape, device=g.device)
                        for g, a in zip(gens, active)])


def _uniform(shape, key):
    return torch.rand(shape, generator=key, device=key.device)


def _make_run(draft_cfg, cfg, S, n_new, k, pick0, draft_pick, decide,
              ops=None):
    """The speculative round loop shared by the greedy and sampled
    variants, which differ only in three hooks:

    pick0(logits [B, V], g [B, V]) -> pending [B]       (first token)
    draft_pick(lg [B, V], g [B, V]) -> nxt [B]          (a proposal)
    decide(props [B, k-1], q_logits [B, k-1, V], p_logits [B, k, V],
           u [B, k-1], g [B, V]) -> (emit [B, k], m [B], pending [B])

    ``g`` is standard Gumbel noise and ``u`` uniform in [0, 1), drawn by
    the loop from each row's generator (``None`` in a greedy run). The
    family operations follow each config's type unless ``ops`` = (t_prefill,
    t_window, d_prefill, d_decode) gives them, with the family signatures
    (params first): the tensor-parallel builder
    (``parallel/tp_inference.py``) passes its per-rank operations here.
    Returns
    ``run(draft_params, params, prompt [B, S], gens)`` -> ``(tokens [B, S +
    n_new], rounds [B], accepted [B])`` (host tensors), ``gens`` one
    generator a row or None.

    Cache rules: the draft runs k steps so a fully accepted round leaves
    no unwritten cache row; stale rows sit at or past the rolled-back
    position and are rewritten before any query sees them; buffer entries
    past a row's accepted tokens are overwritten next round or cut by the
    final ``buf[:, :S + n_new]``."""
    cap = S + n_new + k                      # overshoot slack, last round
    if cap > cfg.max_seq or cap > draft_cfg.max_seq:
        raise ValueError(f"prompt {S} + n_new {n_new} + k {k} = {cap} "
                         f"exceeds max_seq ({cfg.max_seq}, draft "
                         f"{draft_cfg.max_seq})")
    if ops is None:
        t_prefill, _, t_window = _family_ops(cfg)
        d_prefill, d_decode, _ = _family_ops(draft_cfg)
    else:
        t_prefill, t_window, d_prefill, d_decode = ops

    def run(draft_params, params, prompt, gens):
        B, dev = prompt.shape[0], prompt.device
        t_logits, t_cache = t_prefill(params, cfg, prompt, cap,
                                      last_only=True)
        _, d_cache = d_prefill(draft_params, draft_cfg, prompt, cap,
                               last_only=True)
        V = t_logits.shape[-1]
        active = [True] * B
        pending = pick0(t_logits[:, -1],
                        _row_draws(gens, active, (V,), gumbel)
                        ).to(prompt.dtype)
        buf = torch.zeros((B, cap), dtype=prompt.dtype, device=dev)
        buf[:, :S] = prompt
        buf[:, S] = pending
        # By the decode convention the pending token sits at position
        # S + n - 1 and is in no cache yet.
        n, rounds, acc = [1] * B, [0] * B, [0] * B
        steps = torch.arange(k, device=dev)
        active = [x < n_new for x in n]
        while any(active):
            act = torch.tensor(active, device=dev)
            # Frozen rows park at position 0 and run along, masked.
            pos = torch.tensor([S + x - 1 if a else 0
                                for x, a in zip(n, active)],
                               dtype=torch.int32, device=dev)
            d_cache = dict(d_cache, pos=pos)
            t_cache = dict(t_cache, pos=pos)
            tok, props, q_logits = pending, [], []
            for _ in range(k):
                lg, d_cache = d_decode(draft_params, draft_cfg, d_cache,
                                       tok)
                tok = draft_pick(lg, _row_draws(gens, active, (V,), gumbel)
                                 ).to(prompt.dtype)
                props.append(tok)
                q_logits.append(lg)
            props = torch.stack(props[:k - 1], dim=1)           # [B, k-1]
            window = torch.cat([pending[:, None], props], dim=1)  # [B, k]
            t_logits, t_cache = t_window(params, cfg, t_cache, window)
            emit, m, nxt = decide(
                props, torch.stack(q_logits[:k - 1], dim=1), t_logits,
                _row_draws(gens, active, (k - 1,), _uniform),
                _row_draws(gens, active, (V,), gumbel))
            m_host = m.tolist()              # the round's one host read
            rows = [b for b in range(B) if active[b]]
            idx = torch.tensor(rows, device=dev)
            cols = torch.tensor([S + n[b] for b in rows], device=dev)
            buf[idx[:, None], cols[:, None] + steps] = emit[idx].to(
                prompt.dtype)
            pending = torch.where(act, nxt.to(prompt.dtype), pending)
            for b in rows:
                n[b] += m_host[b] + 1
                rounds[b] += 1
                acc[b] += m_host[b]
            active = [x < n_new for x in n]
        return buf[:, :S + n_new], torch.tensor(rounds), torch.tensor(acc)

    return run


def _greedy_hooks(k: int):
    """(pick0, draft_pick, decide) for greedy speculation: argmax
    proposals, the longest prefix matching the target's argmax chain
    accepted, the target's argmax as the bonus or correction. The draws
    are ignored."""
    def pick0(logits, g):
        return logits.argmax(dim=-1)

    def draft_pick(lg, g):
        return lg.argmax(dim=-1)

    def decide(props, q_logits, t_logits, u, g):
        targets = t_logits.argmax(dim=-1).to(props.dtype)       # [B, k]
        matches = props == targets[:, :k - 1]
        m = torch.cat([matches, matches.new_zeros(matches.shape[0], 1)],
                      dim=1).to(torch.int32).argmin(dim=-1)
        # Emitted: targets[0..m] (accepted proposals equal the target's
        # chain; targets[m] is the bonus or the correction).
        return targets, m, targets.gather(1, m[:, None])[:, 0]

    return pick0, draft_pick, decide


def _sample_hooks(k: int, temperature: float):
    """(pick0, draft_pick, decide) for stochastic speculation (the
    accept/resample rule of Leviathan et al. and Chen et al.): proposals
    sampled from the draft at ``temperature`` (Gumbel-max over
    ``logits / temperature``), each accepted when ``u * q(x) < p(x)``
    under the target's distribution p and the draft's q; on a rejection
    the token is drawn from ``normalize(max(p - q, 0))``, at full
    acceptance from p. Every emitted token is then distributed exactly as
    the target's own samples at ``temperature``."""
    if not temperature > 0.0:
        raise ValueError(f"temperature {temperature} must be > 0")
    inv_t = 1.0 / temperature

    def pick0(logits, g):
        return (logits * inv_t + g).argmax(dim=-1)

    def draft_pick(lg, g):
        return (lg * inv_t + g).argmax(dim=-1)

    def decide(props, q_logits, t_logits, u, g):
        B = props.shape[0]
        rows = torch.arange(B, device=props.device)
        q = torch.softmax(q_logits * inv_t, dim=-1)            # [B, k-1, V]
        p = torch.softmax(t_logits * inv_t, dim=-1)            # [B, k, V]
        idx = props.long()[..., None]
        p_x = p[:, :k - 1].gather(2, idx)[..., 0]
        q_x = q.gather(2, idx)[..., 0]
        accept = u * q_x < p_x                                  # [B, k-1]
        m = torch.cat([accept, accept.new_zeros(B, 1)],
                      dim=1).to(torch.int32).argmin(dim=-1)     # accepted
        p_m = p[rows, m]
        q_m = q[rows, m.clamp(max=k - 2)]
        residual = torch.where((m < k - 1)[:, None],
                               (p_m - q_m).clamp_min(0.0), p_m)
        # An all-zero residual (p <= q everywhere, numerically) falls back
        # to p_m: the right distribution when p == q.
        residual = torch.where(residual.sum(-1, keepdim=True) > 0,
                               residual, p_m)
        y = (torch.log(residual + 1e-30) + g).argmax(dim=-1)
        emit = torch.cat([props, props.new_zeros(B, 1)], dim=1)
        emit[rows, m] = y.to(props.dtype)
        return emit, m, y

    return pick0, draft_pick, decide


def _check_moe_target(cfg):
    """An MoE target must route drop-free: the window pass routes k tokens
    as one dispatch group where the one-token step routes 1, so with
    tight capacity a popular expert could drop a token in one pass and not
    the other. ``capacity_factor >= n_experts`` seats every token. An MoE
    draft needs no guard: it shapes acceptance, never what is emitted."""
    if (isinstance(cfg, mtf.MoeTransformerConfig)
            and cfg.capacity_factor < cfg.n_experts):
        raise ValueError(
            f"MoE speculative target needs drop-free routing "
            f"(capacity_factor {cfg.capacity_factor} < n_experts "
            f"{cfg.n_experts}); see moe_transformer.decode_step")


def _prepare(draft_params, draft_cfg, params, cfg, prompt, k, device):
    if k < 2:
        raise ValueError(f"k = {k}: a round needs at least one proposal")
    if draft_cfg.vocab != cfg.vocab:
        raise ValueError(f"draft/target vocabularies differ "
                         f"({draft_cfg.vocab} vs {cfg.vocab}): acceptance "
                         f"would be meaningless")
    _check_moe_target(cfg)
    dev = resolve_device(device)
    tfm.check_device(params, dev)
    tfm.check_device(draft_params, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    if prompt.ndim != 2:
        raise ValueError(f"prompt [B, S], got {tuple(prompt.shape)}")
    return dev, prompt


def _stats(rounds, acc):
    """JAX's stats: scalars at B = 1, [B] vectors above."""
    if rounds.numel() == 1:
        rounds, acc = rounds[0], acc[0]
    return {"rounds": rounds, "drafted_accepted": acc}


def speculative_sample(
    draft_params, draft_cfg, params, cfg, prompt, n_new: int,
    key: torch.Generator, k: int = 4, temperature: float = 1.0,
    device=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stochastic speculative decode: the rounds of
    :func:`speculative_generate` with sampled proposals and the
    accept/resample rule, so every emitted token follows the target's
    sampling distribution at ``temperature``; the draft changes only the
    number of rounds. ``key`` is a ``torch.Generator`` on ``device``
    (``None`` means the GPU). At B = 1 the row draws from ``key``; at B >
    1 row b draws from ``decoding.split_generator(key, B)[b]``, so each
    row equals the B = 1 run with that generator. Returns ``(tokens,
    stats)`` as :func:`speculative_generate`."""
    dev, prompt = _prepare(draft_params, draft_cfg, params, cfg, prompt, k,
                           device)
    check_key(key, dev)
    B, S = prompt.shape
    run = _make_run(draft_cfg, cfg, S, n_new, k,
                    *_sample_hooks(k, float(temperature)))
    gens = [key] if B == 1 else split_generator(key, B)
    tokens, rounds, acc = run(draft_params, params, prompt, gens)
    return tokens, _stats(rounds, acc)


def speculative_generate(
    draft_params, draft_cfg, params, cfg, prompt, n_new: int, k: int = 4,
    device=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Greedy speculative decode on ``device`` (``None`` means the GPU;
    both parameter trees must be there).

    ``cfg``/``draft_cfg`` select each model's family by config type
    (GPT-2 ``TransformerConfig``, ``LlamaConfig`` or
    ``MoeTransformerConfig``; an MoE target must route drop-free, see
    :func:`_check_moe_target`); the families may differ, the vocabularies
    may not. Returns ``(tokens [B, S + n_new], stats)``: each row of
    tokens equals the target family's ``generate`` on that row (up to
    argmax ties between the window pass and the one-token step), and
    ``stats`` counts ``{"rounds": R, "drafted_accepted": A}``: the target
    ran R window passes where plain decoding runs n_new steps, and A of
    the R * (k - 1) proposals were accepted. At B = 1 both are scalars; at
    B > 1 they are [B] (host tensors) and each row's tokens and stats are
    those of its own B = 1 run (see the module docstring).

    Each round the draft takes k - 1 cached greedy steps from the pending
    token, the target scores the pending token and the proposals in one
    k-wide window pass, and the longest prefix of proposals matching the
    target's own argmax chain is emitted with the target's next token (the
    bonus, or the correction at a rejection): 1 to k tokens for one target
    pass and k draft steps."""
    dev, prompt = _prepare(draft_params, draft_cfg, params, cfg, prompt, k,
                           device)
    B, S = prompt.shape
    run = _make_run(draft_cfg, cfg, S, n_new, k, *_greedy_hooks(k))
    tokens, rounds, acc = run(draft_params, params, prompt, None)
    return tokens, _stats(rounds, acc)
