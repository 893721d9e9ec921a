"""Operations and bytes of the work the benchmark drives, from shapes alone.

A configuration's shapes come from :func:`dims` over its file. Every
count uses the real prompt and live lengths, never a padded bucket, and
counts a multiply-add as two operations. Bytes count each input byte
read once and each output byte written once.
"""

from __future__ import annotations

from dataclasses import dataclass

from acxbench.roofline import decode_bytes


@dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    gated: bool          # SwiGLU: three FFN products, else two

    @property
    def layer_matmul_params(self) -> int:
        """Weights of one layer's products (attention and FFN)."""
        q = self.d * self.heads * self.head_dim
        kv = 2 * self.d * self.kv_heads * self.head_dim
        o = self.heads * self.head_dim * self.d
        ffn = (3 if self.gated else 2) * self.d * self.ff
        return q + kv + o + ffn

    @property
    def head_params(self) -> int:
        return self.d * self.vocab


def dims(cfg: dict) -> Dims:
    """The shapes of a configuration file (GPT-2's or the Llama
    architecture's key names)."""
    if cfg["family"] == "gpt2":
        d, h = cfg["n_embd"], cfg["n_head"]
        return Dims(cfg["n_layer"], d, h, h, d // h,
                    cfg.get("n_inner") or 4 * d, cfg["vocab_size"], False)
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return Dims(cfg["num_hidden_layers"], d, h, cfg["num_key_value_heads"],
                cfg.get("head_dim") or d // h, cfg["intermediate_size"],
                cfg["vocab_size"], True)


def causal_pairs(S: int) -> int:
    """Query-key pairs a causal pass over S tokens scores."""
    return S * (S + 1) // 2


def attention_flops(dm: Dims, pairs: int) -> int:
    """QK^T and PV over ``pairs`` query-key pairs, every query head, one
    layer."""
    return 4 * dm.head_dim * dm.heads * pairs


def prefill_flops(dm: Dims, S: int) -> int:
    """A prompt pass of S real tokens: every layer's products and causal
    attention, and the head on the last position alone (as the servers
    run it)."""
    return (dm.layers * (2 * dm.layer_matmul_params * S
                         + attention_flops(dm, causal_pairs(S)))
            + 2 * dm.head_params)


def decode_flops(dm: Dims, pos: int) -> int:
    """One token at position ``pos`` (it attends pos + 1 keys)."""
    return (dm.layers * (2 * dm.layer_matmul_params
                         + attention_flops(dm, pos + 1))
            + 2 * dm.head_params)


def request_flops(dm: Dims, prompt_len: int, new_tokens: int) -> int:
    """A served request: its prefill (which emits the first token) and
    ``new_tokens - 1`` decode steps."""
    return prefill_flops(dm, prompt_len) + sum(
        decode_flops(dm, prompt_len + i) for i in range(new_tokens - 1))


def train_step_flops(dm: Dims, seqs: int, S: int) -> int:
    """Model FLOPs of one training step over ``seqs`` sequences of S
    tokens: forward products, causal attention and the head on every
    position, times three for the backward (no recompute)."""
    fwd = seqs * (dm.layers * (2 * dm.layer_matmul_params * S
                               + attention_flops(dm, causal_pairs(S)))
                  + 2 * dm.head_params * S)
    return 3 * fwd


def k1_cost(B: int, S: int, heads: int, head_dim: int, lse: bool = False,
            elem: int = 2):
    """(operations, bytes) of one causal flash-attention call over S real
    tokens: q, k, v read and o written at ``heads`` heads (the kernel's
    inputs, after any broadcast of KV groups), plus the f32 row
    logsumexp with ``lse``."""
    flops = 4 * head_dim * heads * B * causal_pairs(S)
    nbytes = 4 * B * S * heads * head_dim * elem + (
        B * heads * S * 4 if lse else 0)
    return flops, nbytes


def k2_cost(live: int, B: int, hq: int, hkv: int, head_dim: int):
    """(operations, bytes) of one decode attention call at W = 1 over
    ``live`` cached rows summed over the B slots (bf16 cache)."""
    return (4 * head_dim * hq * live,
            decode_bytes(live, B, False, False, hkv=hkv, hq=hq,
                         head_dim=head_dim))
