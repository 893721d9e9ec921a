"""How far the flash backward's own recipe is from exact, apart from any
kernel: chip_smoke's phase-2b backward check (dq, dk, dv at the training
shape, causal, random dO and dLSE) read at GPT-2's heads (H=12, D=64) and
Llama-3-8B's (H=32, D=128), in bf16 and in f32, for three paths against
autograd through the plain version in the same dtype and in f32:

* ``kernel``: K1's forward, then the blockwise backward (what the port
  trains through);
* ``recipe``: the plain forward, then the same blockwise backward on the
  plain forward's own output (the JAX package's backward, which reads the
  stored output O in D = rowsum(dO * O), with no kernel in it);
* ``plain``: autograd through the plain version (its row error against
  f32 only).

Each line gives the row errors of chip_smoke.errors (rms floor
GRAD_RMS_FLOOR) and the query row and head where the worst dq row lies.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/bwd_paths.py``."""
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from mpi_acx_torch.ops import attention as attn  # noqa: E402


def recipe(q, k, v, do, dlse=None):
    """The blockwise backward on the plain forward's own bf16 output."""
    if dlse is None:
        o, lse = attn.attention_reference(q, k, v), None
    else:
        o, lse = attn._reference_lse(q, k, v)
    bq, bk = attn._backward_blocks(q.shape[1], k.shape[1], 512, 512)
    grads = attn._flash_bwd_blockwise(*attn._to_bhsd(q, k, v, o, do), True,
                                      bq, bk, lse=lse, dlse=dlse)
    return attn._to_bhsd(*grads)


def worst_row(g, r32, floor):
    """(query row, head) of the largest row error of dq against f32."""
    d = (g.float() - r32.float()).abs().amax(-1)             # [B, S, H]
    rms = r32.float().square().mean(-1).sqrt().clamp(
        min=floor * r32.float().square().mean().sqrt().item())
    idx = int((d / rms).argmax())
    B, S, H = d.shape
    return idx // H % S, idx % H


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card()
    gen = torch.Generator(device="cuda").manual_seed(10)
    for (heads, head_dim), dtype in ((hd, dt) for hd in cs.TRAIN_HEADS
                                     for dt in (torch.bfloat16,
                                                torch.float32)):
        shape = (cs.TRAIN_B, cs.TRAIN_S, heads, head_dim)
        xs = [cs.randn(shape, dtype, gen) for _ in range(3)]
        do = cs.randn(shape, dtype, gen)
        dlse = cs.randn((cs.TRAIN_B, heads, cs.TRAIN_S), torch.float32, gen)
        x32 = [x.float() for x in xs]
        for name, kern, plain, cts, cts32 in (
                ("flash_attention", attn.flash_attention,
                 attn.attention_reference, (do,), (do.float(),)),
                ("flash_attention_lse", attn.flash_attention_lse,
                 attn._reference_lse, (do, dlse), (do.float(), dlse))):
            ref = cs.grads(plain, xs, cts)
            ref32 = cs.grads(plain, x32, cts32)
            paths = {"kernel": cs.grads(kern, xs, cts),
                     "recipe": recipe(*xs, do,
                                      dlse if len(cts) == 2 else None)}
            torch.cuda.synchronize()
            for path, got in paths.items():
                for gname, g, r, r32 in zip(("dq", "dk", "dv"), got, ref,
                                            ref32):
                    e = cs.errors(g, r, r32, rms_floor=cs.GRAD_RMS_FLOOR,
                                  head_dim=head_dim)
                    where = (f"; worst row vs f32 at (s, h) = "
                             f"{worst_row(g, r32, cs.GRAD_RMS_FLOOR)}"
                             if gname == "dq" else "")
                    print(f"{name} {str(dtype)[6:]} H={heads} D={head_dim} "
                          f"{path} {gname}: abs {e['abs']:.3e}, row "
                          f"{e['row']:.3e} vs plain, {e['row_f32']:.3e} vs "
                          f"f32; plain's own "
                          f"{e['plain_row_f32']:.3e}{where} [{card}]",
                          flush=True)


if __name__ == "__main__":
    main()
