"""GPT-2 124M's train step on one card, GPipe and ``remat=True``, from the
mpi_acx_torch package under the directory given as the argument (this
checkout, ".", or another one, e.g. a ``git archive`` of an earlier
commit unpacked into build/): phase 5b's configuration and batch (seed-0
f32 weights, bf16 compute, AdamW, M = 2 x 4 x 1024 ramp tokens), N steps
each (the second argument, 5 by default), the step time the mean of steps
1 to N - 1 (host clock, each step ending in a synchronize), the peak
memory, and remat's time over GPipe's, as one ``REMATAB`` JSON line.
Compare trees on one machine, in turns: A, B, B, A.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/remat_ab.py <tree> [N]``."""
import json
import os
import statistics
import sys

root = os.path.abspath(sys.argv[1])
steps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
sys.path.insert(0, root)
import torch  # noqa: E402
import mpi_acx_torch  # noqa: E402
from mpi_acx_torch.ops import _build  # noqa: E402
from mpi_acx_torch.models import transformer as tfm  # noqa: E402

_build.BUILD_DIR = _build.Path(root) / "build" / "torch_kernels"
assert mpi_acx_torch.__file__.startswith(root), mpi_acx_torch.__file__
sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

cfg = tfm.gpt2_small()
batch = cs.ramp_batch(cfg.vocab)
out = {"tree": sys.argv[1], "steps": steps}
for name, options in (("gpipe", {}), ("remat", dict(remat=True))):
    run = cs.train_run(cfg, cs.gpt2_init(), batch, steps=steps, final=False,
                       **options)
    out[name] = dict(ms=1e3 * statistics.mean(run["secs"][1:]),
                     steps_ms=[round(1e3 * s, 1) for s in run["secs"]],
                     peak_gib=run["peak"] / 2**30,
                     b10=run["counts"]["flash_attention_lse"],
                     losses=run["losses"])
    del run
    torch.cuda.empty_cache()
out["remat_over_gpipe"] = out["remat"]["ms"] / out["gpipe"]["ms"]
print("REMATAB " + json.dumps(out), flush=True)
