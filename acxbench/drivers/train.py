"""Training traffic: the port's train step (``train.make_train_step_optim``
on a 1x1x1 mesh, GPipe) fed by its token pipeline (``data.batches`` over a
``TokenDataset`` file, then ``data.prefetch``).

Set-up draws the float32 weights from the seed, writes the seed's token
file under ``TMPDIR``, builds the one step object with its AdamW state, and
drives it through its first three steps through the same feed the window
uses; those steps warm every shape and give the check its readings: each
step's loss, each leaf's first gradient as AdamW holds it after one step
(its first moment over 1 - beta1), and each leaf's change after three
steps. The window then runs the same object on; a step counts when it
ends (its loss read on the host) inside the window.

The traced run puts the benchmark's spans round each step, round each
``next()`` of the feed, and round the attention entry point the train
step runs (``flash_attention_lse`` where ``parallel/ring_attention.py``
looks it up), and runs ``torch.profiler`` over the window's first
``trace_seconds``.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from acxbench import flops, trace
from acxbench.reference.adamw import AdamW as RefAdamW
from acxbench.reference.common import exact_f32, matmul
from acxbench.reference.train import iter_leaves, leaf_names, loss_and_grads
from acxbench.traffic import zipf_tokens

CHECK_STEPS = 3


class Driver:
    kind = "train"

    def __init__(self, run):
        self.run = run
        self.wl, self.cfg = run.workload, run.config
        self.t = self.wl["train"]
        self.dims = flops.dims(self.cfg)
        self.dev = torch.device(run.device)
        self.tracer = None
        self.k1_calls, self.data_wait = [], []
        self.restore = []

    # -- set-up ---------------------------------------------------------

    def setup(self):
        from mpi_acx_torch import data, train
        from mpi_acx_torch.parallel.mesh import mesh_from_devices
        fam, t = self.run.family, self.t
        self.pcfg = fam.port_config(self.cfg, torch.bfloat16)
        params = fam.draw_params(self.cfg, self.run.seed, self.dev,
                                 torch.float32)
        # The reference's starting point: the benchmark's own copy.
        self.init = {k: ({n: a.clone() for n, a in v.items()}
                         if isinstance(v, dict) else v.clone())
                     for k, v in params.items()}
        self.names = leaf_names(params)
        if self.run.trace:
            self._wrap_attention()
        self.params = fam.port_module().stage_slice(params, 1)
        self.opt = torch.optim.AdamW(train.param_leaves(self.params),
                                     lr=t["lr"], betas=tuple(t["betas"]),
                                     eps=t["eps"],
                                     weight_decay=t["weight_decay"])
        self.step, n_stages = train.make_train_step_optim(
            self.pcfg, mesh_from_devices({"dp": 1, "pp": 1, "tp": 1}),
            t["n_micro"], self.opt, device=self.dev)
        if n_stages != 1:
            raise RuntimeError(f"{n_stages} stages on a 1x1x1 mesh")
        path = os.path.join(tempfile.gettempdir(), "acxbench-tokens.u16")
        zipf_tokens(t["file_tokens"], self.dims.vocab,
                    self.run.seed).tofile(path)
        self.recorded = []
        self.feed = data.prefetch(self._batches(data.batches(
            data.TokenDataset(path), t["n_micro"] * t["micro_batch"],
            t["seq"], seed=self.run.seed)), device=self.dev)
        self.losses = []
        for i in range(CHECK_STEPS):
            loss = self._one_step()
            self.losses.append(loss)
            if i == 0:
                self.grad1 = [float(self.opt.state[p]["exp_avg"].norm())
                              / (1 - t["betas"][0])
                              for p in train.param_leaves(self.params)]
        self.change = [float((p.detach().reshape(q.shape) - q).norm())
                       for p, q in zip(train.param_leaves(self.params),
                                       iter_leaves(self.init))]

    def _batches(self, windows):
        """[batch, seq + 1] windows -> (tokens, targets) [n_micro,
        micro_batch, seq] int32; the first steps' are kept for the
        reference."""
        t = self.t
        shape = (t["n_micro"], t["micro_batch"], t["seq"])
        for w in windows:
            pair = (np.ascontiguousarray(w[:, :-1]).reshape(shape),
                    np.ascontiguousarray(w[:, 1:]).reshape(shape))
            if len(self.recorded) < CHECK_STEPS:
                self.recorded.append(pair)
            yield pair

    def _one_step(self) -> float:
        t0 = time.perf_counter()
        with trace.span("data_next"):
            tokens, targets = next(self.feed)
        self.data_wait.append(time.perf_counter() - t0)
        with trace.span("step"):
            loss, self.params = self.step(self.params, tokens, targets)
            return loss.item()

    def _wrap_attention(self):
        from mpi_acx_torch.parallel import ring_attention
        drv = self
        orig = ring_attention.flash_attention_lse

        def flash_attention_lse(q, k, v, *a, **kw):
            if drv.tracing():
                drv.k1_calls.append(tuple(q.shape))
            with trace.span("k1_lse"):
                return orig(q, k, v, *a, **kw)

        self.restore = [(ring_attention, "flash_attention_lse", orig)]
        ring_attention.flash_attention_lse = flash_attention_lse

    # -- window ---------------------------------------------------------

    def tracing(self) -> bool:
        return self.tracer is not None and self.tracer.running

    def window(self, seconds):
        if self.run.trace and self.dev.type == "cuda":
            self.tracer = trace.Tracer()
            self.tracer.start()
        self.data_wait = []
        self.seconds = seconds
        self.t0 = time.perf_counter()
        end = self.t0 + seconds
        self.steps = 0
        while time.perf_counter() < end:
            self._one_step()
            if time.perf_counter() <= end:
                self.steps += 1
            if (self.tracing() and time.perf_counter() - self.tracer.t_start
                    >= self.wl["trace_seconds"]):
                self.tracer.stop()
        if self.tracing():
            self.tracer.stop()

    def memory_peak(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.dev))

    def step_tokens(self) -> int:
        t = self.t
        return t["n_micro"] * t["micro_batch"] * t["seq"]

    def end_to_end(self, seconds) -> dict:
        return dict(attempted=self.steps, failed=0,
                    train_tokens_per_s=self.steps * self.step_tokens()
                    / seconds)

    def artifacts(self):
        t = self.t
        return SimpleNamespace(
            kind="train", dims=self.dims, window_s=self.seconds,
            steps=self.steps,
            step_flops=flops.train_step_flops(
                self.dims, t["n_micro"] * t["micro_batch"], t["seq"]),
            data_wait_s=list(self.data_wait),
            trace=(self.tracer.result() if self.tracer is not None
                   else None),
            k1_calls=list(self.k1_calls))

    # -- check ----------------------------------------------------------

    def release(self):
        """Free the program's state: the step, its optimizer and feed."""
        self.feed.close()
        self.step = self.opt = self.params = self.feed = None
        for mod, name, fn in self.restore:
            setattr(mod, name, fn)
        self.restore = []
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_run(self, precision="f32"):
        """The reference's three steps from the benchmark's starting
        weights on the recorded batches: (losses, first gradients' norms,
        changes' norms), one per leaf in the program's leaf order."""
        t = self.t
        ref = self.run.family.reference
        mm = matmul(precision)
        params = {k: ({n: a.clone().requires_grad_() for n, a in v.items()}
                      if isinstance(v, dict)
                      else v.clone().requires_grad_())
                  for k, v in self.init.items()}
        leaves = list(iter_leaves(params))
        opt = RefAdamW(leaves, t["lr"], tuple(t["betas"]), t["eps"],
                       t["weight_decay"])
        losses = []
        with exact_f32():
            for i, (tok, tgt) in enumerate(self.recorded):
                loss, grads = loss_and_grads(
                    ref, params, self.cfg,
                    torch.as_tensor(tok, device=self.dev).long(),
                    torch.as_tensor(tgt, device=self.dev).long(), mm)
                losses.append(loss)
                if i == 0:
                    grad1 = [float(g.norm()) for g in grads]
                opt.step(grads)
                del grads
        change = [float((p.detach() - q).norm())
                  for p, q in zip(leaves, iter_leaves(self.init))]
        return losses, grad1, change

    def check(self, against=None) -> dict:
        """The program's readings against the reference's (``against``:
        another set of readings in the program's place, for the
        control)."""
        ref = self.reference_run()
        got = against or (self.losses, self.grad1, self.change)
        return compare_train(got, ref, self.names)


def _leaf_gaps(got, ref, keep=None):
    """Each counted leaf's gap of norms to the reference's, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    keep = keep or [True] * len(ref)
    med = statistics.median(r for r, k in zip(ref, keep) if k)
    return [abs(g - r) / max(r, med) if k else 0.0
            for g, r, k in zip(got, ref, keep)]


def compare_train(got, ref, names=None) -> dict:
    """``loss_gap`` (the largest relative gap of a step's loss),
    ``grad_gap`` and ``change_gap`` (the worst leaf of :func:`_leaf_gaps`
    for the first gradients and for the changes after three steps, the
    latter over the leaves whose reference gradient is at least a
    thousandth of the median leaf's), and what they came from."""
    (lp, gp, cp), (lr_, gr, cr) = got, ref
    med_g = statistics.median(gr)
    moved = [g >= 1e-3 * med_g for g in gr]
    loss = [abs(a - b) / abs(b) for a, b in zip(lp, lr_)]
    grad, change = _leaf_gaps(gp, gr), _leaf_gaps(cp, cr, moved)
    names = names or [str(i) for i in range(len(gr))]
    worst = (lambda xs: names[max(range(len(xs)), key=xs.__getitem__)])
    return {"loss_gap": max(loss), "grad_gap": max(grad),
            "change_gap": max(change), "loss_gaps": loss,
            "grad_worst": worst(grad), "change_worst": worst(change),
            "change_median": statistics.median(
                c for c, k in zip(change, moved) if k),
            "leaves_left_out": moved.count(False)}
