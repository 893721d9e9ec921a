"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a tiny size (the look for
a chip is ``run.py``'s and is skipped), with one fault planted in the
program where the cell can have it: a served token altered where the step
produces it; a decode step that returns the KV cache unchanged; a train
step that leaves the weights unchanged; a train step that leaves out half
of the batch and takes the mean over the rest. (One chip: no exchange
between chips to leave out.)"""

import pytest
import torch

from acxbench import harness


def _token_altered(monkeypatch):
    from mpi_acx_torch.models import serving
    real = serving.make_server_fns

    def make(params, cfg, family, **kw):
        prefill, step, *rest = real(params, cfg, family, **kw)

        def altered(cache, tok, keys=None):
            cache, toks = step(cache, tok, keys)
            toks = toks.clone()
            toks[0] = (toks[0] + 1) % cfg.vocab
            return cache, toks
        return (prefill, altered, *rest)
    monkeypatch.setattr(serving, "make_server_fns", make)


def _cache_unchanged(monkeypatch):
    from mpi_acx_torch.models import serving
    real = serving.make_server_fns

    def make(params, cfg, family, **kw):
        prefill, step, *rest = real(params, cfg, family, **kw)

        def frozen(cache, tok, keys=None):
            kept = {k: cache[k].clone() for k in ("k", "v")}
            cache, toks = step(cache, tok, keys)
            for k, t in kept.items():
                cache[k].copy_(t)
            return cache, toks
        return (prefill, frozen, *rest)
    monkeypatch.setattr(serving, "make_server_fns", make)


def _weights_unchanged(monkeypatch):
    from mpi_acx_torch import train
    real = train.make_train_step_optim

    def make(cfg, mesh, n_micro, optimizer, **kw):
        step, n = real(cfg, mesh, n_micro, optimizer, **kw)

        def frozen(params, tokens, targets):
            kept = [p.detach().clone() for p in train.param_leaves(params)]
            loss, params = step(params, tokens, targets)
            with torch.no_grad():
                for p, k in zip(train.param_leaves(params), kept):
                    p.copy_(k)
            return loss, params
        return frozen, n
    monkeypatch.setattr(train, "make_train_step_optim", make)


def _half_batch(monkeypatch):
    from mpi_acx_torch import train
    real = train.make_train_step_optim

    def make(cfg, mesh, n_micro, optimizer, **kw):
        step, n = real(cfg, mesh, n_micro, optimizer, **kw)

        def half(params, tokens, targets):
            h = tokens.shape[1] // 2
            return step(params, tokens[:, :h].contiguous(),
                        targets[:, :h].contiguous())
        return half, n
    monkeypatch.setattr(train, "make_train_step_optim", make)


FAULTS = [("tiny-gpt2.serve", _token_altered),
          ("tiny-llama.serve", _token_altered),
          ("tiny-gpt2.serve", _cache_unchanged),
          ("tiny-llama.serve", _cache_unchanged),
          ("tiny-gpt2.train", _weights_unchanged),
          ("tiny-gpt2.train", _half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = harness.run_cell(tiny_bench, cell, 31, 4.0, False, "cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["tiny-gpt2.serve", "tiny-llama.serve",
                                  "tiny-gpt2.train"])
def test_sound_run_is_correct(tiny_bench, cell):
    res = harness.run_cell(tiny_bench, cell, 31, 4.0, False, "cpu")
    assert res["correct"] is True, res["checks"]
