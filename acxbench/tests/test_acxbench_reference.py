"""The plain references against a tiny port model on the CPU, in float32:
a check of the references, not of the port."""

import json

import pytest
import torch
from conftest import DATA

from acxbench.families import gpt2 as fam_gpt2
from acxbench.families import llama as fam_llama
from acxbench.reference.adamw import AdamW
from acxbench.reference.common import exact_f32, fp8_round, matmul
from acxbench.reference.train import iter_leaves, loss_and_grads

FAMS = {"gpt2": (fam_gpt2, "tiny-gpt2"), "llama": (fam_llama, "tiny-llama")}


def _setup(name, seed=3):
    fam, cfg_name = FAMS[name]
    cfg = json.loads((DATA / f"{cfg_name}.json").read_text())
    params = fam.draw_params(cfg, seed, "cpu", torch.float32)
    return fam, cfg, params, fam.port_config(cfg, torch.float32)


@pytest.mark.parametrize("name", FAMS)
def test_logits_match_port(name):
    fam, cfg, params, pcfg = _setup(name)
    tokens = torch.randint(0, pcfg.vocab, (40,),
                           generator=torch.Generator().manual_seed(1))
    want = fam.port_module().forward(params, pcfg, tokens[None])[0]
    with exact_f32():
        got = fam.reference.logits_at(params, cfg, tokens,
                                      torch.arange(40), matmul("f32"))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", FAMS)
def test_loss_and_grads_match_port(name):
    fam, cfg, params, pcfg = _setup(name)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, pcfg.vocab, (1, 2, 24), generator=g)
    targets = torch.randint(0, pcfg.vocab, (1, 2, 24), generator=g)
    live = {k: ({n: a.clone().requires_grad_() for n, a in v.items()}
                if isinstance(v, dict) else v.clone().requires_grad_())
            for k, v in params.items()}
    loss = fam.port_module().loss_fn(live, pcfg, tokens[0], targets[0])
    want = torch.autograd.grad(loss, list(iter_leaves(live)))
    ref_loss, grads = loss_and_grads(fam.reference, live, cfg, tokens,
                                     targets, matmul("f32"))
    assert ref_loss == pytest.approx(loss.item(), rel=1e-6)
    for a, b in zip(grads, want):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-4)


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(4)
    p0 = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    ours = [p.clone() for p in p0]
    theirs = [p.clone().requires_grad_() for p in p0]
    kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    opt, topt = AdamW(ours, **kw), torch.optim.AdamW(theirs, **kw)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in p0]
        opt.step(grads)
        for p, gr in zip(theirs, grads):
            p.grad = gr.clone()
        topt.step()
    for a, b in zip(ours, theirs):
        assert torch.allclose(a, b.detach(), atol=1e-7, rtol=1e-6)


def test_fp8_control_is_coarser():
    g = torch.Generator().manual_seed(5)
    x, w = torch.randn(16, 64, generator=g), torch.randn(64, 32, generator=g)
    exact = x @ w
    err8 = (matmul("fp8")(x, w) - exact).abs().max()
    err16 = (x.bfloat16().float() @ w.bfloat16().float() - exact).abs().max()
    assert err8 > 4 * err16
    assert torch.equal(fp8_round(fp8_round(x)), fp8_round(x))
    for prec in ("fp8", "fp8_e4m3"):
        xr = x.clone().requires_grad_()
        matmul(prec)(xr, w).sum().backward()
        assert xr.grad.shape == x.shape
