"""K5, SPADE's 3x3 convolutions (`ops/spade_conv_cuda.py`), on the CPU: its
plain version against the `SPADE` module's `nn.Conv2d` path, the choice of
path by grad mode, and that its output follows the parameters."""
import copy

import pytest
import torch
from torch.func import functional_call

from ipercore_tpu_torch.models.networks import blocks
from ipercore_tpu_torch.ops import spade_conv_cuda as k5


def _spade(c: int, cond_c: int, seed: int) -> blocks.SPADE:
    torch.manual_seed(seed)
    spade = blocks.SPADE(norm_nc=c, cond_nc=cond_c)
    with torch.no_grad():
        for conv in (spade.Conv_0, spade.Conv_1, spade.Conv_2):
            conv.bias.uniform_(-0.1, 0.1)  # a dropped or misplaced bias must show
    return spade


def _inputs(c: int, cond_c: int, seed: int, n: int = 2, h: int = 6, w: int = 7):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, h, w, c), generator=g), torch.randn((n, h, w, cond_c), generator=g)


def _module_path(spade: blocks.SPADE, x, cond) -> torch.Tensor:
    """The module's `nn.Conv2d` path, taken while autograd records."""
    with torch.enable_grad():
        return spade(x, cond).detach()


@pytest.mark.parametrize("c, cond_c", [pytest.param(c, c, id=str(c)) for c in (64, 128, 256)]
                         + [(8, 8), (16, 16), (32, 32), (5, 3)])
def test_plain_k5_equals_the_module_path(c, cond_c):
    """At the channel widths of the generator's three stages (nhidden 128,
    the condition as wide as the feature), small maps; and through the
    wrappers at the smoke configuration's narrow widths
    (`scripts/evaluate/accuracy_cost.SMOKE_CFG`) and at odd ones, which K5
    takes as well."""
    spade = _spade(c, cond_c, seed=c)
    x, cond = _inputs(c, cond_c, seed=c + 1)
    with torch.no_grad():
        got = spade(x, cond)
    torch.testing.assert_close(got, _module_path(spade, x, cond), atol=1e-5, rtol=0)


def test_no_grad_takes_k5_and_training_keeps_the_conv_modules(monkeypatch):
    calls = []
    for name in ("spade_conv_relu", "spade_modulate"):
        fn = getattr(blocks, name)
        monkeypatch.setattr(blocks, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    spade = _spade(16, 32, seed=3)
    x, cond = _inputs(16, 32, seed=4)
    with torch.no_grad():
        spade(x, cond)
    assert calls == ["spade_conv_relu", "spade_modulate"]
    calls.clear()
    spade(x, cond).square().sum().backward()
    assert calls == []
    for conv in (spade.Conv_0, spade.Conv_1, spade.Conv_2):
        assert conv.weight.grad is not None and float(conv.weight.grad.abs().sum()) > 0
        assert conv.bias.grad is not None and float(conv.bias.grad.abs().sum()) > 0
    # bf16 inputs (the autocast path) keep the modules too
    with torch.no_grad():
        spade.to(torch.bfloat16)(x.bfloat16(), cond.bfloat16())
    assert calls == []


@pytest.mark.parametrize("update", ["in_place", "load_state_dict", "functional_call", "deepcopy",
                                    "data_copy"])
def test_packed_weights_follow_the_parameters(update):
    """K5's output follows a weight updated in place (also through `.data`,
    which no version counter sees), loaded, handed in by `functional_call`
    or belonging to a copy of the module."""
    spade = _spade(32, 16, seed=5)
    x, cond = _inputs(32, 16, seed=6)
    with torch.no_grad():
        before = spade(x, cond)
    other = _spade(32, 16, seed=7)
    if update == "in_place":
        with torch.no_grad():
            spade.Conv_1.weight.add_(0.05)
            spade.Conv_2.bias.mul_(-1.0)
        want, run = spade, spade
    elif update == "load_state_dict":
        spade.load_state_dict(other.state_dict())
        want, run = other, spade
    elif update == "functional_call":
        params = dict(other.named_parameters())
        want, run = other, lambda a, b: functional_call(spade, params, (a, b))
    elif update == "data_copy":
        spade.Conv_1.weight.data.copy_(other.Conv_1.weight)
        want, run = spade, spade
    else:
        want = run = copy.deepcopy(spade)
        with torch.no_grad():
            want.Conv_0.weight.mul_(0.5)
    with torch.no_grad():
        got = run(x, cond)
    assert not torch.allclose(got, before, atol=1e-3)
    torch.testing.assert_close(got, _module_path(want, x, cond), atol=1e-5, rtol=0)


def test_pack_interleaves_gamma_and_beta():
    """Column 2o of the packed pair is channel o of the first convolution,
    column 2o + 1 of the second; rows run over (tap, input channel)."""
    w1, w2 = torch.randn(3, 4, 3, 3), torch.randn(3, 4, 3, 3)
    b1, b2 = torch.randn(3), torch.randn(3)
    wp, b = k5.pack_conv3x3((w1, w2), (b1, b2))
    assert wp.shape == (36, 6) and wp.is_contiguous()
    torch.testing.assert_close(wp[(2 * 3 + 1) * 4 + 3, 2 * 2 + 1], w2[2, 3, 2, 1], atol=0, rtol=0)
    torch.testing.assert_close(wp[(0 * 3 + 2) * 4 + 0, 2 * 1], w1[1, 0, 0, 2], atol=0, rtol=0)
    torch.testing.assert_close(b, torch.stack([b1, b2], 1).reshape(6), atol=0, rtol=0)
