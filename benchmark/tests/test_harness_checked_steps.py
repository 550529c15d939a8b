"""The first gradient as the optimizer takes it (``loops/train_common.py``):
a pre-hook of the first optimizer step reads each parameter's gradient with
the group's weight decay added, which under SGD is the momentum buffer that
step starts, bit for bit, and under Adam the gradient the update is made
from."""

import pytest
import torch

from loops.train_common import checked_steps, taken_gradient


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.ReLU(), torch.nn.Linear(4, 2))


def _loss(model, seed):
    x = torch.randn(6, 5, generator=torch.Generator().manual_seed(seed))
    return model(x).pow(2).mean()


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_the_reading_is_sgds_momentum_buffer(weight_decay):
    model = _model()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True,
                          weight_decay=weight_decay)
    taken, _ = taken_gradient(model, opt)
    _loss(model, 1).backward()
    opt.step()
    for n, p in model.named_parameters():
        assert torch.equal(taken[n], opt.state[p]["momentum_buffer"]), n
    opt.zero_grad()
    _loss(model, 2).backward()
    opt.step()  # the hook is gone: the first step's reading stays
    for n, p in model.named_parameters():
        assert not torch.equal(taken[n], opt.state[p]["momentum_buffer"]), n


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_the_reading_under_adam_is_the_decayed_gradient(weight_decay):
    model = _model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=weight_decay)
    taken, _ = taken_gradient(model, opt)
    _loss(model, 1).backward()
    want = {n: p.grad.add(p.detach(), alpha=weight_decay) for n, p in model.named_parameters()}
    opt.step()
    for n in want:
        assert torch.equal(taken[n], want[n]), n


def test_a_step_that_never_reaches_the_optimizer_reads_zeros():
    model = _model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        with torch.no_grad():
            return _loss(model, 1), [0]

    out = checked_steps(model, opt, step)
    assert all(not g.any() for g in out["grad1"].values())
    assert all(torch.equal(out["p0"][n], out["p3"][n]) for n in out["p0"])
