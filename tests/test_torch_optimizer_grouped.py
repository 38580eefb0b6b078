"""The grouped optimizer step (``train/state.py:Optimizer.update``) against
the per-tensor loop it replaced, kept here as the oracle: parameters and
both moments bit for bit over 3 steps with a change of rate between them,
for adam, adamax, sgd and adam with a bf16 first moment, and the module's
``GROUPED`` counter; and the bf16 nets' gradients, which come back laid
out as their parameters, so that the grouped calls take every tensor.

The optimizer's CPU test runs at 16-64 elements a tensor. The ``cuda``
test runs the same comparison on the card over CoordGridNet's 181 and
ResNet-9's 50 parameter shapes and skips without a card. The file imports
no JAX, so that it runs on a machine with the card and without JAX:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_optimizer_grouped.py
"""

import numpy as np
import pytest
import torch

from video_layout_generation_tpu_torch.models import (CoordGridNet,
                                                      NLayerDiscriminator,
                                                      ResnetGenerator)
from video_layout_generation_tpu_torch.train import state as tstate
from video_layout_generation_tpu_torch.train.state import B2, EPS

RULES = {"adam": ("adam", None), "adamax": ("adamax", None),
         "sgd": ("sgd", None), "adam_bf16_mu": ("adam", torch.bfloat16)}


@torch.no_grad()
def loop_update(opt, params, grads, state):
    """The update as a loop over the tensors, about 9 launches each."""
    lr = state["learning_rate"]
    state["count"] += 1
    t = state["count"]
    b1 = opt.beta1
    for k, p in params.items():
        g = grads[k].to(p.dtype)
        if opt.name == "sgd":
            p.add_(g, alpha=-lr)
            continue
        mu_kept, nu = state["mu"][k], state["nu"][k]
        mu = mu_kept.to(p.dtype)
        mu.mul_(b1).add_(g, alpha=1 - b1)
        mu_hat = mu / (1 - b1 ** t)
        if opt.name == "adam":
            nu.mul_(B2).addcmul_(g, g, value=1 - B2)
            denom = (nu / (1 - B2 ** t)).sqrt_().add_(EPS)
        else:
            torch.maximum(nu * B2, g.abs() + EPS, out=nu)
            denom = nu
        p.addcdiv_(mu_hat, denom, value=-lr)
        if mu is not mu_kept:
            mu_kept.copy_(mu)


def bits(t):
    return t.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[t.element_size()])


def grouped_against_loop(rule, shapes, device, seed, dtypes=None):
    """3 steps of both on the same values (the rate changes before the
    third); returns the counter's change."""
    name, moment_dtype = RULES[rule]
    dtypes = dtypes or {}
    rng = np.random.default_rng(seed)
    # parameters near the size of a step, so that the last bit of each
    # step's rounding shows in them
    p0 = {k: rng.standard_normal(s, dtype=np.float32) * np.float32(1e-3)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s, dtype=np.float32)
              * np.float32(10.0 ** rng.integers(-4, 1))
              for k, s in shapes.items()} for _ in range(3)]

    def put(a, k):
        return torch.from_numpy(np.asarray(a)).to(
            device, dtypes.get(k, torch.float32))

    tx = tstate.make_optimizer(name, lr=2e-3, beta1=0.9,
                               moment_dtype=moment_dtype)
    grouped = tstate.TrainState.create({k: put(v, k) for k, v in p0.items()},
                                       tx)
    loop = tstate.TrainState.create({k: put(v, k) for k, v in p0.items()},
                                    tx)
    before = dict(tstate.GROUPED)
    for i, g in enumerate(grads):
        if i == 2:
            for st in (grouped, loop):
                tstate.set_lr(st, 5e-4)
        grouped.apply_gradients({k: put(v, k) for k, v in g.items()})
        loop_update(tx, loop.params, {k: put(v, k) for k, v in g.items()},
                    loop.opt_state)
    trees = ["params"] + (["mu", "nu"] if name != "sgd" else [])
    for tree in trees:
        a = grouped.params if tree == "params" else grouped.opt_state[tree]
        b = loop.params if tree == "params" else loop.opt_state[tree]
        for k in shapes:
            assert a[k].dtype == b[k].dtype, (tree, k)
            assert torch.equal(bits(a[k]), bits(b[k])), (rule, tree, k)
    assert grouped.opt_state["count"] == loop.opt_state["count"] == 3
    return {k: tstate.GROUPED[k] - before[k] for k in before}


SMALL = {"a.kernel": (2, 2, 4, 4), "a.bias": (16,), "a.alpha": (),
         "b.kernel": (3, 3, 2, 3), "b.bias": (48,), "b.alpha": (1,),
         "c.kernel": (8, 4)}


@pytest.mark.parametrize("rule,dtypes,groups", [
    ("adam", None, 1), ("adamax", None, 1), ("sgd", None, 1),
    ("adam_bf16_mu", None, 1),
    ("adam", {"b.kernel": torch.float64, "b.bias": torch.float64}, 2)],
    ids=["adam", "adamax", "sgd", "adam_bf16_mu", "adam_two_dtypes"])
def test_grouped_update_is_the_per_tensor_loop_bit_for_bit(rule, dtypes,
                                                           groups):
    moved = grouped_against_loop(rule, SMALL, "cpu", seed=23, dtypes=dtypes)
    assert moved == {"updates": 3, "tensors": 3 * len(SMALL),
                     "groups": 3 * groups}


@pytest.mark.parametrize("net,hw,cin", [
    (lambda: CoordGridNet(n_channels=10, filters_level=(8, 8, 16),
                          dtype=torch.bfloat16), 16, 10),
    (lambda: ResnetGenerator(10, ngf=8, n_blocks=1, dtype=torch.bfloat16),
     32, 10),
    (lambda: NLayerDiscriminator(9, ndf=8, dtype=torch.bfloat16), 32, 9)],
    ids=["coordgridnet", "resnet9", "patchgan"])
def test_bf16_nets_give_gradients_laid_out_as_their_parameters(net, hw, cin):
    """The grouped calls take a tensor in their launches only where its
    gradient has the parameter's strides (``layers.cast_param``)."""
    torch.manual_seed(0)
    net = net()
    out = net(torch.randn(1, hw, hw, cin))
    loss = sum(o.float().square().mean()
               for o in (out if isinstance(out, tuple) else (out,)))
    params = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert sum(p.dim() == 4 for p in params.values()) >= 5
    for (k, p), g in zip(params.items(), grads):
        assert g.stride() == p.stride(), k


@pytest.fixture(scope="module")
def net_shapes():
    """Parameter shapes of the two benchmarked generators at full width."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    nets = {"coordgridnet": CoordGridNet(n_channels=10,
                                         filters_level=(32, 64, 96)),
            "resnet9": ResnetGenerator(10, ngf=64, n_blocks=9)}
    return {name: {k: tuple(p.shape) for k, p in net.named_parameters()}
            for name, net in nets.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("net,n_tensors", [("coordgridnet", 181),
                                           ("resnet9", 50)])
@pytest.mark.parametrize("rule", list(RULES))
def test_grouped_update_on_the_card_is_the_loop_bit_for_bit(net_shapes, net,
                                                            n_tensors, rule):
    shapes = net_shapes[net]
    assert len(shapes) == n_tensors
    moved = grouped_against_loop(rule, shapes, "cuda", seed=2 ** 31 + 23)
    assert moved == {"updates": 3, "tensors": 3 * n_tensors, "groups": 3}
