#!/usr/bin/env python3
"""Why a train step through the CUDA kernels cannot agree with the plain
step to a few percent in its gradients: two probes on the full-width
pix2pix ResnetGenerator with random weights (the nets, weights and batch of
``chip_smoke.py``). Needs one NVIDIA GPU and the CUDA toolkit; run from the
root of a checkout:

    python3 tools/probe_train_step_agreement.py

1. Gradients of the train step's loss with one group of kernels switched on
   at a time (the rest on the plain path), each against the all-plain
   gradients: the plain path twice (what cuDNN's own backward varies by),
   the InstanceNorm kernels alone, VGG19 through kernel A alone, HNED
   through kernel A alone, all kernels. Per case the loss, the generator's
   image error, and the max-norm and L2 error of chosen parameter tensors.
2. The same step with f32 activations in the generator: every InstanceNorm
   call's backward, redone on its own tensors by the kernel and by the
   plain version, against an f64 reference.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from video_layout_generation_tpu_torch.io.weights import \
    params_from_flax  # noqa: E402
from video_layout_generation_tpu_torch.models import \
    ResnetGenerator  # noqa: E402
from video_layout_generation_tpu_torch.ops import kernels  # noqa: E402
from video_layout_generation_tpu_torch.ops.kernels import \
    instance_norm as mod  # noqa: E402
from video_layout_generation_tpu_torch.train.steps import (  # noqa: E402
    _to_device, decode_batch, make_loss_fn, prepare_inputs)

SHOWN = ("Conv_0.kernel", "Conv_2.kernel", "ResnetBlock_4.Conv_0.kernel",
         "ResnetBlock_8.Conv_1.kernel", "ConvTranspose_1.kernel",
         "last_conv_img.kernel", "last_conv_seg.kernel")


class PinnedLoss:
    """The combined loss with its VGG19 trunk pinned to one path: run under
    ``kernels.plain(plain)`` whatever the mode around it."""

    def __init__(self, inner, plain):
        self.inner, self.plain, self.vgg_model = inner, plain, inner.vgg_model

    def __call__(self, output, target):
        with kernels.plain(self.plain):
            return self.inner(output, target)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    weights = cs.edge_mode_weights(0)
    weights.update(cs.pix2pix_weights(0))
    gen, _, hned, combined = cs.build_pix2pix(torch, weights, False)
    for net in (gen, hned, combined.vgg_model):
        net.to(dev)
    batch = decode_batch(_to_device(cs.make_packed_batch(cs.BATCH, 60), dev))

    def grads(model, hned_plain, gen_plain, vgg_plain):
        names = [k for k, _ in model.named_parameters()]
        with torch.no_grad(), kernels.plain(hned_plain):
            x, f3n = prepare_inputs(hned, batch)
        loss_fn = make_loss_fn(model, PinnedLoss(combined, vgg_plain))
        with kernels.plain(gen_plain):
            total, (_, _, img) = loss_fn(x, f3n, batch["seg3"])
            g = torch.autograd.grad(total, [p for _, p in
                                            model.named_parameters()])
        return float(total.detach()), dict(zip(names, g)), img.detach()

    def compare(tag, got, ref):
        img = float((got[2] - ref[2]).abs().max() / ref[2].abs().max())
        print(f"{tag}: loss {got[0]:.6f} vs {ref[0]:.6f}; image error "
              f"{img:.4f}", flush=True)
        for k in SHOWN:
            d = (got[1][k] - ref[1][k]).float()
            print(f"    {k}: max {float(d.abs().max() / ref[1][k].abs().max()):.4f}"
                  f" l2 {float(d.norm() / ref[1][k].float().norm()):.4f}",
                  flush=True)

    ref = grads(gen, True, True, True)
    compare("plain path twice", grads(gen, True, True, True), ref)
    compare("InstanceNorm kernels alone", grads(gen, True, False, True), ref)
    compare("VGG19 through kernel A alone", grads(gen, True, True, False),
            ref)
    compare("HNED through kernel A alone", grads(gen, False, True, True),
            ref)
    compare("all kernels", grads(gen, False, False, False), ref)

    # 2. f32 activations: the paths' gradients, then every InstanceNorm
    # backward on its own tensors against f64
    gen32 = ResnetGenerator(input_nc=10, ngf=cs.NGF, n_blocks=cs.N_BLOCKS,
                            norm="instance")
    gen32.load_state_dict(params_from_flax(weights["gen"]), strict=True)
    gen32.to(dev)
    ref32 = grads(gen32, True, True, True)
    calls, handles = cs.watch_instance_norms([gen32])
    compare("f32 generator, InstanceNorm kernels alone",
            grads(gen32, True, False, True), ref32)
    for h in handles:
        h.remove()
    for i, call in enumerate(calls):
        x, dy = call["x"], call["dy"].contiguous()
        xk = x.clone().requires_grad_(True)
        xp = x.clone().requires_grad_(True)
        xd = x.double().requires_grad_(True)
        dxk, = torch.autograd.grad(mod.instance_norm(xk), xk, dy)
        dxp, = torch.autograd.grad(mod.instance_norm_plain(xp), xp, dy)
        dxd, = torch.autograd.grad(mod.instance_norm_plain(xd), xd,
                                   dy.double())
        top = dxd.abs().max()
        print(f"InstanceNorm call {i} {tuple(x.shape)} f32 backward against "
              f"f64: kernel {float((dxk.double() - dxd).abs().max() / top):.2e}"
              f", plain {float((dxp.double() - dxd).abs().max() / top):.2e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
