"""Traffic kind ``train_gan``: epochs of the port's ``Trainer`` with
``--gan_train`` (a ResNet generator against the PatchGAN), on scenes made
from the seed.

The loop and the traced slice are the ``train`` driver's, by way of
``train_resnet.py`` (imported from beside this file): a first epoch of
``WARM_STEPS`` steps in the set-up that the check follows, then whole
epochs of ``epoch_steps`` steps in the window. The ``Trainer`` is built as
the CLI builds it for ``--arch ResnetGenerator --gan_train --netD <netD>
--ndf <ndf> --gan_mode <gan_mode>``; its weights come from
``gan_weights.py``, the reference that follows its first steps is
``reference/resnet_gan.py``, and the work a step does (model FLOPs, the
InstanceNorm launches of both nets) is counted by
``reference/gan_counts.py``.

The check keeps the loss, the first gradient (Adam's first moment after
step 1 over 1 - beta1) and the change after the first steps of every leaf
of both nets, keyed ``gen.<leaf>`` and ``disc.<leaf>``, and reads the
``train`` driver's numbers for each net: ``worst_grad_gap``,
``worst_tensor_grad_gap`` and ``median_change_gap`` for the generator,
``worst_disc_grad_gap`` and ``median_disc_change_gap`` for the
discriminator.

The traced slice's readers get, besides the ``train`` driver's window and
trace: ``norm_launches``, the InstanceNorm launches the reference lists for
the slice's steps; ``flops_per_step``; ``steps``, the slice's steps; and
``disc_forwards``, the program's D forwards by role over the traced epoch
(None where the program does not count them), beside ``epoch_steps`` and
the roles the reference runs a step (``disc_roles``).
"""

from __future__ import annotations

import os
import statistics
import tempfile
from pathlib import Path
from typing import List

import torch

from benchmark import gan_weights, scenes
from benchmark.harness import load_module, sync
from benchmark.reference import gan_counts, resnet_gan
from benchmark.reference import train as ref

_resnet = load_module(Path(__file__).with_name("train_resnet.py"),
                      "bench_driver_train_resnet")
_train = _resnet._train
WARM_STEPS, SceneDataset, gap = (_train.WARM_STEPS, _train.SceneDataset,
                                 _train.gap)
NETS = ("gen", "disc")
FORWARDS = "disc_forwards_"     # the Trainer's epoch_stats keys by role


class Driver(_resnet.Driver):
    def setup(self) -> None:
        from video_layout_generation_tpu_torch.config import Config
        from video_layout_generation_tpu_torch.train.trainer import Trainer
        c, t = self.cell.config, self.cell.traffic
        if (c["disc_norm"], c["disc_init_type"], c["disc_init_gain"]) != (
                c["norm"], c["init_type"], c["init_gain"]):
            raise ValueError("the CLI sets one norm and one init for both "
                             "nets")
        self.imgs, self.segs = scenes.render(
            self.seed, c["scenes"], self.n_frames, self.hw, c["n_classes"],
            device=self.dev)
        self.ds = SceneDataset(self.imgs, self.segs, self.n_frames,
                               WARM_STEPS * self.batch)
        val = SceneDataset(self.imgs, self.segs, 3, self.batch)
        self.path = path = os.path.join(tempfile.gettempdir(), "vlg_bench",
                                        self.cell.name)
        w = c["loss_weights"]
        cfg = Config(
            dataset="synthetic", arch=c["arch"], edge=c["edge"],
            ngf=c["ngf"], norm=c["norm"], init_type=c["init_type"],
            init_gain=c["init_gain"], gan_train=True, netD=c["netD"],
            n_layers_D=c["n_layers_D"], ndf=c["ndf"],
            gan_mode=c["gan_mode"], image_size=self.hw,
            n_classes=c["n_classes"], compute_dtype=c["compute_dtype"],
            w_l1=w[0], w_style=w[1], w_seg=w[2], batch_size=self.batch,
            lr=t["lr"], beta1=t["beta1"], print_freq=t["print_freq"],
            workers=t["workers"], put_thread=t["put_thread"],
            transfer_uint8=t["transfer_uint8"], epochs=1 << 30,
            seed=self.seed, path=path, device=str(self.dev))
        self.trainer = tr = Trainer(cfg, self.ds, val)
        self.w = gan_weights.for_config(c, self.seed, self.dev)
        self.sizes = {f"{net}.{k}": v.numel() for net in NETS
                      for k, v in self.w[net].items()}
        tr.model.load_state_dict(self.w["gen"], strict=True)
        tr.disc.load_state_dict(self.w["disc"], strict=True)
        tr.hned.load_state_dict(self.w["hned"], strict=True)
        tr.combined.vgg_model.load_state_dict(self.w["vgg"], strict=True)
        inner = tr._train_step
        tr._train_step = self._recording(inner)
        tr.set_epoch(0)
        tr.train()
        tr._train_step = inner
        self.epoch = 1
        self.ds.length = t["epoch_steps"] * self.batch
        sync(self.dev)

    def _recording(self, step):
        """``step`` that keeps, for the check, each of the first steps' G
        and D loss, both nets' first gradient and each leaf's change after
        the first steps."""
        tr, b1 = self.trainer, self.cell.traffic["beta1"]
        self.prog = {"losses": [], "d_losses": []}

        def leaves(state):
            return ((net, k, v) for net in NETS
                    for k, v in getattr(state, net).params.items())

        def recording(state, batch):
            state, metrics = step(state, batch)
            s = tr.global_step
            if s <= WARM_STEPS:
                self.prog["losses"].append(metrics["loss"].detach())
                self.prog["d_losses"].append(metrics["loss_d"].detach())
            if s == 1:
                self.prog["grad_norms"] = {
                    f"{net}.{k}": (m.float() / (1 - b1)).norm()
                    for net in NETS
                    for k, m in getattr(state, net).opt_state["mu"].items()}
            if s == WARM_STEPS:
                self.prog["change_norms"] = {
                    f"{net}.{k}": (p.detach() - self.w[net][k]).norm()
                    for net, k, p in leaves(state)}
            return state, metrics
        return recording

    def layer_context(self, trace) -> dict:
        c, t = self.cell.config, self.cell.traffic
        st = self.trainer.epoch_stats
        counted = {k[len(FORWARDS):]: v for k, v in st.items()
                   if k.startswith(FORWARDS)}
        return dict(kind="train", window=self.win, trace=trace,
                    counters=self.moved, steps=self.slice_steps,
                    norm_launches=(gan_counts.step_norm_launches(c, t)
                                   * self.slice_steps),
                    flops_per_step=gan_counts.step_flops(c, t),
                    disc_forwards=counted or None, epoch_steps=st["steps"],
                    disc_roles=gan_counts.roles(c))

    def release(self) -> None:
        self.prog["d_losses"] = [float(v) for v in self.prog["d_losses"]]
        super().release()

    def check(self) -> dict:
        return compare(self.prog, self.follow(), self.sizes)

    def follow(self, q=None, rows: int = 0, fault=None) -> dict:
        """The reference's first steps (``q``: the control's rounding;
        ``rows``: a batch cut to its first rows; ``fault``: a planted
        fault of ``resnet_gan.FAULTS``)."""
        c, t = self.cell.config, self.cell.traffic
        batches = first_batches(self.cell, self.seed, self.dev, self.imgs,
                                self.segs, self.ds)
        for b in batches:
            b["n"] = rows or b["n"]
        return resnet_gan.follow(
            self.w["gen"], self.w["disc"], self.w["hned"], self.w["vgg"],
            batches, t["lr"], t["beta1"], t["check_block"], c["gan_mode"],
            c["loss_weights"], q, fault)


# ---- shared with the control script and the tests -------------------------

def first_batches(cell, seed: int, dev, imgs, segs, ds) -> List[dict]:
    """The first ``WARM_STEPS`` steps' rows (the loader's shuffle of epoch
    0) and coins, as ``resnet_gan.follow`` takes them."""
    b = cell.traffic["batch"]
    order = ref.epoch_order(seed, 0, WARM_STEPS * b)
    out = []
    for s in range(1, WARM_STEPS + 1):
        idx = [ds.scene_of(int(i)) for i in order[(s - 1) * b:s * b]]
        out.append({"imgs": torch.from_numpy(imgs[idx]).to(dev).float()
                    / 255.0,
                    "segs": torch.from_numpy(segs[idx]).to(dev).long(),
                    "coin": ref.flip_coin(seed, s), "n": b})
    return out


def _of(d: dict, net: str) -> dict:
    """The entries of ``net``'s leaves, by leaf name."""
    return {k.split(".", 1)[1]: v for k, v in d.items()
            if k.split(".", 1)[0] == net}


def leaf_gaps(prog: dict, res: dict):
    """The ``train`` driver's gaps of each leaf's first gradient and change,
    each net's against its own median leaf, keyed ``<net>.<leaf>``."""
    grad, change = {}, {}
    for net in NETS:
        def sub(r, net=net):
            return {key: _of(r[key], net)
                    for key in ("grad_norms", "change_norms")}
        g, c = _train.leaf_gaps(sub(prog), sub(res))
        grad.update({f"{net}.{k}": v for k, v in g.items()})
        change.update({f"{net}.{k}": v for k, v in c.items()})
    return grad, change


def compare(prog: dict, res: dict, sizes) -> dict:
    """The numbers the check compares: the ``train`` driver's three for the
    generator, and the widest first-gradient gap and the median change gap
    of the discriminator's leaves (PERF.md gives the readings)."""
    grad, change = leaf_gaps(prog, res)
    g, d = _of(grad, "gen"), _of(grad, "disc")
    return {"worst_grad_gap": max(g.values()),
            "worst_tensor_grad_gap": max(v for k, v in g.items()
                                         if sizes[f"gen.{k}"] > 1),
            "median_change_gap": statistics.median(
                _of(change, "gen").values()),
            "worst_disc_grad_gap": max(d.values()),
            "median_disc_change_gap": statistics.median(
                _of(change, "disc").values())}
