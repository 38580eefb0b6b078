"""Traffic kind ``train_resnet``: epochs of the port's ``Trainer`` with
``--arch ResnetGenerator``, on scenes made from the seed.

The loop, the traced slice and the output check are the ``train`` driver's
(``train.py``, imported from beside this file): a first epoch of
``WARM_STEPS`` steps in the set-up that the check follows, then whole
epochs of ``epoch_steps`` steps in the window. What differs is the
generator: the ``Trainer`` is built as the CLI builds it for
``--arch ResnetGenerator --ngf <ngf> --norm instance``, its weights come
from ``resnet_weights.py``, the reference that follows its first steps is
``reference/resnet_gen.py``, and the work a step does (model FLOPs and the
InstanceNorm kernels' launches) is counted by ``reference/resnet_counts``.

The traced slice's readers get, besides the ``train`` driver's window and
trace: ``norm_launches``, the InstanceNorm launches the reference lists for
the slice's steps; ``flops_per_step``; and ``steps``, the slice's steps.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

from benchmark import resnet_weights, scenes
from benchmark.harness import load_module, sync
from benchmark.reference import resnet_counts, resnet_gen

_train = load_module(Path(__file__).with_name("train.py"),
                     "bench_driver_train")
WARM_STEPS, SceneDataset, first_batches = (_train.WARM_STEPS,
                                           _train.SceneDataset,
                                           _train.first_batches)
# the check's numbers, which control.py reads from a driver module
compare, gap, leaf_gaps = _train.compare, _train.gap, _train.leaf_gaps


class Driver(_train.Driver):
    def setup(self) -> None:
        from video_layout_generation_tpu_torch.config import Config
        from video_layout_generation_tpu_torch.train.trainer import Trainer
        c, t = self.cell.config, self.cell.traffic
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
            init_gain=c["init_gain"], image_size=self.hw,
            n_classes=c["n_classes"], compute_dtype=c["compute_dtype"],
            w_l1=w[0], w_style=w[1], w_seg=w[2], batch_size=self.batch,
            lr=t["lr"], beta1=t["beta1"], print_freq=t["print_freq"],
            workers=t["workers"], put_thread=t["put_thread"],
            transfer_uint8=t["transfer_uint8"], epochs=1 << 30,
            seed=self.seed, path=path, device=str(self.dev))
        self.trainer = tr = Trainer(cfg, self.ds, val)
        self.w = resnet_weights.for_config(c, self.seed, self.dev)
        self.sizes = {k: v.numel() for k, v in self.w["gen"].items()}
        tr.model.load_state_dict(self.w["gen"], strict=True)
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

    def layer_context(self, trace) -> dict:
        c, t = self.cell.config, self.cell.traffic
        return dict(kind="train", window=self.win, trace=trace,
                    counters=self.moved, steps=self.slice_steps,
                    norm_launches=(resnet_counts.step_norm_launches(c, t)
                                   * self.slice_steps),
                    flops_per_step=resnet_counts.step_flops(c, t))

    def follow(self, q=None, rows: int = 0) -> dict:
        """The reference's first steps (``q``: the control's rounding;
        ``rows``: a batch cut to its first rows, for a planted fault)."""
        batches = first_batches(self.cell, self.seed, self.dev, self.imgs,
                                self.segs, self.ds)
        for b in batches:
            b["n"] = rows or b["n"]
        t = self.cell.traffic
        return resnet_gen.follow(self.w["gen"], self.w["hned"], self.w["vgg"],
                                 batches, t["lr"], t["beta1"],
                                 t["check_block"], q)
