"""Traffic kind ``train``: epochs of the port's ``Trainer`` on scenes made
from the seed.

Set-up builds one ``Trainer`` (through ``Config``, as the CLI does, with
the benchmark's own dataset), loads the benchmark's weights into its
generator, HED and VGG19, and runs a first epoch of ``WARM_STEPS`` steps
through ``Trainer.train``: it warms every shape, and its steps are the
ones the output check follows (the loss of each, the first gradient as
Adam's first moment holds it after step 1, each leaf's change after step
3). The window then runs whole epochs of ``epoch_steps`` steps (``set_epoch``
and ``train``, each ending in a fetch) until the seconds have passed.

The traffic file gives the batch, the optimizer, the loop's settings and,
for the rollout-fidelity recipe, ``multistep_k``, ``feedback_noise`` and
``remat``; the configuration the net, its input, the weights and the
scenes.
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import scenes, weights
from benchmark.harness import sync
from benchmark.reference import counts, nets, train as ref
from benchmark.trace import TRACE_TRIES, Slice

WARM_STEPS = 3          # the first epoch: the steps the check follows
UNMOVED = 1e-3          # a leaf whose gradient is under this share of the
                        # median leaf's moves by round-off alone


class SceneDataset:
    """Index i is scene ``i % len(scenes)``: a triplet (frames 0-2) or a
    window of ``n_frames`` frames, uint8, in the loader's contract. The
    length is set per epoch."""

    def __init__(self, imgs: np.ndarray, segs: np.ndarray, n_frames: int,
                 length: int):
        self.imgs, self.segs, self.n_frames = imgs, segs, n_frames
        self.length = length

    def __len__(self) -> int:
        return self.length

    def scene_of(self, i: int) -> int:
        return i % len(self.imgs)

    def __getitem__(self, i: int) -> dict:
        s = self.scene_of(i)
        im, sg = self.imgs[s], self.segs[s]
        if self.n_frames != 3:
            return {"imgs": im[:self.n_frames], "segs": sg[:self.n_frames]}
        return {"img1": im[0], "img2": im[1], "img3": im[2],
                "seg1": sg[0][..., None], "seg2": sg[1][..., None],
                "seg3": sg[2]}


class _SpanLoader:
    """The train loader with a ``bench.loader`` span around each batch."""

    def __init__(self, inner):
        self.inner = inner

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def __iter__(self):
        from torch.profiler import record_function
        it = iter(self.inner)
        while True:
            with record_function("bench.loader"):
                batch = next(it, None)
            if batch is None:
                return
            yield batch


def gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        c, t = cell.config, cell.traffic
        self.k = t.get("multistep_k", 1)
        self.n_frames = self.k + 2 if self.k > 1 else 3
        self.hw = tuple(c["image_hw"])
        self.batch = t["batch"]

    # ---- set-up -------------------------------------------------------
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
            image_size=self.hw, n_classes=c["n_classes"],
            filters_level=tuple(c["filters_level"]),
            compute_dtype=c["compute_dtype"], w_l1=w[0], w_style=w[1],
            w_seg=w[2], batch_size=self.batch, lr=t["lr"], beta1=t["beta1"],
            print_freq=t["print_freq"], workers=t["workers"],
            put_thread=t["put_thread"], transfer_uint8=t["transfer_uint8"],
            multistep_k=self.k,
            multistep_feedback_noise=t.get("feedback_noise", 0.0),
            multistep_remat=t.get("remat", True), epochs=1 << 30,
            seed=self.seed, path=path, device=str(self.dev))
        self.trainer = tr = Trainer(cfg, self.ds, val)
        self.w = weights.for_config(c, self.seed, self.dev)
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

    def _recording(self, step):
        """``step`` that keeps, for the check, each of the first steps'
        loss, the first gradient (Adam's first moment after step 1 over
        1 - beta1) and each leaf's change after step 3."""
        tr, b1 = self.trainer, self.cell.traffic["beta1"]
        self.prog = {"losses": []}

        def recording(state, batch):
            state, metrics = step(state, batch)
            s = tr.global_step
            if s <= WARM_STEPS:
                self.prog["losses"].append(metrics["loss"].detach())
            if s == 1:
                self.prog["grad_norms"] = {
                    k: (m.float() / (1 - b1)).norm()
                    for k, m in state.opt_state["mu"].items()}
            if s == WARM_STEPS:
                self.prog["change_norms"] = {
                    k: (p.detach() - self.w["gen"][k]).norm()
                    for k, p in state.params.items()}
            return state, metrics
        return recording

    # ---- the window ---------------------------------------------------
    def _epoch(self) -> dict:
        tr = self.trainer
        tr.set_epoch(self.epoch)
        self.epoch += 1
        tr.train()
        return dict(tr.epoch_stats)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        steps = samples = 0
        load_s = 0.0
        while True:
            st = self._epoch()
            steps += st["steps"]
            samples += st["samples"]
            load_s += st["load_s"]
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.dev)
        wall = time.perf_counter() - t0
        self.win = dict(steps=steps, samples=samples, wall_s=wall,
                        load_s=load_s)
        return {"metrics": {"train_samples_per_s": samples / wall},
                "attempted": steps, "failed": 0}

    # ---- the traced slice ---------------------------------------------
    def profile(self, counters: Dict[str, tuple]):
        """Steps 3 to 2 + ``profile_steps`` of an epoch, each with the wait
        for its batch: the slice starts when step 2 has been launched and
        ends in a sync after its last step. Taken again, in a further
        epoch, while the trace misses launches."""
        from torch.profiler import record_function
        from video_layout_generation_tpu_torch.ops.kernels import (
            launch_counts)
        tr = self.trainer
        step, loader = tr._train_step, tr.train_loader
        n, first = self.cell.traffic["profile_steps"], 2
        sl, got = Slice(), {}

        def spanned(state, batch):
            i = got.setdefault("i", 0)
            got["i"] = i + 1
            with record_function("bench.step"):
                out = step(state, batch)
            if i == first - 1:
                got["before"] = launch_counts()
                sl.start()
            elif i == first + n - 1:
                got["trace"] = sl.stop(lambda: sync(self.dev))
                after = launch_counts()
                got["moved"] = {k: after[k] - got["before"][k]
                                for k in after}
            return out

        tr._train_step, tr.train_loader = spanned, _SpanLoader(loader)
        try:
            for attempt in range(TRACE_TRIES):
                got.clear()
                self._epoch()
                trace, self.moved = got["trace"], got["moved"]
                if all(trace.count(pats) == self.moved.get(name, 0)
                       for name, pats in counters.items()):
                    break
                print(f"profile: the trace missed launches, taking it "
                      f"again ({attempt + 1})", file=sys.stderr, flush=True)
        finally:
            tr._train_step, tr.train_loader = step, loader
        self.slice_steps = n
        return trace

    def layer_context(self, trace) -> dict:
        per_step = launches_per_step(self.cell.config, self.cell.traffic)
        return dict(kind="train", window=self.win, trace=trace,
                    counters=self.moved,
                    conv_launches=per_step * self.slice_steps,
                    flops_per_step=step_flops(self.cell.config,
                                              self.cell.traffic))

    def release(self) -> None:
        self.prog["losses"] = [float(v) for v in self.prog["losses"]]
        for key in ("grad_norms", "change_norms"):
            self.prog[key] = {k: float(v) for k, v in self.prog[key].items()}
        del self.trainer
        shutil.rmtree(self.path, ignore_errors=True)

    # ---- the output check ---------------------------------------------
    def check(self) -> dict:
        return compare(self.prog, self.follow(), self.sizes)

    def follow(self, q=None, rows: int = 0) -> dict:
        """The reference's first steps (``q``: the control's rounding;
        ``rows``: a batch cut to its first rows, for a planted fault)."""
        batches = first_batches(self.cell, self.seed, self.dev, self.imgs,
                                self.segs, self.ds)
        for b in batches:
            b["n"] = rows or b["n"]
        return follow(self.cell, self.dev, self.w, batches, q)


# ---- shared with the control script and the tests -------------------------

def first_batches(cell, seed: int, dev, imgs, segs, ds) -> List[dict]:
    """The first ``WARM_STEPS`` steps as the reference runs them: each
    step's rows (the loader's shuffle of epoch 0), coin and noise."""
    c, t = cell.config, cell.traffic
    k, b = t.get("multistep_k", 1), t["batch"]
    order = ref.epoch_order(seed, 0, WARM_STEPS * b)
    out = []
    for s in range(1, WARM_STEPS + 1):
        idx = [ds.scene_of(int(i)) for i in order[(s - 1) * b:s * b]]
        im = torch.from_numpy(imgs[idx]).to(dev).float() / 255.0
        sg = torch.from_numpy(segs[idx]).to(dev).long()
        coin = ref.flip_coin(seed, s)
        w = c["loss_weights"]
        if k > 1:
            noise = ref.feedback_noise(seed, s, k, b, c["image_hw"], dev)
            sigma = t["feedback_noise"]
            loss_of = (lambda nt, rows, im=im, sg=sg, coin=coin, noise=noise:
                       ref.kstep_loss(nt, im[rows], sg[rows], coin,
                                      noise[:, rows], sigma, k, w))
        else:
            loss_of = (lambda nt, rows, im=im, sg=sg, coin=coin:
                       ref.triplet_loss(nt, im[rows, :3], sg[rows, :3], coin,
                                        w))
        out.append({"loss_of": loss_of, "n": b})
    return out


def follow(cell, dev, w: dict, batches: List[dict], q=None) -> dict:
    """The reference's steps of ``batches`` from the initial weights ``w``
    (float32, TF32 off; ``q``: the control's rounding)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = {k: v.detach().clone().float() for k, v in w["gen"].items()}
    nt = ref.Nets(gen, w["hned"], w["vgg"], q=q)
    return ref.follow_steps(nt, batches, cell.traffic["lr"],
                            cell.traffic["beta1"],
                            cell.traffic["check_block"])


def leaf_gaps(prog: dict, res: dict):
    """Each leaf's gap of its first-gradient norm (the program's from
    Adam's first moment after step 1) and of its change over the first
    steps, measured against the reference's norm of that leaf or of the
    median leaf, whichever is larger. The change leaves out the leaves
    whose reference gradient is under ``UNMOVED`` of the median leaf's:
    Adam moves those by round-off alone."""
    g_ref, c_ref = res["grad_norms"], res["change_norms"]
    g_med = statistics.median(g_ref.values())
    moved = [k for k in c_ref if g_ref[k] >= UNMOVED * g_med]
    c_med = statistics.median(c_ref[k] for k in moved)
    grad = {k: gap(prog["grad_norms"][k], g_ref[k], g_med) for k in g_ref}
    change = {k: gap(prog["change_norms"][k], c_ref[k], c_med)
              for k in moved}
    return grad, change


def compare(prog: dict, res: dict, sizes: Dict[str, int]) -> dict:
    """The numbers the check compares, each a relative gap from the
    reference (``sizes``: each leaf's number of elements; PERF.md gives
    the readings behind this choice):

    - ``worst_grad_gap``: the widest over the generator's leaves of the
      first gradient's gap. That leaf is a PReLU slope, one number summed
      over a whole tensor, on every seed read;
    - ``worst_tensor_grad_gap``: the same over the leaves of more than
      one number, which read less than the slopes and are held tighter;
    - ``median_change_gap``: the median over the leaves of the gap of a
      leaf's change after the first steps, which holds the update itself
      (the learning rate, both moments, the bias correction, the write).
      The widest leaf's change is a slope or a bias, and reads as far from
      the reference in sound runs as in the control's.

    The losses are not compared: the first step's reads as far from the
    reference in sound runs as in the control's, and half the batch can
    read under ten times the sound runs' largest."""
    grad, change = leaf_gaps(prog, res)
    return {"worst_grad_gap": max(grad.values()),
            "worst_tensor_grad_gap": max(v for k, v in grad.items()
                                         if sizes[k] > 1),
            "median_change_gap": statistics.median(change.values())}


def launches_per_step(config: dict, traffic: dict) -> list:
    """Kernel A and B launches of one train step at the cell's shapes."""
    k = traffic.get("multistep_k", 1)
    again = 2 if k > 1 and traffic.get("remat", True) else 1  # recomputed
    n = counts.net_launches(config, traffic["batch"])
    return (n["gen"] * (k * again) + n["hned"] * (k + 1)
            + n["vgg"] * (2 * k * again) + n["vgg_dgrad"] * k)


def step_flops(config: dict, traffic: dict) -> int:
    """Model FLOPs of one train step: the reference's forward and backward
    at the cell's batch, with no recomputation."""
    b, hw = traffic["batch"], tuple(config["image_hw"])
    k = traffic.get("multistep_k", 1)
    gen = counts.meta_params(nets.gridnet_spec(
        config["n_channels"], config["filters_level"],
        config["arch"] == "CoordGridNet"))
    for v in gen.values():
        v.requires_grad_(True)
    nt = ref.Nets(gen, counts.meta_params(nets.hned_spec()),
                  counts.meta_params(nets.vgg_spec()))
    frames = k + 2 if k > 1 else 3
    imgs = torch.empty((b, frames) + hw + (3,), device="meta")
    segs = torch.zeros((b, frames) + hw, dtype=torch.long, device="meta")
    w = config["loss_weights"]

    def step():
        if k > 1:
            noise = torch.empty((k - 1, b) + hw + (3,), device="meta")
            loss = ref.kstep_loss(nt, imgs, segs, False, noise, 0.1, k, w)
        else:
            loss = ref.triplet_loss(nt, imgs, segs, False, w)
        torch.autograd.grad(loss.sum(), list(gen.values()))
    return counts.model_flops(step)
