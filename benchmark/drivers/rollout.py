"""Traffic kind ``rollout``: requests to the port's ``LayoutPredictor``
(edge mode: HED on the seed frames and on every generated frame) at a rate
fixed in the traffic file.

Set-up makes the weights and a pool of ``pool_requests`` distinct requests
(``batch`` sequences each: two seed frames and layouts of scenes from the
seed), builds the predictor and warms it up on two requests. The window
offers request j at j / rate from one client in order: a request waits
until it is due and until the one before it has been answered. Its
latency runs from the moment it was due to the returned arrays. A request
due inside the window is served if it started inside the window, or, with
``drain``, in any case. The rate is taken over all the requests served and
the time until the last one was answered.

The output check takes ``check_requests`` of the served requests, drawn
from the seed by reservoir sampling, and judges every served frame and
layout of them against the reference (``reference/rollout.py``).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import scenes, weights
from benchmark.harness import sync
from benchmark.reference import counts, nets, rollout as ref_rollout
from benchmark.reference.train import Nets
from benchmark.trace import TRACE_TRIES, profiled


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        t = cell.traffic
        self.batch, self.n_frames = t["batch"], t["n_frames"]
        self.hw = tuple(cell.config["image_hw"])

    # ---- set-up -------------------------------------------------------
    def setup(self) -> None:
        from video_layout_generation_tpu_torch.models import HNED
        from video_layout_generation_tpu_torch.serving import LayoutPredictor
        c, t = self.cell.config, self.cell.traffic
        self.w = weights.for_config(c, self.seed, self.dev, ("gen", "hned"))
        cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
        bf16 = c["compute_dtype"] == "bfloat16"
        self.pred = LayoutPredictor(
            c["arch"], cpu(self.w["gen"]), n_frames=self.n_frames,
            batch=self.batch, image_hw=self.hw,
            filters_level=tuple(c["filters_level"]),
            use_bf16=bf16, hned=HNED(dtype=torch.bfloat16 if bf16 else None),
            hned_params=cpu(self.w["hned"]),
            use_edges=c["edge"], quantize_transfer=t["quantize_transfer"],
            n_classes=c["n_classes"], device=str(self.dev))
        self.pool = request_pool(c, t, self.seed, self.dev)
        for j in range(2):
            self.pred.predict(*self.pool[j % len(self.pool)])
        sync(self.dev)

    def arrivals(self, seconds: float) -> np.ndarray:
        """Due times (s from the window's start) of the requests due in
        the window."""
        rate = self.cell.traffic["rate_per_s"]
        due = np.arange(int(np.ceil(seconds * rate)) + 1) / rate
        return due[due < seconds]

    # ---- the window ---------------------------------------------------
    def window(self, seconds: float) -> dict:
        t = self.cell.traffic
        due = self.arrivals(seconds)
        order = np.random.default_rng([self.seed, 2]).permutation(
            len(self.pool))
        keep, rng = t["check_requests"], np.random.default_rng([self.seed, 3])
        self.kept: List[tuple] = []
        lat, service = [], []
        t0 = time.perf_counter()
        end = t0
        for j, d in enumerate(due):
            now = time.perf_counter()
            if now < t0 + d:
                time.sleep(t0 + d - now)
            start = time.perf_counter()
            if not t["drain"] and start - t0 >= seconds:
                break
            req = int(order[j % len(order)])
            out = self.pred.predict(*self.pool[req])
            end = time.perf_counter()
            lat.append(end - t0 - d)
            service.append(end - start)
            # reservoir sampling: every served request equally likely kept
            if j < keep:
                self.kept.append((req, out))
            else:
                r = int(rng.integers(0, j + 1))
                if r < keep:
                    self.kept[r] = (req, out)
        served = len(lat)
        wall = end - t0
        frames = served * self.batch * self.n_frames
        self.win = dict(requests=served, wall_s=wall, latency_s=lat,
                        service_s=service)
        p95 = float(np.percentile(np.asarray(lat) * 1e3, 95,
                                  method="inverted_cdf"))
        return {"metrics": {"rollout_frames_per_s": frames / wall,
                            "rollout_p95_ms": p95},
                "attempted": served, "failed": 0}

    # ---- the traced slice ---------------------------------------------
    def profile(self, counters: Dict[str, tuple]):
        from torch.profiler import record_function
        from video_layout_generation_tpu_torch.ops.kernels import (
            launch_counts)
        n = self.cell.traffic["profile_requests"]

        def requests():
            for j in range(n):
                with record_function("bench.request"):
                    self.pred.predict(*self.pool[j % len(self.pool)])

        for attempt in range(TRACE_TRIES):
            before = launch_counts()
            _, trace = profiled(requests, lambda: sync(self.dev))
            after = launch_counts()
            self.moved = {k: after[k] - before[k] for k in after}
            if all(trace.count(p) == self.moved.get(name, 0)
                   for name, p in counters.items()):
                break
            print(f"profile: the trace missed launches, taking it again "
                  f"({attempt + 1})", file=sys.stderr, flush=True)
        self.slice_requests = n
        return trace

    def layer_context(self, trace) -> dict:
        c, t = self.cell.config, self.cell.traffic
        return dict(kind="rollout", window=self.win, trace=trace,
                    counters=self.moved,
                    conv_launches=(launches_per_request(c, t)
                                   * self.slice_requests),
                    flops_per_request=request_flops(c, t))

    def release(self) -> None:
        del self.pred

    # ---- the output check ---------------------------------------------
    def check(self) -> dict:
        return judge(self.cell, self.w, self.pool, self.kept, self.dev)


# ---- shared with the control script and the tests -------------------------

def request_pool(config: dict, traffic: dict, seed: int, dev) -> list:
    """``pool_requests`` requests of ``batch`` sequences: float frames in
    [0, 1] (N, H, W, 3) and int32 layouts (N, H, W), two of each."""
    n, b = traffic["pool_requests"], traffic["batch"]
    imgs, segs = scenes.render(seed, n * b, 2, tuple(config["image_hw"]),
                               config["n_classes"], device=dev)
    f = imgs.astype(np.float32) / 255.0
    s = segs.astype(np.int32)
    return [(f[j * b:(j + 1) * b, 0], f[j * b:(j + 1) * b, 1],
             s[j * b:(j + 1) * b, 0], s[j * b:(j + 1) * b, 1])
            for j in range(n)]


def judge(cell, w: dict, pool: list, kept: list, dev, cand=None) -> dict:
    """Widest layout gap and frame error over the kept requests, in blocks
    of ``check_block`` sequences (float32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Nets(w["gen"], w["hned"], None)
    block = cell.traffic["check_block"]
    out = {"layout_gap": 0.0, "frame_err": 0.0}
    for req, (frames, layouts) in kept:
        i1, i2, s1, s2 = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in pool[req])
        fr = torch.from_numpy(frames).to(dev)
        ly = torch.from_numpy(layouts).to(dev)
        for r0 in range(0, fr.shape[0], block):
            r = slice(r0, r0 + block)
            got = ref_rollout.readings(ref, i1[r], i2[r], s1[r].long(),
                                       s2[r].long(), fr[r], ly[r], cand)
            for k in out:
                out[k] = max(out[k], got[k])
    return out


def _meta_inputs(config: dict, b: int):
    h, w = config["image_hw"]
    rgb = torch.empty((b, h, w, 3), device="meta")
    ids = torch.zeros((b, h, w), dtype=torch.long, device="meta")
    return rgb, rgb, ids, ids


def launches_per_request(config: dict, traffic: dict) -> list:
    """Kernel A and B launches of one request: GridNet a frame, HED on the
    two seeds and on every generated frame (the port computes the last
    frame's edges too)."""
    n = counts.net_launches(config, traffic["batch"])
    t = traffic["n_frames"]
    return n["gen"] * t + n["hned"] * (t + 2)


def request_flops(config: dict, traffic: dict) -> int:
    """Model FLOPs of one request: the reference's free-running rollout
    (which leaves out the unread edges of the last frame)."""
    nt = Nets(counts.meta_params(nets.gridnet_spec(
        config["n_channels"], config["filters_level"],
        config["arch"] == "CoordGridNet")),
        counts.meta_params(nets.hned_spec()), None)
    return counts.model_flops(lambda: ref_rollout.request(
        nt, *_meta_inputs(config, traffic["batch"]), traffic["n_frames"]))
