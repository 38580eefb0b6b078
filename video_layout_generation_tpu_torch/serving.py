"""Serving API: GridNet layout/frame futures from flax weights (the JAX
package's ``serving.py``).

One ``LayoutPredictor`` owns a GridNet on one device and answers batched
requests at a fixed batch: a smaller request is padded to it by repeating
its last example, and the padding is sliced off on the device before the
fetch. A request goes up as one packed array and comes back as one packed
array; with ``quantize_transfer`` both are uint8 (frames at 1/255, layout
ids exact while ``n_classes <= 256``).

``use_edges=True`` serves the 10-channel model as it was trained: the
frozen HNED edge net runs on the seed frames and on every generated frame
inside the rollout (``train/rollout.py``).

``mesh=make_mesh(...)`` (``parallel/mesh.py``) serves on every device of
the mesh from this one process, as the JAX package shards the request
batch over the mesh's ``data`` axis with replicated parameters: each
device holds a replica of the nets and answers its slice of the padded
request, launched on that device, and the rows are gathered in order on
the first device before the one fetch. A mesh of one device is the path
without a mesh.

On a CUDA device with the kernels (not ``plain``) the rollout is replayed
from CUDA graphs: the first request of a packed input shape and dtype runs
eagerly on the stream the graphs are captured on (it builds the kernels,
fills the caches of constants and interpolation matrices and lets the
libraries choose their algorithms), the second captures a chain of graphs in one memory pool, one for the
input stage (the uint8 cast, the normalisation, the seed frames' edges)
and one a generated frame, each reading the static outputs of the one
before, and every later one uploads into the chain's static input and
replays it. The frames are stacked and packed eagerly after the replay,
so a result outside the pool outlives the next request's replay. A
capture that fails raises. ``rollouts`` counts the requests served by
replay and by an eager run, and the captures.

Under a profiler each request records ``serve.request``, holding
``serve.pack``, ``serve.upload``, ``serve.rollout`` (the rollout's
``rollout.frame`` spans), ``serve.fetch`` and ``serve.decode``. A replayed
``rollout.frame`` is the host's replay of that frame's graph: it holds no
``rollout.step`` or ``rollout.edge``.

Example:
    from video_layout_generation_tpu_torch.io.weights import params_from_flax
    state = params_from_flax(flat_npz_of_an_8_channel_gridnet)
    predictor = LayoutPredictor("GridNet", state)
    frames, layouts = predictor.predict(img1, img2, seg1, seg2)
"""

from __future__ import annotations

import contextlib
import copy
from collections import deque
from typing import Mapping, Tuple

import numpy as np
import torch

from .device import require_bf16, resolve_device
from .io.checkpoint import CheckpointManager
from .io.weights import params_from_flax
from .models import get_model_cls
from .ops.kernels import add_launch_counts, launch_counts
from .parallel.mesh import shard_batch
from .train.assemble import denormalize_image, normalize_image
from .train.rollout import make_rollout_fn
from .utils.profiling import annotate


class LayoutPredictor:
    def __init__(self, arch: str, params: Mapping, n_frames: int = 8,
                 batch: int = 16, image_hw=(256, 256),
                 filters_level=(32, 64, 96), use_bf16: bool = True,
                 hned=None, hned_params=None, use_edges: bool = False,
                 edge_scale: int = 1, quantize_transfer: bool = False,
                 n_classes: int = 20, upsample: str = "bilinear",
                 mesh=None, device="cuda", plain: bool = False):
        """``params``: the flax tree, its flat ``"/"``-joined form, or a
        state dict from ``params_from_flax``, of an 8-channel GridNet (the
        no-edge rollout's input) or, with ``use_edges``, of a 10-channel
        one. ``hned`` is then a port HNED, and ``hned_params`` (same forms)
        is loaded into it when given. ``plain=True`` runs the kernels'
        plain PyTorch versions (the on-card reference)."""
        if arch not in ("GridNet", "CoordGridNet"):
            raise ValueError(f"serving supports GridNet archs, got {arch}")
        if mesh is not None and batch % mesh.size != 0:
            raise ValueError(f"compiled batch {batch} must be divisible "
                             f"by the mesh size {mesh.size}")
        if use_edges and hned is None:
            raise ValueError("use_edges requires an HNED model")
        devices = ([resolve_device(d) for d in mesh.devices]
                   if mesh is not None else [resolve_device(device)])
        self.mesh = mesh
        self.device = devices[0]
        self.arch = arch
        self.n_frames = n_frames
        self.batch = batch
        self.quantize_transfer = quantize_transfer
        self.n_classes = n_classes
        self.hw = tuple(image_hw)
        dtype = torch.bfloat16 if use_bf16 else None
        self.model = get_model_cls(arch)(
            n_channels=10 if use_edges else 8,
            filters_level=tuple(filters_level), dtype=dtype)
        self.model.load_state_dict(params_from_flax(params), strict=True)
        self.model.to(self.device).eval()
        self.hned = None
        if use_edges:
            if hned_params is not None:
                hned.load_state_dict(params_from_flax(hned_params),
                                     strict=True)
            self.hned = hned.to(self.device).eval()
        if not plain:
            require_bf16(self.device, {"GridNet": self.model,
                                       "HNED": self.hned})
        self._rollout = make_rollout_fn(
            self.model, self.hned, n_frames=n_frames, use_edges=use_edges,
            upsample=upsample, plain=plain, edge_scale=edge_scale)
        # uint8 both ways; n_classes > 256 would wrap ids in uint8
        self._quantized_serve = quantize_transfer and n_classes <= 256
        # one a device, the first one's nets the above
        self._replicas = [_Replica(self.device, self._rollout, self._inputs,
                                   plain)]
        for dev in devices[1:]:
            model = copy.deepcopy(self.model).to(dev)
            hned_r = (copy.deepcopy(self.hned).to(dev)
                      if self.hned is not None else None)
            self._replicas.append(_Replica(dev, make_rollout_fn(
                model, hned_r, n_frames=n_frames, use_edges=use_edges,
                upsample=upsample, plain=plain, edge_scale=edge_scale),
                self._inputs, plain))
        self.rollouts = {"replayed": 0, "eager": 0, "captured": 0}

    @classmethod
    def from_checkpoint(cls, path: str, arch: str = "GridNet",
                        **kw) -> "LayoutPredictor":
        """A predictor from a checkpoint of the port's ``Trainer`` (a tag
        directory such as ``<exp>/checkpoint/latest``) or a flat npz
        snapshot, with the architecture saved in it."""
        tree = CheckpointManager.restore_path(path)
        if tree.get("arch") not in (arch, None):
            arch = tree["arch"]
        return cls(arch, tree["params"], **kw)

    def _inputs(self, x: torch.Tensor):
        """The rollout's seeds (img1, img2, seg1, seg2) from packed rows."""
        if self._quantized_serve:
            x = x.float()
            x = torch.cat([x[..., 0:6] / 255.0, x[..., 6:8]], dim=-1)
        i1 = normalize_image(x[..., 0:3])
        i2 = normalize_image(x[..., 3:6])
        return i1, i2, x[..., 6:7], x[..., 7:8]

    @torch.inference_mode()
    def _serve(self, x: np.ndarray, n: int) -> torch.Tensor:
        """One packed request on the device(s) -> one packed result on the
        first one."""
        with annotate("serve.upload"):
            shards = ([self._replicas[0].upload(torch.from_numpy(x))]
                      if self.mesh is None
                      else [rep.upload(sh["x"]) for rep, sh in zip(
                          self._replicas, shard_batch({"x": x}, self.mesh))])
        with annotate("serve.rollout"):
            outs, how = zip(*(rep.run(part) for rep, part
                              in zip(self._replicas, shards)))
            self.rollouts["captured"] += how.count("captured")
            self.rollouts["eager" if "eager" in how else "replayed"] += 1
            if len(outs) == 1:
                imgs, segs = outs[0]
            else:   # the replicas' rows, in order
                imgs, segs = (torch.cat([o[j].to(self.device) for o in outs])
                              for j in (0, 1))
            f = denormalize_image(imgs[:n]).clamp(0.0, 1.0)
            lay = segs[:n]
            if self._quantized_serve:
                return torch.cat([(f * 255.0 + 0.5).to(torch.uint8),
                                  lay.to(torch.uint8)], dim=-1)
            return torch.cat([f, lay], dim=-1)

    def _enqueue(self, img1, img2, seg1, seg2) -> torch.Tensor:
        """Pack one request, upload it and launch its rollout."""
        with annotate("serve.pack"):
            x, n = self._pack_request(img1, img2, seg1, seg2)
        return self._serve(x, n)

    def _fetch(self, out: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch one packed result to the host and decode it."""
        with annotate("serve.fetch"):
            out = out.cpu().numpy()
        with annotate("serve.decode"):
            return self._decode_out(out)

    def _pack_request(self, img1, img2, seg1, seg2):
        """Host-side packing of one request into the single upload array."""
        n = img1.shape[0]
        if n > self.batch:
            raise ValueError(f"request batch {n} > compiled batch "
                             f"{self.batch}; shard the request")

        def pad(x):
            if x.shape[0] == self.batch:
                return x
            return np.concatenate(
                [x, np.repeat(x[-1:], self.batch - x.shape[0], axis=0)])

        x = np.concatenate(
            [pad(np.asarray(img1, np.float32)),
             pad(np.asarray(img2, np.float32)),
             pad(np.asarray(seg1, np.float32))[..., None],
             pad(np.asarray(seg2, np.float32))[..., None]], axis=-1)
        if self._quantized_serve:
            x = np.concatenate(
                [x[..., 0:6] * 255.0 + 0.5, x[..., 6:8]],
                axis=-1).astype(np.uint8)
        return x, n

    def _decode_out(self, out: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side decode of the single fetched array."""
        if self._quantized_serve:
            frames = out[..., :3].astype(np.float32) / 255.0
        else:
            frames = out[..., :3]
        return frames, out[..., 3].astype(np.int32)

    def predict(self, img1: np.ndarray, img2: np.ndarray,
                seg1: np.ndarray, seg2: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """img*: (N, H, W, 3) RGB in [0,1]; seg*: (N, H, W) int class ids.
        Returns (frames (N, T, H, W, 3) in [0,1], layouts (N, T, H, W))."""
        with annotate("serve.request"):
            return self._fetch(self._enqueue(img1, img2, seg1, seg2))

    def predict_pipelined(self, requests, depth: int = 2):
        """Yield one (frames, layouts) per request, in order, with up to
        ``depth`` requests enqueued on the device at a time: kernel launches
        return before the device finishes, so request i+1 is packed,
        uploaded and enqueued while request i still computes. Results equal
        per-request ``predict`` calls."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        return self._predict_pipelined(requests, depth)

    def predict_many(self, img1, img2, seg1, seg2, depth: int = 2
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Requests larger than the fixed batch: split into batch-sized
        chunks, pipeline them and reassemble (N, ...) outputs."""
        n = img1.shape[0]
        b = self.batch
        chunks = ((img1[i:i + b], img2[i:i + b],
                   seg1[i:i + b], seg2[i:i + b])
                  for i in range(0, n, b))
        outs = list(self.predict_pipelined(chunks, depth=depth))
        frames = np.concatenate([f for f, _ in outs])
        layouts = np.concatenate([l for _, l in outs])
        return frames, layouts

    def _predict_pipelined(self, requests, depth: int):
        # a request's ``serve.request`` span covers its enqueue; its fetch
        # and decode come later, when the pipeline hands it out
        inflight = deque()
        for req in requests:
            if len(inflight) >= depth:
                yield self._fetch(inflight.popleft())
            with annotate("serve.request"):
                inflight.append(self._enqueue(*req))
        while inflight:
            yield self._fetch(inflight.popleft())


class _Replica:
    """One device's rollout, and the CUDA graphs of it (``_RolloutGraphs``)
    for each packed input shape and dtype seen twice, where the device is a
    card and the kernels run (not ``plain``)."""

    def __init__(self, dev: torch.device, rollout, inputs, plain: bool):
        self.dev, self.rollout, self.inputs = dev, rollout, inputs
        # the stream the graphs are captured on, where there are graphs;
        # the eager rollouts run on it too, so that a capture follows the
        # libraries' first use of the stream
        self.stream = (torch.cuda.Stream(dev)
                       if dev.type == "cuda" and not plain else None)
        self.seen = set()
        self.graphs = {}

    def upload(self, x: torch.Tensor) -> torch.Tensor:
        """Packed rows ``x`` on this device: into the static input of the
        graphs of their shape and dtype where there are graphs."""
        g = self.graphs.get((tuple(x.shape), x.dtype))
        return x.to(self.dev) if g is None else g.x.copy_(x)

    def run(self, x: torch.Tensor):
        """((frames, layouts), how) of packed rows ``x`` on this device;
        ``how`` is "eager", "captured" (then replayed) or "replayed"."""
        key = (tuple(x.shape), x.dtype)
        on_card = (torch.cuda.device(self.dev) if self.dev.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            g = self.graphs.get(key)
            how = "replayed"
            if g is None and self.stream is not None and key in self.seen:
                g = self.graphs[key] = _RolloutGraphs(
                    x, self.inputs, self.rollout, self.stream)
                how = "captured"
            self.seen.add(key)
            if g is not None:
                return self.rollout.finish(*g.replay()), how
            if self.stream is None:
                return self.rollout(*self.inputs(x)), "eager"
            here = torch.cuda.current_stream()
            self.stream.wait_stream(here)
            with torch.cuda.stream(self.stream):
                out = self.rollout(*self.inputs(x))
            here.wait_stream(self.stream)
            return out, "eager"


class _RolloutGraphs:
    """A rollout at one packed input as a chain of CUDA graphs in one memory
    pool: the input stage (``inputs``, then the rollout's ``start``), then
    one graph for each ``frame``, each reading the static outputs of the
    one before, so the carry needs no copies. ``x`` (the capture's
    request) becomes the static input that later uploads land in.

    Blocks that one capture frees, a later one may reuse: the chain is
    replayed whole, in the order of capture, on one stream. The launch
    counters move on every replay by what the graph launches."""

    def __init__(self, x: torch.Tensor, inputs, rollout,
                 stream: torch.cuda.Stream):
        self.x = x
        pool = torch.cuda.graph_pool_handle()

        def capture(fn, *args):
            g = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.cuda.graph(g, pool=pool, stream=stream):
                out = fn(*args)
            moved = {k: v - before[k] for k, v in launch_counts().items()
                     if v != before[k]}
            add_launch_counts({k: -v for k, v in moved.items()})
            return (g, moved), out

        self.seeds, carry = capture(lambda: rollout.start(*inputs(x)))
        self.frames, self.imgs, self.segs = [], [], []
        for _ in range(rollout.n_frames):
            graph, (carry, img, seg) = capture(rollout.frame, carry)
            self.frames.append(graph)
            self.imgs.append(img)
            self.segs.append(seg)

    def replay(self):
        """Replay the chain on the current stream; the static frames and
        layouts, which the next replay overwrites."""
        g, moved = self.seeds
        g.replay()
        add_launch_counts(moved)
        for g, moved in self.frames:
            with annotate("rollout.frame"):
                g.replay()
                add_launch_counts(moved)
        return self.imgs, self.segs
