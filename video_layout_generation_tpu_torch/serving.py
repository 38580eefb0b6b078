"""Serving API: GridNet layout/frame futures from flax weights (the JAX
package's ``serving.py``).

One ``LayoutPredictor`` owns a GridNet on one device and answers batched
requests at a fixed batch: a smaller request is padded to it by repeating
its last example, and the padding is sliced off on the device before the
fetch. A request goes up as one packed array, cast straight into the
upload buffer of a staging set (``_Staging``) kept for its packed shape
and reused by every request of that shape. Its answer is written on the
device as frames (f32) and int32 layouts, copied into the set's fetch
buffers and from them into fresh arrays, whose pages are written while
the device still works on the answer; no answer shares memory with a
buffer the next request refills. The buffers are pinned where the first
device is a card, and both copies to and from it are asynchronous. With
``quantize_transfer`` both ways are uint8 (frames at 1/255, layout ids
exact while ``n_classes <= 256``).

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

On a CUDA device with the kernels (outside ``ops.kernels.plain()``) the
rollout is replayed from CUDA graphs: the first request of a packed input
shape and dtype runs eagerly on the stream the graphs are captured on (it
builds the kernels, fills the caches of constants and interpolation
matrices and lets the libraries choose their algorithms), the second
captures a chain of graphs in one memory pool, one for the input stage (the
uint8 cast, the normalisation, the seed frames' edges) and one a generated
frame, each reading the static outputs of the one before, and every later
one uploads into the chain's static input and replays it. The frames are
stacked and cast eagerly after the replay, so a result outside the pool
outlives the next request's replay. A capture that fails raises.
``rollouts`` counts the requests served by replay and by an eager run, and
the captures; ``staging`` the requests served through the staging buffers
(``staged``) and the staging sets allocated (``buffers``, one a packed
shape).

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
from .ops.kernels import add_launch_counts, launch_counts, plain_active
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
                 mesh=None, device="cuda"):
        """``params``: the flax tree, its flat ``"/"``-joined form, or a
        state dict from ``params_from_flax``, of an 8-channel GridNet (the
        no-edge rollout's input) or, with ``use_edges``, of a 10-channel
        one. ``hned`` is then a port HNED, and ``hned_params`` (same forms)
        is loaded into it when given. A request served under
        ``ops.kernels.plain()`` runs the kernels' plain PyTorch versions
        eagerly (the on-card reference)."""
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
        require_bf16(self.device, {"GridNet": self.model, "HNED": self.hned})
        self._rollout = make_rollout_fn(
            self.model, self.hned, n_frames=n_frames, use_edges=use_edges,
            upsample=upsample, edge_scale=edge_scale)
        # uint8 both ways; n_classes > 256 would wrap ids in uint8
        self._quantized_serve = quantize_transfer and n_classes <= 256
        # one a device, the first one's nets the above
        self._replicas = [_Replica(self.device, self._rollout, self._inputs)]
        for dev in devices[1:]:
            model = copy.deepcopy(self.model).to(dev)
            hned_r = (copy.deepcopy(self.hned).to(dev)
                      if self.hned is not None else None)
            self._replicas.append(_Replica(dev, make_rollout_fn(
                model, hned_r, n_frames=n_frames, use_edges=use_edges,
                upsample=upsample, edge_scale=edge_scale), self._inputs))
        self.rollouts = {"replayed": 0, "eager": 0, "captured": 0}
        self._staging = {}
        self.staging = {"staged": 0, "buffers": 0}

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
    def _serve(self, st: "_Staging", n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One packed request, from its staging set, on the device(s) ->
        its frames and layouts on the first one, in the dtypes they are
        fetched in."""
        with annotate("serve.upload"):
            shards = ([self._replicas[0].upload(st.x)] if self.mesh is None
                      else [rep.upload(sh["x"]) for rep, sh in zip(
                          self._replicas, shard_batch({"x": st.x},
                                                      self.mesh))])
            st.uploaded()
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
            lay = segs[:n, ..., 0]   # f32 ids, exact in any integer type
            if self._quantized_serve:
                return (f * 255.0 + 0.5).to(torch.uint8), lay.to(torch.uint8)
            return f, lay.to(torch.int32)

    def _enqueue(self, img1, img2, seg1, seg2):
        """Pack one request, upload it and launch its rollout: (its frames
        and layouts on the device, its staging set)."""
        with annotate("serve.pack"):
            st, n = self._pack_request(img1, img2, seg1, seg2)
        return self._serve(st, n), st

    def _fetch(self, out, st: "_Staging") -> Tuple[np.ndarray, np.ndarray]:
        """Fetch one answer, its frames and layouts on the device, through
        the fetch buffers of its staging set, then copy it out of them into
        fresh arrays, made while the device still works on the answer."""
        frames, layouts = out
        with annotate("serve.fetch"):
            st.fetch(frames, layouts)
            fresh = (_fresh(frames.shape, torch.float32),
                     _fresh(layouts.shape, torch.int32))
            out = st.fetched(frames.shape[0]), fresh
        with annotate("serve.decode"):
            return self._decode_out(out)

    def _pack_request(self, img1, img2, seg1, seg2):
        """Host-side packing of one request straight into the upload buffer
        of the staging set of its packed shape, once that buffer's last
        upload is done: each input cast into its channels of rows ``0..n``
        and its last example into the padding rows; with
        ``quantize_transfer`` the frames as ``x * 255 + 0.5`` in f32, then
        cast to uint8. Returns (the set, ``n``)."""
        n = img1.shape[0]
        if n > self.batch:
            raise ValueError(f"request batch {n} > compiled batch "
                             f"{self.batch}; shard the request")
        shape = (self.batch,) + tuple(img1.shape[1:3]) + (8,)
        st = self._staging.get(shape)
        if st is None:
            st = self._staging[shape] = _Staging(
                shape, self._quantized_serve, self.n_frames, self.device)
            self.staging["buffers"] += 1
        st.wait_uploaded()
        for lo, img in ((0, img1), (3, img2)):
            img = np.asarray(img, np.float32)
            if self._quantized_serve:
                img = img * 255.0 + 0.5
            _put_rows(st.x[..., lo:lo + 3], img, n)
        for c, seg in ((6, seg1), (7, seg2)):
            seg = np.asarray(seg)
            if self._quantized_serve:   # ids through f32, as the frames
                seg = seg.astype(np.float32)
            _put_rows(st.x[..., c], seg, n)
        self.staging["staged"] += 1
        return st, n

    def _decode_out(self, out) -> Tuple[np.ndarray, np.ndarray]:
        """((frames, layouts) fetched, views of the fetch buffers, (f32,
        int32) fresh arrays of their shapes) -> the fresh arrays, holding
        the frames (from uint8 at 1/255 with ``quantize_transfer``) and
        the layouts."""
        staged, fresh = out
        frames, layouts = (t.numpy() for t in fresh)
        for dst, src in zip(fresh, staged):
            _copy(dst, src.numpy())
        if self._quantized_serve:
            np.divide(frames, 255.0, out=frames)
        return frames, layouts

    def predict(self, img1: np.ndarray, img2: np.ndarray,
                seg1: np.ndarray, seg2: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """img*: (N, H, W, 3) RGB in [0,1]; seg*: (N, H, W) int class ids.
        Returns (frames (N, T, H, W, 3) in [0,1], layouts (N, T, H, W))."""
        with annotate("serve.request"):
            return self._fetch(*self._enqueue(img1, img2, seg1, seg2))

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
                yield self._fetch(*inflight.popleft())
            with annotate("serve.request"):
                inflight.append(self._enqueue(*req))
        while inflight:
            yield self._fetch(*inflight.popleft())


# A host copy into a destination of at least this many bytes runs on the
# intra-op threads, a smaller one on the calling thread. On a shared H100
# host a b16 answer (134 MB into fresh pages) took 26-35 ms threaded
# against 53-57 on one thread, but waking the idle pool for a b1 request's
# copies (under 7 MB each) put 10-23 ms into its p95.
_THREADED_COPY_BYTES = 8 << 20


def _copy(dst: torch.Tensor, src: np.ndarray) -> None:
    """``src`` cast and broadcast into the host tensor ``dst``."""
    if dst.numel() * dst.element_size() < _THREADED_COPY_BYTES:
        np.copyto(dst.numpy(), src, casting="unsafe")
        return
    if any(st < 0 for st in src.strides):
        src = np.ascontiguousarray(src)
    dst.copy_(torch.from_numpy(src))


def _put_rows(dst: torch.Tensor, src: np.ndarray, n: int) -> None:
    """``src`` cast into rows ``0..n`` of ``dst`` and its last row into the
    rest."""
    _copy(dst[:n], src)
    _copy(dst[n:], src[-1:])


def _fresh(shape, dtype: torch.dtype) -> torch.Tensor:
    """A fresh host tensor with its pages written (zeros): a later copy
    into it finds them mapped. Filling fresh pages cost a b16 answer more
    than copying into them."""
    dst = torch.empty(shape, dtype=dtype)
    _copy(dst, np.zeros((), dst.numpy().dtype))
    return dst


class _Staging:
    """The host buffers of one packed request shape, reused by every request
    of it: ``x``, the packed upload, and ``frames`` and ``layouts``, the
    answer's rows at the fixed batch in the dtypes they are fetched in
    (uint8 both with ``quantize_transfer``, else f32 and int32). On a card
    they are pinned and both copies are asynchronous on the device's
    current stream: an event after the upload, which a refill of ``x``
    waits on, and one after the fetch, which ``fetched`` waits on before
    it hands the rows out."""

    def __init__(self, shape, quantized: bool, n_frames: int,
                 dev: torch.device):
        b, h, w, _ = shape
        img, ids = ((torch.uint8, torch.uint8) if quantized
                    else (torch.float32, torch.int32))
        pin = dev.type == "cuda"
        self.dev = dev
        self.x = torch.empty(shape, dtype=img, pin_memory=pin)
        self.frames = torch.empty((b, n_frames, h, w, 3), dtype=img,
                                  pin_memory=pin)
        self.layouts = torch.empty((b, n_frames, h, w), dtype=ids,
                                   pin_memory=pin)
        self._uploaded = torch.cuda.Event() if pin else None
        self._fetched = torch.cuda.Event() if pin else None

    def uploaded(self) -> None:
        """Mark the copies out of ``x`` just enqueued."""
        if self._uploaded is not None:
            self._uploaded.record(torch.cuda.current_stream(self.dev))

    def wait_uploaded(self) -> None:
        """Wait until ``x`` may be refilled."""
        if self._uploaded is not None:
            self._uploaded.synchronize()

    def fetch(self, frames: torch.Tensor, layouts: torch.Tensor) -> None:
        """Copy ``frames`` and ``layouts`` (n rows, on the device) into the
        first n rows of the fetch buffers."""
        n = frames.shape[0]
        self.frames[:n].copy_(frames, non_blocking=True)
        self.layouts[:n].copy_(layouts, non_blocking=True)
        if self._fetched is not None:
            self._fetched.record(torch.cuda.current_stream(self.dev))

    def fetched(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Wait for the last ``fetch``: its n rows of the fetch buffers,
        which the next fetch overwrites."""
        if self._fetched is not None:
            self._fetched.synchronize()
        return self.frames[:n], self.layouts[:n]


class _Replica:
    """One device's rollout, and the CUDA graphs of it (``_RolloutGraphs``)
    for each packed input shape and dtype seen twice outside
    ``ops.kernels.plain()``, where the device is a card."""

    def __init__(self, dev: torch.device, rollout, inputs):
        self.dev, self.rollout, self.inputs = dev, rollout, inputs
        # the stream the graphs are captured on, made by the first request
        # that may lead to graphs; the eager rollouts run on it too, so
        # that a capture follows the libraries' first use of the stream
        self.stream = None
        self.seen = set()
        self.graphs = {}

    def upload(self, x: torch.Tensor) -> torch.Tensor:
        """Packed rows ``x`` on this device: into the static input of the
        graphs of their shape and dtype where there are graphs. The copy
        from a pinned ``x`` is asynchronous."""
        g = self.graphs.get((tuple(x.shape), x.dtype))
        return (x.to(self.dev, non_blocking=True) if g is None
                else g.x.copy_(x, non_blocking=True))

    def run(self, x: torch.Tensor):
        """((frames, layouts), how) of packed rows ``x`` on this device;
        ``how`` is "eager", "captured" (then replayed) or "replayed". A
        request under ``ops.kernels.plain()`` runs eagerly, with no graph,
        and does not count towards a capture."""
        key = (tuple(x.shape), x.dtype)
        on_card = (torch.cuda.device(self.dev) if self.dev.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            if self.dev.type != "cuda" or plain_active():
                return self.rollout(*self.inputs(x)), "eager"
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.dev)
            g = self.graphs.get(key)
            how = "replayed"
            if g is None and key in self.seen:
                g = self.graphs[key] = _RolloutGraphs(
                    x, self.inputs, self.rollout, self.stream)
                how = "captured"
            self.seen.add(key)
            if g is not None:
                return self.rollout.finish(*g.replay()), how
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
