"""Host input pipeline and its copy to the card (the JAX package's
``data/pipeline.py``).

``HostLoader`` decodes samples on a thread pool, shuffles per epoch with the
key ``(seed << 16) ^ epoch``, drops the ragged last batch and collates into
contiguous NHWC numpy arrays, packed into one uint8 ``packed6`` array when
``transfer_uint8`` is on: the same batches, in the same order and bytes, as
the JAX package's ``HostLoader``.

``DeviceLoader`` is the counterpart of the JAX package's ``ShardedLoader``:
each host batch is copied into a pinned host buffer and from there to the
card with ``non_blocking=True`` on a side stream, two batches ahead of the
consumer; the consumer's stream waits on the copy's event before it reads
the batch. With ``put_thread`` a feeder thread does the collation, the
pinned fill and the copy's launch while the consumer launches its step (the
JAX package's ``put_thread``). Over several ranks each process's
``HostLoader`` yields its rows of the global batch (``process_index``,
``process_count``): ``order[r::world]``, so global batch i is rank 0's batch
i followed by rank 1's, as ``make_array_from_process_local_data`` assembles
it.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..utils.profiling import annotate

_TRIPLET_KEYS = ("img1", "img2", "img3", "seg1", "seg2", "seg3")


def pack_triplet_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fuse a uint8-encoded 6-field triplet batch into one (B,H,W,12) uint8
    array (img1 0:3 | img2 3:6 | img3 6:9 | seg1 9 | seg2 10 | seg3 11), one
    copy to the card instead of six; ``train/steps.py:decode_batch`` unpacks
    it there. A uint8 window batch ``{"imgs", "segs"}`` becomes one
    ``packedseq`` (B,T,H,W,4). Other batches pass through."""
    if (set(batch) == {"imgs", "segs"}
            and batch["imgs"].dtype == np.uint8
            and batch["segs"].dtype == np.uint8):
        return {"packedseq": np.concatenate(
            [batch["imgs"], batch["segs"][..., None]], axis=-1)}
    if (set(batch) != set(_TRIPLET_KEYS)
            or any(batch[k].dtype != np.uint8 for k in _TRIPLET_KEYS)):
        return batch
    b = batch
    return {"packed6": np.concatenate(
        [b["img1"], b["img2"], b["img3"], b["seg1"], b["seg2"],
         b["seg3"][..., None]], axis=-1)}


def encode_batch_uint8(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Compact-transfer encoding: f32 [0,1] frames -> uint8, layout ids ->
    uint8 (4x fewer bytes to the card). Exact for 8-bit image sources and
    for class ids < 256."""
    out = {}
    for k, v in batch.items():
        if k.startswith("img") and v.dtype == np.float32:
            out[k] = (v * 255.0 + 0.5).astype(np.uint8)
        elif k.startswith("seg") and v.dtype != np.uint8:
            out[k] = v.astype(np.uint8)
        else:
            out[k] = v
    return out


class HostLoader:
    """Deterministic shuffling, batching, parallel-decode iterator.

    ``transfer_uint8=True`` re-encodes batches through ``encode_batch_uint8``
    and packs them (only exact when class ids fit in uint8: the caller gates
    on ``n_classes``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, workers: int = 4, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 transfer_uint8: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.workers = max(1, workers)
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.transfer_uint8 = transfer_uint8
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        n = len(self.ds)
        if self.shuffle:
            rng = np.random.default_rng((self.seed << 16) ^ self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # shard by process: contiguous after permutation, padded so that
        # every process sees the same count
        per = -(-n // self.process_count)
        pad = per * self.process_count - n
        if pad:
            order = np.concatenate([order, order[:pad]])
        return order[self.process_index::self.process_count]

    def __len__(self) -> int:
        per = -(-len(self.ds) // self.process_count)
        if self.drop_last:
            return per // self.batch_size
        return -(-per // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        if self.drop_last:
            order = order[: len(self) * self.batch_size]
        with cf.ThreadPoolExecutor(self.workers) as pool:
            # a bounded window of decode futures in flight
            max_inflight = max(2 * self.workers, self.batch_size)
            window: collections.deque = collections.deque()
            idx_iter = iter(order)
            exhausted = False
            while True:
                batch_buf = []
                with annotate("loader.gather"):
                    while len(batch_buf) < self.batch_size:
                        while not exhausted and len(window) < max_inflight:
                            try:
                                i = next(idx_iter)
                            except StopIteration:
                                exhausted = True
                                break
                            window.append(
                                pool.submit(self.ds.__getitem__, int(i)))
                        if not window:
                            break
                        batch_buf.append(window.popleft().result())
                if len(batch_buf) < self.batch_size:
                    break
                yield self._collate(batch_buf)
            if batch_buf and not self.drop_last:
                yield self._collate(batch_buf)

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        with annotate("loader.collate"):
            batch = {k: np.stack([s[k] for s in samples])
                     for k in samples[0]}
            if self.transfer_uint8:
                batch = pack_triplet_batch(encode_batch_uint8(batch))
            return batch


class _Slot:
    """One pinned host buffer per batch key, and the event of the last copy
    that read it."""

    def __init__(self):
        self.pinned: Dict[str, torch.Tensor] = {}
        self.copied = None

    def fill(self, host_batch: Dict[str, np.ndarray]):
        with annotate("loader.pin"):
            # the buffer's previous copy to the card must have read it
            # first: a pinned buffer refilled under its own in-flight copy
            # corrupts that batch without an error
            if self.copied is not None:
                self.copied.synchronize()
            for k, v in host_batch.items():
                buf = self.pinned.get(k)
                if (buf is None or tuple(buf.shape) != v.shape
                        or buf.numpy().dtype != v.dtype):
                    buf = torch.empty(v.shape,
                                      dtype=torch.from_numpy(v[:0]).dtype,
                                      pin_memory=True)
                    self.pinned[k] = buf
                np.copyto(buf.numpy(), v)


PREFETCH = 2   # batches copied ahead of the consumer, one pinned buffer each


class DeviceLoader:
    """Wraps a ``HostLoader``; yields each batch as tensors on ``device``.

    On a CUDA device the batches move through ``PREFETCH`` pinned host
    buffers on a side stream, that many batches ahead; each yielded tensor
    is already ordered after its copy on the current stream and recorded on
    it for the caching allocator. Pinning never falls back to pageable
    memory: a failure raises. On the CPU the host batch is yielded as
    tensors.

    ``put_thread=True`` moves the host side (the loader's collation, the
    pinned fill and the copy's launch; on the CPU the conversion to
    tensors) to a feeder thread, ``PREFETCH`` batches ahead: the same
    batches in the same order. An exception in the thread is raised in the
    consumer; a consumer that stops early stops the thread, which releases
    its buffers."""

    def __init__(self, loader: HostLoader, device, put_thread: bool = False):
        self.loader = loader
        self.device = torch.device(device)
        self.put_thread = put_thread

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        if self.device.type != "cuda":
            batches = ({k: torch.from_numpy(v) for k, v in hb.items()}
                       for hb in self.loader)
            if self.put_thread:
                yield from _fed_by_thread(lambda: batches, None)
            else:
                yield from batches
            return
        if self.put_thread:
            side = torch.cuda.Stream(device=self.device)
            yield from _fed_by_thread(
                lambda: self._copies(side), side.device,
                lambda item: self._hand_over(*item))
            return
        side = torch.cuda.Stream(device=self.device)
        window: collections.deque = collections.deque()
        for item in self._copies(side):
            window.append(item)
            if len(window) < PREFETCH:
                continue
            yield self._hand_over(*window.popleft())
        while window:
            yield self._hand_over(*window.popleft())

    def _copies(self, side):
        """(device tensors, copy event) of each host batch, copied on
        ``side`` through ``PREFETCH`` pinned buffers in turn."""
        slots = [_Slot() for _ in range(PREFETCH)]
        for k, host_batch in enumerate(self.loader):
            slot = slots[k % len(slots)]
            slot.fill(host_batch)
            # device memory is the side stream's; ``_hand_over`` records
            # each tensor on the consumer's stream, so the allocator reuses
            # it only after the consumer's work on it is done
            with annotate("loader.copy"), torch.cuda.stream(side):
                dev = {name: buf.to(self.device, non_blocking=True)
                       for name, buf in slot.pinned.items()}
                done = torch.cuda.Event()
                done.record(side)
            slot.copied = done
            yield dev, done

    def _hand_over(self, dev, done):
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in dev.values():
            t.record_stream(stream)
        return dev


_END = object()


def _fed_by_thread(produce, device, hand_over=lambda item: item):
    """Yield ``hand_over(item)`` for each item of ``produce()``, which runs
    on a feeder thread (with ``device``, an indexed CUDA device, as its
    current one) at most ``PREFETCH`` items ahead. The thread's exception
    is raised here after the items it made; closing this generator early
    stops the thread and waits for it."""
    q: queue.Queue = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def feed():
        items = None
        try:
            if device is not None:
                torch.cuda.set_device(device)
            items = produce()
            for item in items:
                if not put(item):
                    break
        except BaseException as e:          # raised in the consumer
            err.append(e)
        finally:
            if items is not None and hasattr(items, "close"):
                items.close()               # the loader's pool and buffers
            put(_END)

    thread = threading.Thread(target=feed, name="DeviceLoader.put_thread",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            yield hand_over(item)
    finally:
        stop.set()
        thread.join()
    if err:
        raise err[0]
