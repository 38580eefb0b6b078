"""Host input pipeline and its copy to the card (the JAX package's
``data/pipeline.py``).

``HostLoader`` shuffles per epoch with the key ``(seed << 16) ^ epoch`` and
drops the ragged last batch; its decode workers write each sample into the
sample's row of contiguous NHWC numpy arrays, packed into one uint8
``packed6`` (or ``packedseq``) array when ``transfer_uint8`` is on, so that
the consumer's thread copies nothing: the same batches, in the same order
and bytes, as the JAX package's ``HostLoader``.

``DeviceLoader`` is the counterpart of the JAX package's ``ShardedLoader``:
each host batch is copied into a pinned host buffer and from there to the
card with ``non_blocking=True`` on a side stream, two batches ahead of the
consumer; the consumer's stream waits on the copy's event before it reads
the batch. With ``put_thread`` a feeder thread takes the loader's batches,
fills the pinned buffers and launches the copies while the consumer
launches its step (the JAX package's ``put_thread``). Over several ranks
each process's ``HostLoader`` yields its rows of the global batch
(``process_index``, ``process_count``): ``order[r::world]``, so global
batch i is rank 0's batch i followed by rank 1's, as
``make_array_from_process_local_data`` assembles it.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..utils.profiling import annotate

# the fused uint8 arrays: each field's channels in turn along the last axis;
# a field in ``_NO_CHANNEL_AXIS`` is one channel without an axis of its own
_PACKED = {"packedseq": ("imgs", "segs"),
           "packed6": ("img1", "img2", "img3", "seg1", "seg2", "seg3")}
_NO_CHANNEL_AXIS = ("segs", "seg3")


def _packing(batch: Dict[str, np.ndarray]) -> Optional[str]:
    """The name of the fused array that ``batch`` packs into, or None."""
    for name, fields in _PACKED.items():
        if (set(batch) == set(fields)
                and all(batch[k].dtype == np.uint8 for k in fields)):
            return name
    return None


def pack_triplet_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fuse a uint8-encoded 6-field triplet batch into one (B,H,W,12) uint8
    array (img1 0:3 | img2 3:6 | img3 6:9 | seg1 9 | seg2 10 | seg3 11), one
    copy to the card instead of six; ``train/steps.py:decode_batch`` unpacks
    it there. A uint8 window batch ``{"imgs", "segs"}`` becomes one
    ``packedseq`` (B,T,H,W,4). Other batches pass through."""
    name = _packing(batch)
    if name is None:
        return batch
    return {name: np.concatenate(
        [batch[k][..., None] if k in _NO_CHANNEL_AXIS else batch[k]
         for k in _PACKED[name]], axis=-1)}


def encode_batch_uint8(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Compact-transfer encoding: f32 [0,1] frames -> uint8, layout ids ->
    uint8 (4x fewer bytes to the card). Exact for 8-bit image sources and
    for class ids < 256. Elementwise, so it encodes one sample as it
    encodes a batch."""
    out = {}
    for k, v in batch.items():
        if k.startswith("img") and v.dtype == np.float32:
            out[k] = (v * 255.0 + 0.5).astype(np.uint8)
        elif k.startswith("seg") and v.dtype != np.uint8:
            out[k] = v.astype(np.uint8)
        else:
            out[k] = v
    return out


def _row_layout(sample: Dict[str, np.ndarray], pack: bool):
    """Where each field of ``sample`` goes in a batch row, by the rules of
    ``pack_triplet_batch`` (with ``pack``) or one array a field: ({field:
    (array name, index into the row)}, {array name: (row shape, dtype)})."""
    name = _packing(sample) if pack else None
    if name is None:
        return ({k: (k, (Ellipsis,)) for k in sample},
                {k: (v.shape, v.dtype) for k, v in sample.items()})
    fields, leads, c = {}, set(), 0
    for k in _PACKED[name]:
        v = sample[k]
        if k in _NO_CHANNEL_AXIS:
            fields[k] = (name, (Ellipsis, c))
            leads.add(v.shape)
            c += 1
        else:
            fields[k] = (name, (Ellipsis, slice(c, c + v.shape[-1])))
            leads.add(v.shape[:-1])
            c += v.shape[-1]
    if len(leads) != 1:
        shapes = {k: sample[k].shape for k in _PACKED[name]}
        raise ValueError(f"the fields of {name} differ in shape: {shapes}")
    return fields, {name: (leads.pop() + (c,), np.dtype(np.uint8))}


class _Batch:
    """One batch's arrays, allocated when its first sample arrives and
    written row by row by the threads that place its samples."""

    def __init__(self, n: int, pack: bool, consumer: int):
        self.n = n
        self.pack = pack
        self.consumer = consumer        # the id of the consumer's thread
        self.rows_on_consumer = 0
        self.lock = threading.Lock()
        self.fields = None
        self.arrays: Dict[str, np.ndarray] = {}

    def place(self, row: int, sample: Dict[str, np.ndarray]):
        with self.lock:
            if self.fields is None:
                self.fields, shapes = _row_layout(sample, self.pack)
                self.arrays = {k: np.empty((self.n,) + shape, dtype)
                               for k, (shape, dtype) in shapes.items()}
        if set(sample) != set(self.fields):
            raise ValueError(f"sample fields {sorted(sample)} differ from "
                             f"the batch's {sorted(self.fields)}")
        for k, (name, index) in self.fields.items():
            v, dst = sample[k], self.arrays[name][(row,) + index]
            if v.shape != dst.shape or v.dtype != dst.dtype:
                raise ValueError(
                    f"sample field {k!r} ({v.shape}, {v.dtype}) does not "
                    f"fit its batch row ({dst.shape}, {dst.dtype})")
            if (not dst.flags.c_contiguous and v.ndim and v.shape[-1] > 1
                    and dst.strides[-1] == v.strides[-1] == v.itemsize):
                # a pixel's channels into a packed row as one element:
                # numpy moves a strided axis of 3 bytes a byte at a time,
                # at about twice the cost
                pixel = np.dtype((np.void, v.shape[-1] * v.itemsize))
                dst, v = dst.view(pixel), v.view(pixel)
            dst[...] = v
        if threading.get_ident() == self.consumer:
            self.rows_on_consumer += 1


class HostLoader:
    """Deterministic shuffling, batching, parallel-decode iterator.

    Each decode worker writes its sample into the sample's row of fresh
    batch arrays, encoded through ``encode_batch_uint8`` and packed by the
    rules of ``pack_triplet_batch`` when ``transfer_uint8`` is on (only
    exact when class ids fit in uint8: the caller gates on ``n_classes``);
    the consumer's thread only submits indices and waits. ``assembled``
    counts the epoch's batches whose every row a worker placed
    (``"workers"``) and the others (``"consumer"``)."""

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
        self.assembled = {"workers": 0, "consumer": 0}

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

    def _rows(self, order: np.ndarray) -> Iterator:
        """(batch, row, index) of each sample of ``order``, in turn."""
        consumer = threading.get_ident()
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            batch = _Batch(len(idx), self.transfer_uint8, consumer)
            for row, i in enumerate(idx):
                yield batch, row, int(i)

    def _place(self, batch: _Batch, row: int, index: int):
        sample = self.ds[index]
        with annotate("loader.place"):
            if self.transfer_uint8:
                sample = encode_batch_uint8(sample)
            batch.place(row, sample)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        if self.drop_last:
            order = order[: len(self) * self.batch_size]
        self.assembled = {"workers": 0, "consumer": 0}
        rows = self._rows(order)
        pool = cf.ThreadPoolExecutor(self.workers,
                                     thread_name_prefix="HostLoader")
        try:
            # a bounded window of placements in flight, in order
            max_inflight = max(2 * self.workers, self.batch_size)
            window: collections.deque = collections.deque()
            while True:
                with annotate("loader.gather"):
                    while True:
                        for batch, row, i in itertools.islice(
                                rows, max_inflight - len(window)):
                            window.append((batch, row, pool.submit(
                                self._place, batch, row, i)))
                        if not window:
                            return
                        batch, row, placed = window.popleft()
                        placed.result()
                        if row == batch.n - 1:
                            break
                yield self._hand_over(batch)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _hand_over(self, batch: _Batch) -> Dict[str, np.ndarray]:
        with annotate("loader.collate"):
            by = "consumer" if batch.rows_on_consumer else "workers"
            self.assembled[by] += 1
            return batch.arrays


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

    ``put_thread=True`` moves the host side (the wait for the loader's
    batch, the pinned fill and the copy's launch; on the CPU the conversion
    to tensors) to a feeder thread, ``PREFETCH`` batches ahead: the same
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
