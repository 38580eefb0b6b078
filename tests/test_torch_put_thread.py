"""The feeder thread of the port's device loader (``DeviceLoader(...,
put_thread=True)``, ``data/pipeline.py``) on the CPU, where it yields each
host batch as tensors from the thread.

- Its batches and their order equal, bit for bit, those of the JAX
  package's ``ShardedLoader(put_thread=True)`` on one CPU device and those
  of the port's loader without the thread, over two epochs and both
  process shards of a two-process run.
- A dataset that raises on a sample raises in the consumer, after the
  batches made before it.
- A consumer that stops early stops the thread: it has ended when the
  consumer's generator is closed, and the loader's own decode pool with it.
"""

import threading

import numpy as np
import pytest
import torch

from video_layout_generation_tpu.data import pipeline as jpipe
from video_layout_generation_tpu.data import synthetic as jsyn
from video_layout_generation_tpu.parallel import mesh as jmesh
from video_layout_generation_tpu_torch.data import pipeline as tpipe
from video_layout_generation_tpu_torch.data import synthetic as tsyn

HW = (16, 24)
KW = dict(batch_size=3, seed=5, workers=2)


def _feeders():
    return [t for t in threading.enumerate()
            if t.name == "DeviceLoader.put_thread"]


@pytest.mark.parametrize("process_index", [0, 1])
@pytest.mark.parametrize("transfer_uint8", [False, True])
def test_put_thread_batches_equal_jax_and_threadless(process_index,
                                                     transfer_uint8,
                                                     devices):
    shard = dict(process_index=process_index, process_count=2,
                 transfer_uint8=transfer_uint8)
    jl = jpipe.ShardedLoader(
        jpipe.HostLoader(jsyn.SyntheticTriplets(13, HW, seed=2), **KW,
                         **shard), jmesh.make_mesh(devices[:1]),
        put_thread=True)
    ds = tsyn.SyntheticTriplets(13, HW, seed=2)
    threaded = tpipe.DeviceLoader(tpipe.HostLoader(ds, **KW, **shard),
                                  "cpu", put_thread=True)
    plain = tpipe.DeviceLoader(tpipe.HostLoader(ds, **KW, **shard), "cpu")
    for epoch in (0, 1):
        for ld in (jl, threaded, plain):
            ld.set_epoch(epoch)
        got = list(threaded)
        want = [{k: np.asarray(v) for k, v in b.items()} for b in jl]
        again = list(plain)
        assert len(got) == len(want) == len(again) == len(threaded) == 2
        for g, j, p in zip(got, want, again):
            assert set(g) == set(j) == set(p)
            for k in g:
                assert isinstance(g[k], torch.Tensor)
                assert g[k].numpy().tobytes() == j[k].tobytes() == \
                    p[k].numpy().tobytes(), k
                assert g[k].numpy().dtype == j[k].dtype
    assert not _feeders()


class _Failing(tsyn.SyntheticTriplets):
    def __getitem__(self, index):
        if index == self.bad:
            raise KeyError(f"sample {index} is broken")
        return super().__getitem__(index)


def test_dataset_error_raises_in_the_consumer():
    ds = _Failing(9, HW, seed=3)
    ds.bad = 7                      # in the third batch of 3 (no shuffle)
    ld = tpipe.DeviceLoader(tpipe.HostLoader(ds, 3, shuffle=False,
                                             workers=1), "cpu",
                            put_thread=True)
    seen = []
    with pytest.raises(KeyError, match="sample 7 is broken"):
        for batch in ld:
            seen.append(batch)
    assert len(seen) == 2
    assert not _feeders()


def test_early_stop_ends_the_thread():
    ld = tpipe.DeviceLoader(tpipe.HostLoader(
        tsyn.SyntheticTriplets(30, HW, seed=4), 2, workers=2), "cpu",
        put_thread=True)
    it = iter(ld)
    first = next(it)
    assert first["img1"].shape == (2,) + HW + (3,)
    assert len(_feeders()) == 1
    it.close()
    assert not _feeders()
    # a new epoch starts a new thread and yields every batch
    assert len(list(ld)) == len(ld) == 15
    assert not _feeders()
