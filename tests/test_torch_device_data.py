"""Training on batches rendered on the device, on the CPU: the
``device_data`` loop against the host-fed loop, the device renderer
(``data/device_synthetic.py``) against the host dataset and the JAX
package's renderer, the loaders' window batches, and the JAX package's
scan executors (``chunk_steps``, ``epoch_scan``), which the port accepts
and runs step by step.

Tiny configuration: synthetic windows at 32x32, batch 4, CoordGridNet
filters (4, 6, 8) without edges, f32, ``device="cpu"``, the committed
``vgg_synth`` weights. Each loop runs the K=2 step with feedback noise, so
that the host coin and the device generator are both reseeded for every
step. The renderers agree up to a share of mismatching layout pixels under
1e-4 (the host computes rectangle edges in float64, the card in float32).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_multistep import one_torch_thread  # noqa: F401  (fixture)
from video_layout_generation_tpu.data import device_synthetic as jdev
from video_layout_generation_tpu_torch.config import Config
from video_layout_generation_tpu_torch.data.device_synthetic import (
    DeviceSyntheticLoader, make_device_renderer)
from video_layout_generation_tpu_torch.data.pipeline import (DeviceLoader,
                                                             HostLoader)
from video_layout_generation_tpu_torch.data.synthetic import \
    SyntheticTriplets
from video_layout_generation_tpu_torch.train.multistep import \
    decode_window_batch
from video_layout_generation_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1] / "artifacts_store"
HW = (32, 32)
TINY = dict(dataset="synthetic", synthetic_val_size=4, image_size=HW,
            batch_size=4, epochs=1, filters_level=(4, 6, 8),
            compute_dtype="float32", workers=2, print_freq=1,
            rollout_frames=2, device="cpu", multistep_k=2,
            multistep_feedback_noise=0.1, edge=False,
            vgg_weights=str(ROOT / "vgg_synth.npz"))
MISMATCH = 1e-4


def fit(**kw) -> Trainer:
    t = Trainer(Config(path=None, **dict(TINY, **kw)))
    t.set_epoch(0)
    t.train()
    return t


def assert_same_params(a: Trainer, b: Trainer):
    assert a.global_step == b.global_step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sb:
        assert torch.equal(sa[k], sb[k]), k
    for m in ("mu", "nu"):
        for k, v in b.model_state.opt_state[m].items():
            assert torch.equal(a.model_state.opt_state[m][k], v), (m, k)


def test_chunk_steps_leaves_the_per_step_loop_unchanged():
    """12 samples, batch 4: with ``chunk_steps=2`` the loop runs the same
    three steps (the JAX package's two-step chunk and one-step tail)."""
    chunked = fit(synthetic_train_size=12, chunk_steps=2)
    per_step = fit(synthetic_train_size=12)
    assert chunked.global_step == 3
    assert_same_params(chunked, per_step)
    assert chunked.epoch_stats["steps"] == 3


def test_epoch_scan_leaves_the_device_data_loop_unchanged():
    scanned = fit(synthetic_train_size=8, device_data=True, epoch_scan=True)
    per_step = fit(synthetic_train_size=8, device_data=True)
    assert isinstance(scanned.train_loader, DeviceSyntheticLoader)
    assert scanned.global_step == 2
    assert_same_params(scanned, per_step)


def test_device_data_loop_renders_the_host_fed_batches():
    """The device loop renders the host loader's shuffled scenes in its
    order: over two epochs each batch's windows equal the host-fed loop's
    uint8 windows up to the renderers' share of mismatching layout pixels,
    and their colours, where the layouts agree, up to the host's rounding
    to 1/255 (the device frames are not quantized)."""
    kw = dict(TINY, synthetic_train_size=12)
    device = Trainer(Config(path=None, device_data=True, **kw))
    host = Trainer(Config(path=None, **kw))
    assert isinstance(host.train_loader, DeviceLoader)
    for epoch in (0, 1):
        device.set_epoch(epoch)
        host.set_epoch(epoch)
        pairs = list(zip(device.train_loader, host.train_loader))
        assert len(pairs) == len(host.train_loader) == 3
        for d, h in pairs:
            d_imgs, d_segs = decode_window_batch(d)
            h_imgs, h_segs = decode_window_batch(h)
            assert d_imgs.shape == h_imgs.shape == (4, 4) + HW + (3,)
            same = d_segs == h_segs
            assert (~same).float().mean() < MISMATCH
            assert (d_imgs - h_imgs).abs()[same].max() <= 0.5 / 255 + 1e-6


def _host_float(ds, n_frames):
    return SyntheticTriplets(ds.size, ds.hw, ds.n_classes, seed=ds.seed,
                             cache=False, n_frames=n_frames)


@pytest.mark.parametrize("n_frames", [3, 6])
def test_renderer_matches_host_and_jax(n_frames):
    ds = SyntheticTriplets(16, HW, seed=5)
    table = ds.scene_table()
    render = make_device_renderer(table, ds.hw, ds.n_classes, ds.stride,
                                  n_frames, "cpu")
    got = render(torch.arange(16))
    jgot = jdev.make_device_renderer(table, ds.hw, ds.n_classes, ds.stride,
                                     n_frames)(jnp.arange(16,
                                                          dtype=jnp.int32))
    host = _host_float(ds, n_frames)
    if n_frames == 3:
        segs = torch.stack([got["seg1"][..., 0].long(),
                            got["seg2"][..., 0].long(), got["seg3"]], 1)
        imgs = torch.stack([got[f"img{i}"] for i in (1, 2, 3)], 1)
        jsegs = np.stack([np.asarray(jgot["seg1"])[..., 0],
                          np.asarray(jgot["seg2"])[..., 0],
                          np.asarray(jgot["seg3"])], 1)
        hsegs = np.stack([np.stack([host[i]["seg1"][..., 0],
                                    host[i]["seg2"][..., 0],
                                    host[i]["seg3"]]) for i in range(16)])
        himgs = np.stack([np.stack([host[i][f"img{k}"] for k in (1, 2, 3)])
                          for i in range(16)])
    else:
        segs, imgs = got["segs"], got["imgs"]
        jsegs = np.asarray(jgot["segs"])
        hsegs = np.stack([host[i]["segs"] for i in range(16)])
        himgs = np.stack([host[i]["imgs"] for i in range(16)])
    assert imgs.shape == (16, n_frames) + HW + (3,)
    assert imgs.dtype == torch.float32
    segs = segs.numpy()
    assert np.mean(segs != hsegs) < MISMATCH
    assert np.mean(segs != jsegs) < MISMATCH
    # colours agree where the layouts do (the shading is computed alike)
    same = (segs == hsegs)[..., None].repeat(3, -1)
    assert np.abs(imgs.numpy() - himgs)[same].max() < 1e-6
    assert (segs > 0).mean() > 0.05             # the rectangles are there


def test_epoch_indices_are_the_iteration_order():
    ds = SyntheticTriplets(14, HW, seed=2)
    ld = DeviceSyntheticLoader(ds, 4, device="cpu", seed=3)
    for epoch in (0, 1):
        ld.set_epoch(epoch)
        idx = ld.epoch_indices()
        assert idx.shape == (3, 4) and len(ld) == 3
        batches = list(ld)
        assert len(batches) == 3
        for row, b in zip(idx, batches):
            want = ld.render(torch.from_numpy(row))
            for k in b:
                assert torch.equal(b[k], want[k]), k
    ld.set_epoch(0)
    a = ld.epoch_indices()
    ld.set_epoch(1)
    assert not np.array_equal(a, ld.epoch_indices())
    assert len(np.unique(a)) == a.size


def test_loaders_carry_window_batches():
    """uint8 windows leave the host loader as one ``packedseq`` (B, T, H,
    W, 4) array, and the device loader hands them on as tensors."""
    ds = SyntheticTriplets(8, HW, seed=4, emit_uint8=True, n_frames=5)
    host = HostLoader(ds, 4, shuffle=False, transfer_uint8=True)
    batches = list(DeviceLoader(host, "cpu"))
    assert len(batches) == 2 and set(batches[0]) == {"packedseq"}
    p = batches[0]["packedseq"]
    assert p.shape == (4, 5) + HW + (4,) and p.dtype == torch.uint8
    raw = ds[1]
    np.testing.assert_array_equal(p[1, ..., :3].numpy(), raw["imgs"])
    np.testing.assert_array_equal(p[1, ..., 3].numpy(), raw["segs"])
