"""The port's data path (``data/``, ``ops/colorize.py``, ``ops/one_hot.py``)
against the JAX package's, byte for byte: synthetic samples, the Cityscapes
index and readers on a small PNG tree written here, the host loader's
batches and their order, the colorizer and the one-hot encoding. On the CPU
the device loader yields the host loader's batches as tensors.

Both packages' readers decode with the native C++ loader when it builds
(``tests/test_torch_native_loader.py`` holds the two loaders against each
other); here ``NativeImageLoader`` is set to None on both sides so that
both decode with cv2 (or PIL) alike, and the arrays are held equal.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from video_layout_generation_tpu.data import cityscapes as jcity
from video_layout_generation_tpu.data import index as jindex
from video_layout_generation_tpu.data import pipeline as jpipe
from video_layout_generation_tpu.data import synthetic as jsyn
from video_layout_generation_tpu.ops import colorize as jcolor
from video_layout_generation_tpu.ops import one_hot as jonehot
from video_layout_generation_tpu_torch.data import cityscapes as tcity
from video_layout_generation_tpu_torch.data import index as tindex
from video_layout_generation_tpu_torch.data import pipeline as tpipe
from video_layout_generation_tpu_torch.data import synthetic as tsyn
from video_layout_generation_tpu_torch.ops import colorize as tcolor
from video_layout_generation_tpu_torch.ops import one_hot as tonehot

HW = (24, 32)


def assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("seed", [0, 7, 1024])
@pytest.mark.parametrize("emit_uint8", [False, True])
def test_synthetic_samples_byte_identical(seed, emit_uint8):
    kw = dict(size=5, image_hw=HW, seed=seed, emit_uint8=emit_uint8)
    j, t = jsyn.SyntheticTriplets(**kw), tsyn.SyntheticTriplets(**kw)
    assert len(j) == len(t) == 5
    for i in range(5):
        assert_same(j[i], t[i])
    for a, b in zip(j.sequence(3, 4), t.sequence(3, 4)):
        assert a.tobytes() == b.tobytes()
    assert j.scene_table().tobytes() == t.scene_table().tobytes()


def test_synthetic_uncached_float_and_windows_identical():
    for kw in (dict(cache=False), dict(n_frames=4), dict(n_classes=300)):
        j = jsyn.SyntheticTriplets(3, HW, seed=3, **kw)
        t = tsyn.SyntheticTriplets(3, HW, seed=3, **kw)
        for i in range(3):
            assert_same(j[i], t[i])


def _png_tree(root, city="aachen", snippets=((1, range(0, 12)),
                                             (2, range(5, 14)))):
    """A Cityscapes-shaped tree of tiny PNGs: 40x48 RGB frames and 40x48
    layout ids (resized to HW by the readers)."""
    rng = np.random.default_rng(0)
    for sub in ("deeplab256_label", "leftImg256"):
        (root / sub / city).mkdir(parents=True, exist_ok=True)
    (root / "deeplab256_label" / "README.txt").write_text("not a city")
    for snip, frames in snippets:
        for f in frames:
            stem = f"{city}_{snip:06d}_{f:06d}"
            rgb = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
            seg = rng.integers(0, 20, (40, 48), dtype=np.uint8)
            Image.fromarray(rgb).save(
                root / "leftImg256" / city / f"{stem}_leftImg8bit.png")
            Image.fromarray(seg).save(
                root / "deeplab256_label" / city
                / f"{stem}_gtFine_myseg_id.png")
    return root


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    return _png_tree(tmp_path_factory.mktemp("cityscapes"))


def test_triplet_index_identical(png_tree):
    for n_frames in (3, 4):
        j = jindex.build_triplet_index(str(png_tree), n_frames=n_frames)
        t = tindex.build_triplet_index(str(png_tree), n_frames=n_frames)
        assert j == t and len(t) > 0
    assert tindex._contiguous_runs([1, 2, 3, 7, 8, 10]) == \
        jindex._contiguous_runs([1, 2, 3, 7, 8, 10]) == [[1, 2, 3], [7, 8],
                                                         [10]]


def test_cityscapes_readers_identical(png_tree, monkeypatch):
    monkeypatch.setattr(jcity, "NativeImageLoader", None)
    monkeypatch.setattr(tcity, "NativeImageLoader", None)
    j = jcity.CityscapesTriplets(str(png_tree), HW)
    t = tcity.CityscapesTriplets(str(png_tree), HW)
    assert len(j) == len(t)
    for i in (0, len(t) - 1):
        assert_same(j[i], t[i])
    js = jcity.CityscapesSequences(str(png_tree), 4, HW)
    ts = tcity.CityscapesSequences(str(png_tree), 4, HW)
    assert len(js) == len(ts)
    assert_same(js[1], ts[1])
    for a, b in zip(js.sequence(0, 3), ts.sequence(0, 3)):
        assert a.tobytes() == b.tobytes()
    empty = png_tree.parent / "empty_tree"
    (empty / "deeplab256_label").mkdir(parents=True, exist_ok=True)
    with pytest.raises(RuntimeError, match="Found 0"):
        tcity.CityscapesTriplets(str(empty), HW)


def test_cityscapes_reader_without_a_decoder_raises_by_name(png_tree,
                                                            monkeypatch):
    monkeypatch.setattr(tcity, "NativeImageLoader", None)
    monkeypatch.setattr(tcity, "cv2", None)
    monkeypatch.setattr(tcity, "Image", None)
    ds = tcity.CityscapesTriplets(str(png_tree), HW)   # indexing needs none
    with pytest.raises(ImportError, match="cv2.*PIL"):
        ds[0]


def test_pil_decode_equals_cv2_without_resize(png_tree, monkeypatch):
    """Without cv2 the port decodes through PIL: at the PNGs' own size (no
    resize, whose sampling differs between the two libraries) the samples
    are byte-identical."""
    monkeypatch.setattr(tcity, "NativeImageLoader", None)
    native = (40, 48)
    t_cv2 = tcity.CityscapesTriplets(str(png_tree), native)[0]
    monkeypatch.setattr(tcity, "cv2", None)
    t_pil = tcity.CityscapesTriplets(str(png_tree), native)[0]
    assert_same(t_cv2, t_pil)
    assert tcity.CityscapesTriplets(str(png_tree), HW)[0]["img1"].shape == \
        HW + (3,)


def _batches(mod, ds, epoch, **kw):
    loader = mod.HostLoader(ds, seed=11, workers=3, **kw)
    loader.set_epoch(epoch)
    return len(loader), list(loader)


# the loader's sources: float or uint8 triplets (uint8 is the benchmark's
# path to ``packed6``) and float or uint8 windows (to ``packedseq``)
SOURCES = {"f32_triplets": {}, "u8_triplets": dict(emit_uint8=True),
           "f32_windows": dict(n_frames=4),
           "u8_windows": dict(n_frames=4, emit_uint8=True)}


@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("transfer_uint8", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_host_loader_batches_identical(shuffle, transfer_uint8, drop_last,
                                       ranks, source):
    ds = jsyn.SyntheticTriplets(11, HW, seed=5, **SOURCES[source])
    per = -(-11 // ranks)            # each rank's samples, padded
    n_batches = per // 4 if drop_last else -(-per // 4)
    packed = ("packedseq" if "windows" in source else "packed6")
    for rank in range(ranks):
        for epoch in (0, 1):
            kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
                      transfer_uint8=transfer_uint8, process_index=rank,
                      process_count=ranks)
            nj, bj = _batches(jpipe, ds, epoch, **kw)
            nt, bt = _batches(tpipe, ds, epoch, **kw)
            assert nj == nt == len(bt) == n_batches
            for a, b in zip(bj, bt):
                assert_same(a, b)
            if transfer_uint8:
                assert set(bt[0]) == {packed}
            # the ragged last batch keeps its rows
            assert {len(v) for v in bt[-1].values()} == {
                4 if drop_last or per % 4 == 0 else per % 4}
    if source != "f32_triplets" or ranks != 1:
        return
    if transfer_uint8:
        assert bt[0]["packed6"].shape == (4,) + HW + (12,)
    # the order moves with the epoch when shuffled
    _, e0 = _batches(tpipe, ds, 0, batch_size=11, shuffle=True)
    _, e1 = _batches(tpipe, ds, 1, batch_size=11, shuffle=True)
    assert e0[0]["img1"].tobytes() != e1[0]["img1"].tobytes()


def test_host_loader_workers_assemble_every_batch():
    ds = tsyn.SyntheticTriplets(10, HW, seed=4, emit_uint8=True)
    loader = tpipe.HostLoader(ds, 4, seed=2, workers=2, drop_last=False,
                              transfer_uint8=True)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        assert len(list(loader)) == 3
        assert loader.assembled == {"workers": 3, "consumer": 0}


class _OneBadSample:
    """The dataset's samples, but sample ``bad`` has one channel of img2
    where the others have three: ``np.stack`` refuses it, and numpy would
    broadcast it into a row unchecked."""

    def __init__(self, ds, bad: int):
        self.ds, self.bad = ds, bad

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        s = dict(self.ds[i])
        if i == self.bad:
            s["img2"] = s["img2"][..., :1]
        return s


def _loader_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("HostLoader")}


@pytest.mark.parametrize("transfer_uint8", [True, False])
def test_host_loader_sample_that_does_not_fit_raises(transfer_uint8):
    before = _loader_threads()
    ds = _OneBadSample(tsyn.SyntheticTriplets(12, HW, seed=4), bad=6)
    loader = tpipe.HostLoader(ds, 4, shuffle=False, workers=3,
                              transfer_uint8=transfer_uint8)
    got = []
    with pytest.raises(ValueError):
        for batch in loader:
            got.append(batch)
    assert len(got) == 1            # the batch before the bad sample's
    assert _loader_threads() <= before      # the pool has shut down


def test_host_loader_many_workers_lose_no_row():
    """More workers than cores and a short switch interval: the batch's
    arrays are allocated once, under its lock, and every row lands."""
    ds = jsyn.SyntheticTriplets(48, HW, seed=8, emit_uint8=True)
    kw = dict(batch_size=16, seed=4, workers=24, transfer_uint8=True)
    want = list(jpipe.HostLoader(ds, **kw))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            got = list(tpipe.HostLoader(ds, **kw))
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert_same(g, w)
    finally:
        sys.setswitchinterval(interval)


def test_host_loader_closed_early_leaves_its_batches():
    ds = jsyn.SyntheticTriplets(40, HW, seed=6, emit_uint8=True)
    kw = dict(batch_size=4, seed=3, workers=3, transfer_uint8=True)
    want = list(jpipe.HostLoader(ds, **kw))[:2]
    before = _loader_threads()
    it = iter(tpipe.HostLoader(ds, **kw))
    got = [next(it), next(it)]
    held = [{k: v.copy() for k, v in b.items()} for b in got]
    it.close()
    assert _loader_threads() <= before
    for g, h, w in zip(got, held, want):
        assert_same(g, h)
        assert_same(g, w)


def test_pack_and_encode_identical():
    rng = np.random.default_rng(3)
    batch = {"img1": rng.random((2,) + HW + (3,), np.float32),
             "img2": rng.random((2,) + HW + (3,), np.float32),
             "img3": rng.random((2,) + HW + (3,), np.float32),
             "seg1": rng.integers(0, 20, (2,) + HW + (1,)).astype(np.float32),
             "seg2": rng.integers(0, 20, (2,) + HW + (1,)).astype(np.float32),
             "seg3": rng.integers(0, 20, (2,) + HW).astype(np.int32)}
    assert_same(jpipe.encode_batch_uint8(batch),
                tpipe.encode_batch_uint8(batch))
    u8 = tpipe.encode_batch_uint8(batch)
    assert_same(jpipe.pack_triplet_batch(u8), tpipe.pack_triplet_batch(u8))
    win = {"imgs": rng.integers(0, 256, (2, 4) + HW + (3,), dtype=np.uint8),
           "segs": rng.integers(0, 20, (2, 4) + HW, dtype=np.uint8)}
    assert_same(jpipe.pack_triplet_batch(win), tpipe.pack_triplet_batch(win))
    assert tpipe.pack_triplet_batch(batch) is batch    # f32: passes through


def test_device_loader_on_cpu_yields_the_host_batches():
    ds = tsyn.SyntheticTriplets(9, HW, seed=2, emit_uint8=True)
    host = tpipe.HostLoader(ds, 4, seed=1, workers=2, transfer_uint8=True)
    dev = tpipe.DeviceLoader(host, "cpu")
    dev.set_epoch(1)
    assert host.epoch == 1 and len(dev) == len(host) == 2
    for h, d in zip(list(host), list(dev)):
        assert set(h) == set(d) == {"packed6"}
        assert isinstance(d["packed6"], torch.Tensor)
        assert d["packed6"].device.type == "cpu"
        np.testing.assert_array_equal(d["packed6"].numpy(), h["packed6"])


@pytest.mark.parametrize("argmax", [False, True])
def test_colorize_identical(argmax):
    rng = np.random.default_rng(4)
    if argmax:
        seg = rng.standard_normal((2, 5, 6, 20)).astype(np.float32)
    else:
        seg = rng.integers(0, 20, (2, 5, 6))
    j = np.asarray(jcolor.colorize_seg(seg, 20, argmax=argmax))
    t = tcolor.colorize_seg(torch.as_tensor(seg), 20, argmax=argmax)
    assert t.dtype == torch.float32 and t.shape == j.shape
    assert t.numpy().tobytes() == j.tobytes()
    assert tcolor.CITYSCAPES_COLORS.tobytes() == \
        jcolor.CITYSCAPES_COLORS.tobytes()


def test_seg_one_hot_identical():
    seg = np.array([[0, 3, 19], [25, -1, 7]])     # two ids out of range
    for dtype, tdtype in ((np.float32, torch.float32),
                          (np.int32, torch.int32)):
        j = np.asarray(jonehot.seg_one_hot(seg, 20, dtype=dtype))
        t = tonehot.seg_one_hot(torch.as_tensor(seg), 20, dtype=tdtype)
        assert t.numpy().tobytes() == j.tobytes()


def test_colorized_png_export_identical(tmp_path):
    """``save_colorized_png`` (the JAX package writes through its native
    encoder when built, the port through cv2 or PIL): the decoded pixels
    are the same palette colours."""
    from video_layout_generation_tpu.evaluation import export as jexport
    from video_layout_generation_tpu_torch.evaluation import export as texport
    ids = np.random.default_rng(6).integers(0, 25, (HW))
    jexport.save_colorized_png(str(tmp_path / "j.png"), ids)
    texport.save_colorized_png(str(tmp_path / "t.png"), torch.as_tensor(ids))
    j = np.asarray(Image.open(tmp_path / "j.png").convert("RGB"))
    t = np.asarray(Image.open(tmp_path / "t.png").convert("RGB"))
    assert t.shape == HW + (3,) and t.tobytes() == j.tobytes()
    pal = tcolor.CITYSCAPES_COLORS
    assert t.tobytes() == pal[ids % len(pal)].tobytes()
