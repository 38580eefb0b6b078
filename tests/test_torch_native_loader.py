"""The port's native image loader (``io/native_loader.py``) against the
JAX package's ``NativeImageLoader``, on PNGs written here: both bind the
same ``native/vlg_loader.cpp``, the port's built at first use into
``build/vlg_native/`` with the Makefile's flags (the JAX package's built
into ``native/`` as its own test builds it). ``load_rgb``, ``load_gray``,
the batch loads and ``save_png`` give the same bits; a missing file raises
as the JAX loader's does; the port's Cityscapes reader decodes with it
and says so, and falls back to cv2 / PIL with the build's message when the
build fails; the colorized export writes the native writer's bytes.
"""

import os
import subprocess

import numpy as np
import pytest
from PIL import Image

from test_torch_data import _png_tree
from video_layout_generation_tpu.io import native_loader as jnative
from video_layout_generation_tpu_torch.data import cityscapes as tcity
from video_layout_generation_tpu_torch.evaluation import export as texport
from video_layout_generation_tpu_torch.io import native_loader as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def loaders():
    if not os.path.exists(jnative._LIB_PATHS[0]):
        subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       check=True, capture_output=True)
    return jnative.NativeImageLoader(n_threads=2), \
        tnative.NativeImageLoader(n_threads=2)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths = {"rgb": [], "gray": []}
    for i in range(3):
        rgb = rng.integers(0, 256, (37 + i, 53, 3), np.uint8)
        gray = rng.integers(0, 20, (64, 48 - i), np.uint8)
        paths["rgb"].append(str(d / f"rgb{i}.png"))
        paths["gray"].append(str(d / f"gray{i}.png"))
        Image.fromarray(rgb).save(paths["rgb"][-1])
        Image.fromarray(gray).save(paths["gray"][-1])
    return paths


def test_library_is_built_outside_native():
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "vlg_native"
    assert path.parent.parent.name == "build"


@pytest.mark.parametrize("hw", [(16, 24), (40, 53), (64, 48)])
def test_single_loads_identical(loaders, pngs, hw):
    j, t = loaders
    for p in pngs["rgb"]:
        a, b = j.load_rgb(p, hw), t.load_rgb(p, hw)
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    for p in pngs["gray"]:
        a, b = j.load_gray(p, hw), t.load_gray(p, hw)
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


def test_batch_loads_identical(loaders, pngs):
    j, t = loaders
    a = j.load_rgb_batch(pngs["rgb"] * 2, (20, 20))
    b = t.load_rgb_batch(pngs["rgb"] * 2, (20, 20))
    assert a.shape == (6, 20, 20, 3) and a.tobytes() == b.tobytes()
    a = j.load_gray_batch(pngs["gray"], (9, 11))
    b = t.load_gray_batch(pngs["gray"], (9, 11))
    assert a.shape == (3, 9, 11) and a.tobytes() == b.tobytes()
    with pytest.raises(IOError, match="1 of 2 images failed"):
        t.load_gray_batch([pngs["gray"][0], "/nonexistent.png"], (8, 8))
    with pytest.raises(FileNotFoundError):
        t.load_rgb("/nonexistent/x.png", (8, 8))


@pytest.mark.parametrize("level", [1, 6])
def test_save_png_identical(loaders, tmp_path, level):
    j, t = loaders
    rng = np.random.default_rng(level)
    for pix in (rng.integers(0, 256, (21, 30, 3), np.uint8),
                rng.integers(0, 256, (17, 9), np.uint8)):
        j.save_png(str(tmp_path / "j.png"), pix, level=level)
        t.save_png(str(tmp_path / "t.png"), pix, level=level)
        assert (tmp_path / "j.png").read_bytes() == \
            (tmp_path / "t.png").read_bytes()
        assert np.array_equal(np.asarray(Image.open(tmp_path / "t.png")), pix)


def test_cityscapes_reader_decodes_natively_or_falls_back(loaders, tmp_path,
                                                          monkeypatch):
    j, _ = loaders
    root = _png_tree(tmp_path / "tree")
    ds = tcity.CityscapesTriplets(str(root), (10, 12))
    assert ds.decoder == "native" and ds.native_error is None
    sample = ds[0]
    img = ds.samples[0][1][0]
    assert sample["img1"].tobytes() == j.load_rgb(img, (10, 12)).tobytes()

    def broken():
        raise OSError("building the native loader failed:\nno compiler")

    monkeypatch.setattr(tcity, "NativeImageLoader", broken)
    fallback = tcity.CityscapesTriplets(str(root), (10, 12))
    assert fallback.decoder in ("cv2", "PIL")
    assert "no compiler" in fallback.native_error
    np.testing.assert_array_equal(fallback[0]["seg3"], sample["seg3"])
    np.testing.assert_allclose(fallback[0]["img1"], sample["img1"],
                               atol=2.5 / 255)


def test_colorized_export_uses_the_native_writer(loaders, tmp_path):
    j, _ = loaders
    ids = np.random.default_rng(2).integers(0, 20, (12, 14))
    texport.save_colorized_png(str(tmp_path / "t.png"), ids)
    from video_layout_generation_tpu.evaluation import export as jexport
    jexport.save_colorized_png(str(tmp_path / "j.png"), ids)
    assert texport.png_writer()
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
