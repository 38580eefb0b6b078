"""The port's torch checkpoint reader (``io/torch_reader.py``, built on
``torch.load(weights_only=True)``) against the JAX package's pure-Python
reader on the same ``torch.save`` files, in both serialization formats;
and its HED / VGG19 mappings against ``tools/convert_torch_weights.py``."""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from video_layout_generation_tpu.io import torch_reader as jreader
from video_layout_generation_tpu_torch.io import torch_reader
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.losses.vgg import VGG19Features
from video_layout_generation_tpu_torch.models import HNED

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_torch_weights import convert_hned, convert_vgg19  # noqa: E402
from test_weight_convert import _fake_hned_state_dict  # noqa: E402


def sample_state_dict():
    g = torch.Generator().manual_seed(0)
    return {
        "conv.weight": torch.randn(8, 3, 3, 3, generator=g),
        "conv.bias": torch.randn(8, generator=g),
        "transposed": torch.randn(4, 6, generator=g).t(),  # non-contiguous
        "scalar": torch.tensor(3.5),
        "ids": torch.arange(10, dtype=torch.int64),
        "half": torch.randn(5, generator=g).half(),
        "flag": torch.tensor(True),
    }


def assert_same_arrays(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("zip_format", [True, False])
def test_state_dict_matches_the_jax_reader(tmp_path, zip_format):
    path = str(tmp_path / "sd.pth")
    torch.save(sample_state_dict(), path,
               _use_new_zipfile_serialization=zip_format)
    assert_same_arrays(torch_reader.read_torch_state_dict(path),
                       jreader.read_torch_state_dict(path))


@pytest.mark.parametrize("zip_format", [True, False])
def test_wrapped_state_dict_key(tmp_path, zip_format):
    path = str(tmp_path / "wrap.pth")
    torch.save({"generator": sample_state_dict(), "epoch": 7}, path,
               _use_new_zipfile_serialization=zip_format)
    assert_same_arrays(
        torch_reader.read_torch_state_dict(path, key="generator"),
        jreader.read_torch_state_dict(path, key="generator"))
    full = torch_reader.read_torch_checkpoint(path)
    assert full["epoch"] == jreader.read_torch_checkpoint(path)["epoch"] == 7
    with pytest.raises(ValueError, match="did not contain a state dict"):
        torch.save([torch.zeros(1)], path)
        torch_reader.read_torch_state_dict(path)


@pytest.mark.parametrize("zip_format", [True, False])
def test_shared_storage_views(tmp_path, zip_format):
    base = torch.arange(12, dtype=torch.float32)
    path = str(tmp_path / "views.pth")
    torch.save({"full": base, "view": base[3:9], "mat": base.reshape(3, 4)},
               path, _use_new_zipfile_serialization=zip_format)
    got = torch_reader.read_torch_state_dict(path)
    assert_same_arrays(got, jreader.read_torch_state_dict(path))
    got["view"][0] = -1.0        # copies: no view aliases another
    assert got["full"][3] == 3.0 and got["mat"][0, 3] == 3.0


def test_bf16_reads_as_its_exact_f32_value(tmp_path):
    t = torch.randn(6, generator=torch.Generator().manual_seed(1)).bfloat16()
    path = str(tmp_path / "bf16.pth")
    torch.save({"w": t}, path)
    got = torch_reader.read_torch_state_dict(path)["w"]
    want = jreader.read_torch_state_dict(path)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_hostile_pickle_is_refused(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    path = str(tmp_path / "evil.pth")
    torch.save({"x": torch.zeros(1), "payload": Evil()}, path)
    with pytest.raises(pickle.UnpicklingError):
        torch_reader.read_torch_checkpoint(path)


def test_hed_pth_to_the_port_hned(tmp_path):
    """A fake HED ``.pth`` -> the port's reader and HED mapping -> the
    port's HNED, equal key for key and bit for bit to the JAX package's
    route (its reader, ``tools/convert_torch_weights.py:convert_hned``,
    the weight bridge)."""
    sd = _fake_hned_state_dict(seed=5)
    path = str(tmp_path / "hed.pth")
    torch.save({"generator": sd}, path)
    got = torch_reader.convert_hned(
        torch_reader.read_torch_state_dict(path, key="generator"))
    want = params_from_flax(convert_hned(
        jreader.read_torch_state_dict(path, key="generator")))
    assert list(got) == list(want) and len(got) == 38
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    HNED().load_state_dict(got, strict=True)


def test_vgg19_mapping_and_no_download():
    rng = np.random.default_rng(2)
    widths = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
              (256, 256), (256, 256), (256, 256), (256, 512), (512, 512),
              (512, 512), (512, 512)]
    sd = {}
    for idx, (ci, co) in zip((0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25),
                             widths):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.standard_normal((co, ci, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.standard_normal(co).astype(np.float32))
    got = torch_reader.convert_vgg19(sd)
    want = params_from_flax(convert_vgg19(sd))
    assert list(got) == list(want) and len(got) == 24
    assert all(torch.equal(got[k], want[k]) for k in want)
    VGG19Features().load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="nothing is downloaded"):
        torch_reader.convert_vgg19(None)
