"""The port's checkpoints (``io/checkpoint.py``) and their use by the
``Trainer`` and ``LayoutPredictor``, on the CPU.

- A save and restore round trip is bit-identical: parameters and buffers,
  Adam's moments and count, the learning rate, step and epoch, and in GAN
  mode the discriminator's parameters, moments and BatchNorm statistics.
- ``merge_params`` reports the same names as the JAX package's on the two
  warm starts of ``tests/test_warm_start.py`` (GridNet -> CoordGridNet, and
  an 8-channel GridNet into a 10-channel one), with the JAX side's trees
  from ``jax.eval_shape`` of the flax models.
- A checkpoint that shares no parameter with the model raises.
- A flat npz snapshot (``artifacts_store/flagship_096.npz``) loads through
  ``restore_path``, warm-starts every tensor of the full-width GridNet, and
  refuses a full resume.
- ``LayoutPredictor.from_checkpoint`` on a trainer's ``checkpoint/latest``
  answers as a predictor built from the trainer's live parameters.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.io.checkpoint import \
    merge_params as jax_merge_params
from video_layout_generation_tpu.models import gridnet as jgrid
from video_layout_generation_tpu_torch.config import Config
from video_layout_generation_tpu_torch.io.checkpoint import (
    CKPT_FILE, CheckpointManager, merge_params)
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.models import get_model_cls
from video_layout_generation_tpu_torch.serving import LayoutPredictor
from video_layout_generation_tpu_torch.train.state import current_lr
from video_layout_generation_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1] / "artifacts_store"
FILTERS = (4, 6, 8)
TINY = dict(dataset="synthetic", synthetic_train_size=8, synthetic_val_size=4,
            image_size=(32, 32), batch_size=4, epochs=1, edge=False,
            filters_level=FILTERS, compute_dtype="float32", workers=2,
            print_freq=100, rollout_frames=2, device="cpu",
            vgg_weights=str(ROOT / "vgg_synth.npz"))


def tiny(path, **kw) -> Config:
    return Config(path=str(path), **dict(TINY, **kw))


def assert_equal_tensors(a: dict, b: dict):
    assert set(a) == set(b) and a
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def assert_same_state(t1: Trainer, t2: Trainer):
    assert (t1.epoch, t1.global_step) == (t2.epoch, t2.global_step)
    assert_equal_tensors(t1.model.state_dict(), t2.model.state_dict())
    pairs = [(t1.model_state, t2.model_state)]
    if t1.cfg.gan_train:
        pairs.append((t1.state.disc, t2.state.disc))
        assert_equal_tensors(t1.state.disc_stats, t2.state.disc_stats)
    for s1, s2 in pairs:
        assert s1.step == s2.step == t1.global_step
        assert_equal_tensors(s1.params, s2.params)
        for key in ("mu", "nu"):
            assert_equal_tensors(s1.opt_state[key], s2.opt_state[key])
        assert s1.opt_state["count"] == s2.opt_state["count"] > 0
        assert s1.opt_state["learning_rate"] == s2.opt_state["learning_rate"]


@pytest.mark.parametrize("gan", [False, True], ids=["plain", "gan"])
def test_save_restore_round_trip_bit_identical(gan, tmp_path):
    kw = dict(gan_train=True, ndf=8, norm="batch") if gan else {}
    t1 = Trainer(tiny(tmp_path, **kw))
    t1.fit()
    t1._apply_lr(1.234e-4)           # a rate of its own, saved beside
    t1.save_checkpoint()
    assert os.path.isfile(tmp_path / "checkpoint" / "001" / CKPT_FILE)
    assert os.path.realpath(tmp_path / "checkpoint" / "latest") == \
        os.path.realpath(tmp_path / "checkpoint" / "001")
    t2 = Trainer(tiny(tmp_path, resume="latest", **kw))
    assert t2.epoch == 1 and t2.global_step == 2
    assert current_lr(t2.model_state) == 1.234e-4
    assert_same_state(t1, t2)
    tree = CheckpointManager(tmp_path / "checkpoint").restore(
        1, arch=t1.cfg.arch)
    assert tree["arch"] == "CoordGridNet" and tree["step"] == 2
    if gan:
        assert set(tree) >= {"disc_params", "disc_opt_state", "disc_stats"}
        assert any(k.endswith(".mean") for k in tree["disc_stats"])
    with pytest.raises(ValueError, match="Architecture mismatch"):
        CheckpointManager(tmp_path / "checkpoint").restore("latest",
                                                            arch="GridNet")


def _flax_vars(arch, n_channels):
    model = getattr(jgrid, arch)(n_channels=n_channels,
                                 filters_level=FILTERS)
    return jax.eval_shape(model.init, jax.random.key(0),
                          jnp.zeros((1, 32, 32, n_channels)))


def _port_names(item: str) -> str:
    """A JAX report entry under the port's state-dict names."""
    name, sep, rest = item.partition(" ")
    name = name.removeprefix("params/").replace("/", ".")
    return name + sep + rest


@pytest.mark.parametrize("src,dst", [
    (("GridNet", 8), ("CoordGridNet", 8)),
    (("GridNet", 8), ("GridNet", 10)),
], ids=["gridnet_to_coord", "changed_head"])
def test_merge_params_reports_the_jax_names(src, dst):
    _, jrep = jax_merge_params(_flax_vars(*dst), _flax_vars(*src))
    live = get_model_cls(dst[0])(n_channels=dst[1], filters_level=FILTERS)
    restored = get_model_cls(src[0])(n_channels=src[1],
                                     filters_level=FILTERS).state_dict()
    merged, rep = merge_params(live.state_dict(), restored)
    assert set(rep) == set(jrep)
    for kind in rep:
        assert rep[kind] == sorted(_port_names(n) for n in jrep[kind]), kind
    assert rep["loaded"] and (rep["missing"] or rep["shape_mismatch"])
    for k in rep["loaded"]:
        assert merged[k] is restored[k]


def test_cross_arch_warm_start_in_the_trainer(tmp_path):
    src = Trainer(tiny(tmp_path / "src", arch="GridNet"))
    src.fit()
    ckpt = str(tmp_path / "src" / "checkpoint" / "001")
    dst = Trainer(tiny(tmp_path / "dst", arch="CoordGridNet", ckpt=ckpt))
    rep = dst.warm_start_report["generator"]
    assert rep["loaded"] and rep["missing"] and rep["unexpected"]
    live, saved = dst.model.state_dict(), src.model.state_dict()
    for k in rep["loaded"]:
        assert torch.equal(live[k], saved[k]), k
    dst.fit()                                    # and it still trains
    assert dst.global_step == 2


def test_disjoint_checkpoint_raises(tmp_path):
    path = tmp_path / "alien" / "000"
    path.mkdir(parents=True)
    torch.save({"params": {"alien.kernel": torch.zeros(1, 1)},
                "opt_state": {}, "epoch": 0, "step": 0, "arch": "Other"},
               path / CKPT_FILE)
    with pytest.raises(ValueError, match="shares no parameters"):
        Trainer(tiny(tmp_path / "exp", arch="GridNet", ckpt=str(path)))


def test_flat_snapshot_through_restore_path(tmp_path):
    snap = ROOT / "flagship_096.npz"
    tree = CheckpointManager.restore_path(str(snap), arch="GridNet")
    assert (tree["epoch"], tree["step"], tree["arch"]) == (96, 3072,
                                                           "GridNet")
    assert len(tree["params"]) == 182
    with np.load(snap) as flat:
        want = params_from_flax({k: flat[k] for k in flat.files})
    assert_equal_tensors(tree["params"], want)
    cfg = tiny(tmp_path, arch="GridNet", edge=True, filters_level=(32, 64, 96),
               ckpt=str(snap), hed_weights=str(ROOT / "hned_synth.npz"))
    t = Trainer(cfg)
    rep = t.warm_start_report["generator"]
    assert len(rep["loaded"]) == 182
    assert not (rep["missing"] or rep["unexpected"] or rep["shape_mismatch"])
    assert_equal_tensors(dict(t.model.state_dict()), want)
    with pytest.raises(ValueError, match="weights-only snapshot"):
        Trainer(cfg.replace(ckpt=None, resume=str(snap)))


def test_predictor_from_checkpoint_answers_as_live(tmp_path):
    t = Trainer(tiny(tmp_path, arch="GridNet"))
    t.fit()
    kw = dict(n_frames=2, batch=2, image_hw=(32, 32), filters_level=FILTERS,
              use_bf16=False, device="cpu")
    from_ckpt = LayoutPredictor.from_checkpoint(
        str(tmp_path / "checkpoint" / "latest"), arch="CoordGridNet", **kw)
    assert from_ckpt.arch == "GridNet"              # the saved arch wins
    live = LayoutPredictor("GridNet", t.model.state_dict(), **kw)
    rng = np.random.default_rng(5)
    img1, img2 = (rng.random((2, 32, 32, 3), np.float32) for _ in range(2))
    seg1, seg2 = (rng.integers(0, 20, (2, 32, 32)) for _ in range(2))
    f1, l1 = from_ckpt.predict(img1, img2, seg1, seg2)
    f2, l2 = live.predict(img1, img2, seg1, seg2)
    assert f1.tobytes() == f2.tobytes() and l1.tobytes() == l2.tobytes()
