"""The port's ``Trainer`` (``train/trainer.py``) on the CPU: one epoch of
``fit`` against the JAX package's ``Trainer``, the LR policies and the
device rule. ``test_torch_trainer_edge.py`` holds the edge-mode epoch
against the JAX ``Trainer``, ``test_torch_trainer_loop.py`` resume, rollout
fidelity between epochs and the GAN trainer (files of their own, each well
under a minute alone).

Tiny configuration: synthetic 8 train / 4 validation samples, 32x32, batch
4 (2 steps an epoch), GridNet filters (4, 6, 8), f32, 2 rollout frames,
``device="cpu"``, the committed ``vgg_synth`` (and, with edges,
``hned_synth``) weights on both sides. The JAX ``Trainer`` runs its jitted
steps; its initial parameters are carried into the port's model through
``params_from_flax``. The flip's coin cannot be drawn alike (threefry
``fold_in`` against a ``torch.Generator``), so both step factories get
``flip_mode="none"``, patched into each trainer module here only.

Tolerances: the ROADMAP's f32 figure is about 3e-5 in the parameters after
one Adam step; after this epoch's two steps every parameter is held within
3e-5 (measured: 1.0e-6 without edges), the validation loss within 1e-5
relative (measured 3e-7) and mIoU and pixel accuracy within 1e-3 (measured:
equal).
"""

import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.config import Config as JaxConfig
from video_layout_generation_tpu.train import steps as jsteps
from video_layout_generation_tpu.train import trainer as jtrainer
from video_layout_generation_tpu_torch.config import Config
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.train import steps as tsteps
from video_layout_generation_tpu_torch.train import trainer as ttrainer
from video_layout_generation_tpu_torch.train.state import current_lr
from video_layout_generation_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1] / "artifacts_store"
TINY = dict(dataset="synthetic", synthetic_train_size=8, synthetic_val_size=4,
            image_size=(32, 32), batch_size=4, epochs=1,
            filters_level=(4, 6, 8), compute_dtype="float32", workers=2,
            print_freq=1, rollout_frames=2,
            hed_weights=str(ROOT / "hned_synth.npz"),
            vgg_weights=str(ROOT / "vgg_synth.npz"))
PARAM_ATOL = 3e-5
LOSS_RTOL = 1e-5
SCORE_ATOL = 1e-3


def tiny(path, **kw) -> Config:
    return Config(path=str(path), device="cpu", **dict(TINY, **kw))


def fit_pair(tmp, edge: bool) -> dict:
    """One epoch of ``fit`` by the JAX ``Trainer`` and by the port's, from
    the same initial parameters, flip off on both sides."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "make_train_step", functools.partial(
            jsteps.make_train_step, flip_mode="none"))
        mp.setattr(ttrainer, "make_train_step", functools.partial(
            tsteps.make_train_step, flip_mode="none"))
        # no experiment directory on the JAX side: no orbax checkpoint, no
        # TensorBoard images, nothing the comparison reads
        jt = jtrainer.Trainer(JaxConfig(path=None, edge=edge,
                                        mesh_shape=(1,), **TINY))
        # the initial state's arrays are uncommitted and the step's outputs
        # committed: committed from the start, the jitted step compiles
        # once instead of twice (the same program either way)
        jt.state = jax.device_put(jt.state, jax.devices()[0])
        tt = Trainer(tiny(tmp / "port", edge=edge))
        tt.model.load_state_dict(params_from_flax(jt.state.params),
                                 strict=True)
        jm = jt.fit()
        tm = tt.fit()
    return dict(jt=jt, tt=tt, jm=jm, tm=tm)


def assert_fit_matches(pair):
    jt, tt = pair["jt"], pair["tt"]
    assert jt.global_step == tt.global_step == 2
    assert jt.epoch == tt.epoch == 1
    want = params_from_flax(jt.state.params)
    got = tt.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= PARAM_ATOL, (k, err)
    jm, tm = pair["jm"], pair["tm"]
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_RTOL)
    assert abs(tm["miou"] - jm["miou"]) <= SCORE_ATOL
    assert abs(tm["pixel_acc"] - jm["pixel_acc"]) <= SCORE_ATOL
    assert (tt.cfg.path and
            (Path(tt.cfg.path) / "checkpoint" / "001").is_dir())


@pytest.fixture(scope="module")
def no_edge_pair(tmp_path_factory):
    return fit_pair(tmp_path_factory.mktemp("fit"), edge=False)


def test_fit_one_epoch_matches_jax(no_edge_pair):
    assert_fit_matches(no_edge_pair)
    tt = no_edge_pair["tt"]
    assert tt.model_state.step == 2 and tt.model_state.opt_state["count"] == 2


def test_lr_policies_reachable_from_the_trainer(tmp_path):
    t = Trainer(tiny(tmp_path / "linear", edge=False, lr_policy="linear",
                     niter=1, niter_decay=4, lr=1e-3))
    lrs = []
    for epoch in range(3):
        t.set_epoch(epoch)
        lrs.append(current_lr(t.state))
    assert lrs == pytest.approx([1e-3, 1e-3 * (1 - 1 / 5),
                                 1e-3 * (1 - 2 / 5)])
    t = Trainer(tiny(tmp_path / "step", edge=False, lr_policy="step",
                     lr_decay_iters=2, lr=1e-3))
    t.set_epoch(0)
    assert current_lr(t.state) == pytest.approx(1e-3)
    t.set_epoch(2)
    assert current_lr(t.state) == pytest.approx(1e-4)
    t = Trainer(tiny(tmp_path / "sgd", edge=False, optimizer="sgd",
                     lr_decay_step=1, lr_decay_gamma=0.5, lr=1e-2))
    t.set_epoch(2)
    assert current_lr(t.state) == pytest.approx(2.5e-3)
    t = Trainer(tiny(tmp_path / "cosine", edge=False, lr_policy="cosine",
                     niter=4, lr=1e-3, gan_train=True, ndf=8))
    t.set_epoch(2)
    assert current_lr(t.state.gen) == current_lr(t.state.disc) == \
        pytest.approx(5e-4)
    t = Trainer(tiny(tmp_path / "plateau", edge=False, lr_policy="plateau",
                     epochs=1))
    t.fit()
    assert current_lr(t.state) == pytest.approx(2e-4)   # one epoch: kept


def test_cuda_config_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(path=str(tmp_path), **dict(TINY, edge=False)))
    assert Config().device == "cuda"
