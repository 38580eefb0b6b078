"""The port's ``Trainer`` loop on the CPU, on its own: a resumed run
equals an uninterrupted one bit for bit (plain with edges, and GAN), the
rollout under ``inference_mode`` between train epochs, and one epoch of the
GAN trainer. Configuration as in ``test_torch_trainer.py`` but smaller
(``small``: 16x16, 24x24 where the PatchGAN needs it) and on one torch
thread: at 32x32 on the default thread pool the resume cases took 81-100 s
under the suite's six workers, whose pools spun against each other.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_trainer import tiny
from video_layout_generation_tpu_torch.train.trainer import Trainer


def small(path, **kw):
    hw = (24, 24) if kw.get("gan_train") else (16, 16)
    return tiny(path, image_size=hw, **kw)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_tensors(t: Trainer) -> dict:
    out = {f"model/{k}": v for k, v in t.model.state_dict().items()}
    states = {"gen": t.model_state}
    if t.cfg.gan_train:
        states["disc"] = t.state.disc
        out.update({f"disc/{k}": v for k, v in t.disc.state_dict().items()})
    for name, s in states.items():
        for key in ("mu", "nu"):
            out.update({f"{name}/{key}/{k}": v
                        for k, v in s.opt_state[key].items()})
    return out


@pytest.mark.parametrize("kw", [dict(edge=True),
                                dict(edge=False, gan_train=True, ndf=8)],
                         ids=["plain_edges", "gan"])
def test_resume_equals_uninterrupted_run(kw, tmp_path):
    """1 + 1 epochs through ``--resume latest`` give the bits of 2 epochs:
    the flip's coins come from (seed, step), and restores write in place."""
    whole = Trainer(small(tmp_path / "whole", epochs=2, **kw))
    m_whole = whole.fit()
    Trainer(small(tmp_path / "split", epochs=1, **kw)).fit()
    resumed = Trainer(small(tmp_path / "split", epochs=2, resume="latest",
                           **kw))
    assert (resumed.epoch, resumed.global_step) == (1, 2)
    m_resumed = resumed.fit()
    assert (resumed.epoch, resumed.global_step) == (2, 4)
    a, b = _state_tensors(whole), _state_tensors(resumed)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for s1, s2 in ((whole.model_state, resumed.model_state),):
        assert s1.opt_state["count"] == s2.opt_state["count"] == 4
        assert s1.step == s2.step == 4
    assert m_whole["loss"] == m_resumed["loss"]
    assert m_whole["miou"] == m_resumed["miou"]


def test_fit_with_rollout_fidelity_every_epoch(tmp_path):
    """The rollout (under ``inference_mode``) runs between train epochs
    and the next epoch trains on."""
    t = Trainer(small(tmp_path, edge=True, epochs=2, rollout_fidelity_every=1,
                     rollout_fidelity_scenes=2))
    metrics = t.fit()
    assert t.global_step == 4 and math.isfinite(metrics["loss"])
    log = (tmp_path / "experiment.log").read_text()
    assert log.count("Rollout fidelity mean") == 2
    assert (tmp_path / "checkpoint" / "002").is_dir()
    fid = t.eval_rollout_fidelity()
    assert fid["per_step_miou"].shape == (2,)
    assert 0.0 <= fid["mean_miou"] <= 1.0
    imgs, segs = t.generate_sequence(*(np.zeros((1, 32, 32, c), np.float32)
                                       for c in (3, 3, 1, 1)))
    assert imgs.shape == (1, 2, 32, 32, 3) and segs.shape == (1, 2, 32, 32, 1)


def test_gan_trainer_takes_one_epoch(tmp_path):
    t = Trainer(small(tmp_path, edge=True, gan_train=True, ndf=8))
    before = {k: v.clone() for k, v in t.state.disc.params.items()}
    gen_before = {k: v.clone() for k, v in t.model_state.params.items()}
    metrics = t.fit()
    assert math.isfinite(metrics["loss"])
    assert t.state.step == t.state.disc.step == 2
    assert any(not torch.equal(v, before[k])
               for k, v in t.state.disc.params.items())
    assert all(not torch.equal(v, gen_before[k])
               for k, v in t.model_state.params.items())
    log = (tmp_path / "experiment.log").read_text()
    assert "Epoch [1/1][2/2]" in log


def test_resnet_generator_trainer_epoch_and_rollout(tmp_path):
    """The pix2pix generator through the same loop: one epoch, validation,
    a checkpoint and the rollout (which calls it without GridNet's
    upsample choice)."""
    t = Trainer(small(tmp_path, edge=False, arch="ResnetGenerator", ngf=8))
    metrics = t.fit()
    assert math.isfinite(metrics["loss"]) and t.global_step == 2
    assert (tmp_path / "checkpoint" / "001").is_dir()
    imgs, segs = t.generate_sequence(*(np.zeros((1, 32, 32, c), np.float32)
                                       for c in (3, 3, 1, 1)), save=False)
    assert imgs.shape == (1, 2, 32, 32, 3) and segs.shape == (1, 2, 32, 32, 1)
    assert torch.isfinite(imgs).all()
