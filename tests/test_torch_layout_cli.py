"""The port's ``layout_cli.py``, ``evaluation/sequence.py:
evaluate_layout_rollout`` and ``train/experiment.py:ExperimentBase`` on the
CPU, against the JAX package's flags, rollout and the contracts of
``tests/test_experiment_base.py``."""

import os
import re

import numpy as np
import pytest
import torch

import jax

from video_layout_generation_tpu import layout_cli as jcli
from video_layout_generation_tpu.config import Config as JConfig
from video_layout_generation_tpu.data.synthetic import (
    SyntheticTriplets as JSynthetic)
from video_layout_generation_tpu.evaluation import (
    evaluate_layout_rollout as jevaluate)
from video_layout_generation_tpu.train.layout_trainer import (
    LayoutTrainer as JLayoutTrainer)
from video_layout_generation_tpu_torch import layout_cli
from video_layout_generation_tpu_torch.config import Config
from video_layout_generation_tpu_torch.data.synthetic import (
    SyntheticTriplets)
from video_layout_generation_tpu_torch.evaluation import (
    evaluate_layout_rollout)
from video_layout_generation_tpu_torch.io.checkpoint import copy_into
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.train.experiment import ExperimentBase
from video_layout_generation_tpu_torch.train.layout_trainer import (
    LayoutTrainer)
from video_layout_generation_tpu_torch.train.state import (TrainState,
                                                           current_lr,
                                                           make_optimizer)

CFG = dict(dataset="synthetic", synthetic_train_size=4,
           synthetic_val_size=4, image_size=(16, 16), batch_size=4,
           epochs=1, compute_dtype="float32", workers=1, path=None)


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_cli_flags_are_the_jax_flags_plus_device():
    """The JAX CLI builds its parser inside ``main``: its flags are read
    from its source."""
    src = open(jcli.__file__).read()
    jax_flags = set(re.findall(r'"(-{1,2}[A-Za-z_]+)"', src))
    assert _options(layout_cli.build_arg_parser()) == jax_flags | {
        "-h", "--help", "--device"}


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    """``--device cpu``: a fit of one epoch in the CLI's default bf16
    compute, its log, checkpoints and printed scores."""
    path = tmp_path / "exp"
    m = layout_cli.main([
        "--family", "cvae", "--size", "16", "-bs", "4", "-e", "1",
        "--n_classes", "8", "--latent_dim", "8",
        "--synthetic_train_size", "8", "--synthetic_val_size", "4",
        "--rollout_frames", "2", "-p", str(path), "--device", "cpu"])
    assert 0.0 <= m["miou"] <= 1.0
    assert "'miou'" in capsys.readouterr().out
    log = open(path / "experiment.log").read()
    assert "[layout/cvae] epoch 1" in log and "val mIoU" in log
    assert os.path.isfile(path / "checkpoint" / "001" / "checkpoint.pt")
    assert os.path.exists(path / "checkpoint" / "latest")


def test_evaluate_layout_rollout_convlstm_matches_jax():
    """The ConvLSTM's argmax-fed rollout is deterministic: from the JAX
    trainer's parameters the per-step scores equal the JAX package's."""
    jt = JLayoutTrainer(JConfig(**CFG, mesh_shape=(1,)), family="convlstm",
                        hidden=8)
    tt = LayoutTrainer(Config(**CFG, device="cpu"), family="convlstm",
                       hidden=8)
    copy_into(tt.state.params,
              params_from_flax(jax.device_get(jt.state.params)))
    want = jevaluate(jt, JSynthetic(size=4, image_hw=(16, 16), seed=3),
                     range(4), n_frames=3)
    got = evaluate_layout_rollout(
        tt, SyntheticTriplets(size=4, image_hw=(16, 16), seed=3), range(4),
        n_frames=3)
    np.testing.assert_allclose(got["per_step_miou"], want["per_step_miou"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["per_step_pixel_acc"],
                               want["per_step_pixel_acc"], rtol=0, atol=1e-6)


def test_evaluate_layout_rollout_cvae_and_vae():
    ds = SyntheticTriplets(size=4, image_hw=(16, 16), seed=3)
    t = LayoutTrainer(Config(**CFG, device="cpu"), family="cvae",
                      latent_dim=8)
    fid = evaluate_layout_rollout(t, ds, range(4), n_frames=3)
    assert fid["per_step_miou"].shape == (3,)
    assert np.all(fid["per_step_miou"] >= 0)
    assert np.all(fid["per_step_pixel_acc"] <= 1)
    # the prior's noise is seeded: the same scores again
    again = evaluate_layout_rollout(t, ds, range(4), n_frames=3)
    np.testing.assert_array_equal(fid["per_step_miou"],
                                  again["per_step_miou"])
    vae = LayoutTrainer(Config(**CFG, device="cpu"), family="vae",
                        latent_dim=8)
    with pytest.raises(ValueError, match="autoregressive"):
        evaluate_layout_rollout(vae, ds, range(4), n_frames=3)


class _Toy(ExperimentBase):
    def set_input(self, batch):
        self.x = batch

    def forward(self):
        return self.x

    def optimize_parameters(self):
        pass


def test_experiment_base_lifecycle(tmp_path):
    exp = _Toy(str(tmp_path), lr_policy="step", decay_iters=2, gamma=0.1)
    exp.register("G", object(), TrainState.create(
        {"w": torch.ones(3)}, make_optimizer("adam", lr=0.1)))
    exp.register("D", object(), TrainState.create(
        {"w": torch.ones(3)}, make_optimizer("adam", lr=0.1)))

    # freezing zeroes the gradients
    exp.set_requires_grad("D", False)
    assert torch.equal(exp.mask_frozen("D", {"w": torch.ones(3)})["w"],
                       torch.zeros(3))
    assert torch.equal(exp.mask_frozen("G", {"w": torch.ones(3)})["w"],
                       torch.ones(3))
    exp.set_requires_grad(["D"], True)
    assert not exp.frozen

    # per-epoch LR policy across all nets
    lrs = exp.update_learning_rate(epoch=2)
    assert abs(lrs["G"] - 0.01) < 1e-9 and abs(lrs["D"] - 0.01) < 1e-9

    # per-net save and load under <epoch>_net_<name>, restored in place
    exp.states["G"].params["w"].fill_(7.0)
    exp.save_networks(5)
    assert os.path.isfile(tmp_path / "5_net_G")
    assert os.path.isfile(tmp_path / "5_net_D")
    exp.states["G"].params["w"].zero_()
    exp.load_networks(5)
    assert torch.equal(exp.states["G"].params["w"], torch.full((3,), 7.0))

    # losses and visuals dicts
    exp.loss_names = ["g", "missing"]
    exp.loss_g = torch.tensor(1.5)
    assert exp.get_current_losses() == {"g": 1.5}
    exp.visual_names = ["x"]
    assert exp.test(torch.ones(2)).shape == (2,)
    assert list(exp.get_current_visuals()) == ["x"]


def test_experiment_base_plateau(tmp_path):
    exp = _Toy(str(tmp_path), lr_policy="plateau")
    exp.register("G", object(), TrainState.create(
        {"w": torch.ones(1)}, make_optimizer("adam", lr=1.0)))
    exp.metric = 1.0
    for _ in range(7):
        lrs = exp.update_learning_rate(epoch=0)
    # 1 improvement, then 6 bad epochs > patience 5: one 0.2x cut
    assert abs(lrs["G"] - 0.2) < 1e-12
    assert current_lr(exp.states["G"]) == lrs["G"]
