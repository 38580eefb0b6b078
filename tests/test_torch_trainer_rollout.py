"""The port's ``Trainer`` with rollout-fidelity training on the CPU: one
epoch of ``fit`` with ``multistep_k=2`` and edges against the JAX
package's ``Trainer``, and the JAX ``Trainer``'s ``ValueError`` for each
combination of step and executor it refuses.

Configuration and flip rule of ``test_torch_trainer.py`` (synthetic 8
train / 4 validation samples, here 4-frame windows, 32x32, batch 4: 2
steps an epoch; the default CoordGridNet at filters (4, 6, 8) with edges,
f32; both K-step step factories patched to ``flip_mode="none"``, since the
coins cannot be drawn alike). Tolerances: every parameter within 3e-5
after the epoch, the validation loss within 1e-5 relative, mIoU and pixel
accuracy within 1e-3.
"""

import functools

import pytest

from test_torch_multistep import one_torch_thread  # noqa: F401  (fixture)
from test_torch_trainer import TINY, assert_fit_matches, tiny
from video_layout_generation_tpu.config import Config as JaxConfig
from video_layout_generation_tpu.train import multistep as jms
from video_layout_generation_tpu.train import trainer as jtrainer
from video_layout_generation_tpu_torch.config import Config
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.train import multistep as tms
from video_layout_generation_tpu_torch.train import trainer as ttrainer
from video_layout_generation_tpu_torch.train.trainer import Trainer


@pytest.fixture(scope="module")
def rollout_pair(tmp_path_factory):
    import jax
    tmp = tmp_path_factory.mktemp("fit_rollout")
    with pytest.MonkeyPatch.context() as mp:
        # the JAX Trainer imports the factory from its module when it
        # builds the step
        mp.setattr(jms, "make_multistep_train_step", functools.partial(
            jms.make_multistep_train_step, flip_mode="none"))
        mp.setattr(ttrainer, "make_multistep_train_step", functools.partial(
            tms.make_multistep_train_step, flip_mode="none"))
        # the unpacked model: one program less to compile on the JAX side
        jt = jtrainer.Trainer(JaxConfig(path=None, edge=True, mesh_shape=(1,),
                                        multistep_k=2, fast_train=False,
                                        **TINY))
        jt.state = jax.device_put(jt.state, jax.devices()[0])
        tt = Trainer(tiny(tmp / "port", edge=True, multistep_k=2))
        tt.model.load_state_dict(params_from_flax(jt.state.params),
                                 strict=True)
        jm = jt.fit()
        tm = tt.fit()
    return dict(jt=jt, tt=tt, jm=jm, tm=tm)


def test_fit_one_epoch_of_k2_matches_jax(rollout_pair):
    assert_fit_matches(rollout_pair)
    tt = rollout_pair["tt"]
    assert tt.train_loader.loader.ds.n_frames == 4
    assert tt.val_loader.loader.ds.n_frames == 3
    log = (tt.cfg and open(f"{tt.cfg.path}/experiment.log").read())
    assert "loss per rollout step [" in log


# the JAX Trainer's messages, in the order it checks them
REFUSED = [
    (dict(gan_train=True, multistep_k=2),
     "multistep_k > 1 is not supported with gan_train (single-step "
     "adversarial loss)"),
    (dict(gan_train=True, scheduled_sampling=0.5),
     "scheduled_sampling is not supported with gan_train (single-step "
     "adversarial loss)"),
    (dict(multistep_k=2, scheduled_sampling=0.5),
     "scheduled_sampling and multistep_k > 1 are separate rollout-fidelity "
     "objectives; pick one"),
    (dict(gan_train=True, chunk_steps=2),
     "epoch_scan / chunk_steps need a non-GAN trainer (scan carries one "
     "TrainState)"),
    (dict(gan_train=True, epoch_scan=True, device_data=True),
     "epoch_scan / chunk_steps need a non-GAN trainer (scan carries one "
     "TrainState)"),
    (dict(scheduled_sampling=0.5, chunk_steps=2),
     "scheduled_sampling is per-step only (its p-ramp changes the program "
     "across epochs)"),
    (dict(scheduled_sampling=0.5, epoch_scan=True, device_data=True),
     "scheduled_sampling is per-step only (its p-ramp changes the program "
     "across epochs)"),
    (dict(epoch_scan=True),
     "epoch_scan requires device_data=True (use chunk_steps for host-fed "
     "data)"),
    (dict(chunk_steps=2, device_data=True),
     "chunk_steps is the host-fed executor; device_data already has "
     "epoch_scan"),
]


@pytest.mark.parametrize("kw,msg", REFUSED,
                         ids=["-".join(sorted(r[0])) for r in REFUSED])
def test_refused_combination_raises_the_jax_message(kw, msg, tmp_path):
    with pytest.raises(ValueError) as err:
        Trainer(Config(path=str(tmp_path), device="cpu", **dict(TINY, **kw)))
    assert str(err.value) == msg
    assert not (tmp_path / "checkpoint").exists()   # raised before building


def test_device_data_needs_a_scene_table(tmp_path):
    class NoTable:
        n_frames = 3

        def __len__(self):
            return 4

    with pytest.raises(ValueError, match="scene_table"):
        Trainer(tiny(tmp_path, edge=False, device_data=True),
                dataset_train=NoTable(), dataset_val=NoTable())


def test_scheduled_sampling_ramps_per_epoch(tmp_path):
    t = Trainer(tiny(tmp_path, edge=False, scheduled_sampling=0.6,
                     scheduled_ramp=3))
    ps = []
    for epoch in range(4):
        t.set_epoch(epoch)
        ps.append(t._ss_p)
    assert ps == pytest.approx([0.2, 0.4, 0.6, 0.6])
    assert t.train_loader.loader.ds.n_frames == 4
    t.set_epoch(0)
    t.train()
    assert t.global_step == 2
