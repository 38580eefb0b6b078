"""``LayoutTrainer`` of the port (``train/layout_trainer.py``) on the CPU.

Against the JAX package: one epoch of ``fit`` of the ConvLSTM (no noise:
the family is deterministic) from the JAX trainer's initial parameters, on
the same synthetic data in the same order, parameters within 1e-5 and the
validation's scores equal. The port's own contracts, after the JAX
package's ``test_layout_trainer.py`` and ``test_layout_multistep.py``:
each family fits, resumes bit for bit (an epoch and a resume equal two
epochs uninterrupted: the noise is reseeded from (seed, step)) and warm
starts; the K-step windows flow end to end; the committed ``cvae256_036``
snapshot warm starts a CVAE whole; the refused options raise.
"""

import numpy as np
import pytest
import torch

import jax

from video_layout_generation_tpu.config import Config as JConfig
from video_layout_generation_tpu.train.layout_trainer import (
    LayoutTrainer as JLayoutTrainer)
from video_layout_generation_tpu_torch.config import Config
from video_layout_generation_tpu_torch.io.checkpoint import copy_into
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.train.layout_trainer import (
    LayoutTrainer)

HW, N_CLS = 16, 8
SNAPSHOT = "artifacts_store/cvae256_036.npz"
SMALL = dict(latent_dim=8, hidden=8, kl_warmup_steps=10)


def cfg_kw(**kw):
    base = dict(dataset="synthetic", synthetic_train_size=8,
                synthetic_val_size=4, image_size=(HW, HW),
                n_classes=N_CLS, batch_size=4, epochs=1,
                compute_dtype="float32", workers=1, rollout_frames=2,
                lr=1e-3)
    base.update(kw)
    return base


def port_cfg(path, **kw):
    return Config(**cfg_kw(path=None if path is None else str(path),
                           device="cpu", **kw))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_convlstm_fit_matches_jax():
    jt = JLayoutTrainer(JConfig(**cfg_kw(path=None, mesh_shape=(1,))),
                        family="convlstm", hidden=8)
    init = params_from_flax(jax.device_get(jt.state.params))
    tt = LayoutTrainer(port_cfg(None), family="convlstm", hidden=8)
    copy_into(tt.state.params, init)
    jm, tm = jt.fit(), tt.fit()
    assert jt.global_step == tt.global_step == 2
    got = {k: v.detach().numpy() for k, v in tt.state.params.items()}
    for k, v in params_from_flax(jax.device_get(jt.state.params)).items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert abs(tm["miou"] - jm["miou"]) < 1e-6
    assert abs(tm["pixel_acc"] - jm["pixel_acc"]) < 1e-6


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.state.params.items()}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("family", ["vae", "cvae", "convlstm"])
def test_layout_trainer_fit_resume_warm_start(family, tmp_path):
    # fit: one epoch, two steps, a validation, a checkpoint
    t = LayoutTrainer(port_cfg(tmp_path / "a"), family=family, **SMALL)
    m = t.fit()
    assert 0.0 <= m["miou"] <= 1.0 and 0.0 <= m["pixel_acc"] <= 1.0
    assert t.global_step == 2 and t.epoch == 1
    assert (tmp_path / "a" / "checkpoint" / "latest").exists()
    after_1 = _params(t)

    # resume: the restored state equals the saved one, and one more epoch
    # equals two epochs uninterrupted, bit for bit
    t2 = LayoutTrainer(port_cfg(tmp_path / "a", epochs=2, resume="latest"),
                       family=family, **SMALL)
    assert (t2.epoch, t2.global_step, t2.state.step) == (1, 2, 2)
    _equal(_params(t2), after_1)
    assert t2.state.opt_state["count"] == 2
    m2 = t2.fit()
    t3 = LayoutTrainer(port_cfg(tmp_path / "b", epochs=2), family=family,
                       **SMALL)
    m3 = t3.fit()
    assert t2.global_step == t3.global_step == 4
    _equal(_params(t2), _params(t3))
    assert m2["miou"] == m3["miou"]

    # warm start: weights only, fresh optimizer and epoch
    ck = str(tmp_path / "a" / "checkpoint" / "001")
    t4 = LayoutTrainer(port_cfg(tmp_path / "c", ckpt=ck), family=family,
                       **SMALL)
    assert t4.epoch == 0 and t4.global_step == 0
    assert t4.state.opt_state["count"] == 0
    assert len(t4.warm_start_report["loaded"]) == len(after_1)
    _equal(_params(t4), after_1)


def test_multistep_windows_end_to_end(tmp_path):
    """multistep_k=2 flows through get_dataset (4-frame windows) into the
    K-step steps of both autoregressive families; the vae family refuses
    it."""
    for family in ("cvae", "convlstm"):
        t = LayoutTrainer(port_cfg(tmp_path / family, multistep_k=2,
                                   multistep_layout_noise=0.05),
                          family=family, **SMALL)
        assert t.train_loader.loader.ds.n_frames == 4
        m = t.fit()
        assert 0.0 <= m["miou"] <= 1.0 and t.global_step == 2
    with pytest.raises(ValueError, match="autoregressive"):
        LayoutTrainer(port_cfg(tmp_path / "v", multistep_k=2), family="vae",
                      latent_dim=8)


def test_snapshot_warm_start_and_refusals(tmp_path):
    """``cvae256_036.npz`` read directly: all 42 tensors into a latent-64
    CVAE; a checkpoint that shares no tensor, or another family's resume,
    raises."""
    t = LayoutTrainer(port_cfg(tmp_path / "w", n_classes=20, lr=5e-5,
                               ckpt=SNAPSHOT, image_size=(32, 32)),
                      family="cvae", latent_dim=64)
    rep = t.warm_start_report
    assert len(rep["loaded"]) == 42 and not rep["missing"]
    assert 0.0 <= t.validate()["miou"] <= 1.0
    with pytest.raises(ValueError, match="shares no parameters"):
        LayoutTrainer(port_cfg(tmp_path / "x", n_classes=20, ckpt=SNAPSHOT),
                      family="convlstm", hidden=8)
    lstm = LayoutTrainer(port_cfg(tmp_path / "y"), family="convlstm",
                         hidden=8)
    lstm.fit()
    with pytest.raises(ValueError, match="Architecture mismatch"):
        LayoutTrainer(port_cfg(tmp_path / "y", epochs=2, resume="latest"),
                      family="cvae", latent_dim=8)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        LayoutTrainer(port_cfg(None, mesh_shape=(2,)), family="convlstm",
                      hidden=8)
    threaded = LayoutTrainer(port_cfg(None, put_thread=True),
                             family="convlstm", hidden=8)
    assert threaded.train_loader.put_thread
    with pytest.raises(ValueError, match="unknown layout family"):
        LayoutTrainer(port_cfg(None), family="gan")
