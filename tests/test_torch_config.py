"""The port's ``Config`` and CLI shim (``config.py``) against the JAX
package's: for the defaults and for every flag of the JAX package's
``build_arg_parser``, ``config_from_args(argv)`` gives the same value in
every field of the JAX ``Config``. The port adds one field, ``device``
(default ``"cuda"``). Every option of the JAX package builds a trainer that
runs it; a ``mesh_shape`` of more devices than the run has processes raises
the JAX package's ``ValueError``, naming the ``torchrun`` launch, before
anything is built.
"""

import argparse
import dataclasses

import pytest

from video_layout_generation_tpu import config as jconfig
from video_layout_generation_tpu_torch import config as tconfig
from video_layout_generation_tpu_torch.train.trainer import Trainer


def _value_for(action: argparse.Action):
    """A non-default argv value for one option of the JAX parser."""
    if action.choices:
        return [next(str(c) for c in action.choices
                     if c != action.default)]
    if action.nargs in (2, 3):
        return ["48"] * action.nargs
    if action.nargs == "+":
        return ["1"]
    if action.type is int:
        return ["7"]
    if action.type is float:
        return ["0.375"]
    return ["/some/path"]


def _flag_argvs():
    """One argv for each option string of the JAX parser."""
    out = []
    for action in jconfig.build_arg_parser()._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        flag = max(action.option_strings, key=len)
        if action.nargs == 0:       # store_true / store_false
            out.append([flag])
        else:
            out.append([flag] + _value_for(action))
    return out


ARGVS = [[]] + _flag_argvs()


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_config_from_args_matches_jax(argv):
    jcfg = jconfig.config_from_args(argv)
    tcfg = tconfig.config_from_args(argv)
    for f in dataclasses.fields(jconfig.Config):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.model_in_channels == jcfg.model_in_channels
    assert tcfg.device == "cuda"


def test_config_fields_are_the_jax_fields_plus_device():
    jnames = [f.name for f in dataclasses.fields(jconfig.Config)]
    tnames = [f.name for f in dataclasses.fields(tconfig.Config)]
    assert set(tnames) == set(jnames) | {"device"}
    for f in dataclasses.fields(jconfig.Config):
        assert getattr(tconfig.Config(), f.name) == f.default or \
            f.default is dataclasses.MISSING, f.name
    assert tconfig.config_from_args(["--device", "cpu"]).device == "cpu"
    assert tconfig.Config().replace(edge=False).model_in_channels == 8


def test_every_flag_is_covered():
    """The parametrised argvs cover every dest of the JAX parser."""
    dests = {a.dest for a in jconfig.build_arg_parser()._actions
             if not isinstance(a, argparse._HelpAction)}
    covered = set()
    parser = jconfig.build_arg_parser()
    for argv in ARGVS[1:]:
        ns = parser.parse_args(argv)
        base = parser.parse_args([])
        covered |= {k for k, v in vars(ns).items() if v != getattr(base, k)}
    assert covered == dests


# ROADMAP item 6's options (ported: each is accepted and selects its step,
# loader or model, but the JAX package's two scan executors, which are
# accepted and change nothing) and item 5's (still refused); the ids are
# the option names
UNPORTED = [
    (dict(multistep_k=2), "multistep_k", 6),
    (dict(scheduled_sampling=0.5), "scheduled_sampling", 6),
    (dict(chunk_steps=4), "chunk_steps", 6),
    (dict(device_data=True), "device_data", 6),
    (dict(epoch_scan=True, device_data=True), "epoch_scan", 6),
    (dict(remat=True), "remat", 6),
    (dict(put_thread=True), "put_thread", 5),
    (dict(mesh_shape=(2,)), "mesh_shape", 5),
]
ACCEPTED_AT = dict(dataset="synthetic", device="cpu", image_size=(32, 32),
                   filters_level=(4, 6, 8), synthetic_train_size=8,
                   synthetic_val_size=4, batch_size=4, edge=False,
                   workers=1)


def selected(trainer: Trainer, name: str) -> bool:
    """Whether the trainer runs what option ``name`` asks for."""
    from video_layout_generation_tpu_torch.data.device_synthetic import \
        DeviceSyntheticLoader
    step = trainer._train_step.__qualname__
    return {
        "multistep_k": step.startswith("make_multistep_train_step"),
        "scheduled_sampling": "Trainer.__init__" in step
        and trainer._ss_p == 0.5,
        "device_data": isinstance(trainer.train_loader,
                                  DeviceSyntheticLoader),
        "remat": trainer.model.remat,
        "put_thread": getattr(trainer.train_loader, "put_thread", False)
        and trainer.val_loader.put_thread,
    }[name]


@pytest.mark.parametrize("kw,name,item", UNPORTED,
                         ids=[u[1] for u in UNPORTED])
def test_unported_option_raises_from_trainer(kw, name, item, tmp_path):
    """Items 5 and 6 are ported: a ``mesh_shape`` of two devices in one
    process raises the JAX package's ``ValueError``, naming the launch of
    one process a device, before anything is built; the other options
    build a trainer that runs them, and the scan executors' build the
    trainer the other options alone build (the same step and loader, one
    step a batch)."""
    if name == "mesh_shape":
        cfg = tconfig.Config(dataset="synthetic", device="cpu",
                             path=str(tmp_path), **kw)
        with pytest.raises(ValueError, match=r"mesh shape \[2\] needs 2 "
                           r"devices, have 1.*torchrun --nproc_per_node 2"):
            Trainer(cfg)
        assert not (tmp_path / "checkpoint").exists()   # raised first
        return
    if name in ("chunk_steps", "epoch_scan"):
        rest = {k: v for k, v in kw.items() if k != name}
        plain = Trainer(tconfig.Config(path=None, **dict(ACCEPTED_AT, **rest)))
        trainer = Trainer(tconfig.Config(path=None,
                                         **dict(ACCEPTED_AT, **kw)))
        assert getattr(trainer.cfg, name) == kw[name]
        assert (trainer._train_step.__qualname__
                == plain._train_step.__qualname__)
        assert type(trainer.train_loader) is type(plain.train_loader)
        assert {k for k in vars(trainer)} == {k for k in vars(plain)}
        return
    plain = Trainer(tconfig.Config(path=None, **ACCEPTED_AT))
    assert not selected(plain, name)
    trainer = Trainer(tconfig.Config(path=None, **dict(ACCEPTED_AT, **kw)))
    assert selected(trainer, name)


def test_fast_executor_flags_are_accepted_without_effect():
    cfg = tconfig.config_from_args(["--no_fast_train", "--no_fast_rollout",
                                    "--mesh_shape", "1", "--chunk_steps",
                                    "2", "--epoch_scan"])
    assert not cfg.fast_train and not cfg.fast_rollout
    assert cfg.mesh_shape == (1,)
    assert cfg.chunk_steps == 2 and cfg.epoch_scan
    help_text = tconfig.build_arg_parser().format_help()
    assert "no effect in the port" in help_text
    assert "torchrun" in help_text and "ROADMAP item" not in help_text
