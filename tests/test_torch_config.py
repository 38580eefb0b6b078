"""The port's ``Config`` and CLI shim (``config.py``) against the JAX
package's: for the defaults and for every flag of the JAX package's
``build_arg_parser``, ``config_from_args(argv)`` gives the same value in
every field of the JAX ``Config``. The port adds one field, ``device``
(default ``"cuda"``). Each option of the JAX package that the port does not
run yet raises ``NotImplementedError`` from ``Trainer(cfg)``, naming its
ROADMAP item, before anything is built.
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


UNPORTED = [
    (dict(multistep_k=2), "multistep_k", 6),
    (dict(scheduled_sampling=0.5), "scheduled_sampling", 6),
    (dict(chunk_steps=4), "chunk_steps", 6),
    (dict(device_data=True), "device_data", 6),
    (dict(epoch_scan=True), "epoch_scan", 6),
    (dict(remat=True), "remat", 6),
    (dict(put_thread=True), "put_thread", 5),
    (dict(mesh_shape=(2,)), "mesh_shape", 5),
]


@pytest.mark.parametrize("kw,name,item", UNPORTED,
                         ids=[u[1] for u in UNPORTED])
def test_unported_option_raises_from_trainer(kw, name, item, tmp_path):
    cfg = tconfig.Config(dataset="synthetic", device="cpu",
                         path=str(tmp_path), **kw)
    with pytest.raises(NotImplementedError,
                       match=rf"{name}.*ROADMAP item {item}"):
        Trainer(cfg)
    assert not (tmp_path / "checkpoint").exists()   # raised before building


def test_fast_executor_flags_are_accepted_without_effect():
    cfg = tconfig.config_from_args(["--no_fast_train", "--no_fast_rollout",
                                    "--mesh_shape", "1"])
    assert not cfg.fast_train and not cfg.fast_rollout
    assert cfg.mesh_shape == (1,)
    help_text = tconfig.build_arg_parser().format_help()
    assert "no effect in the port" in help_text
    assert "ROADMAP item 6" in help_text and "ROADMAP item 5" in help_text
