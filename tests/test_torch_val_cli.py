"""The port's legacy eval CLI (``video_layout_generation_tpu_torch/val.py``)
against the JAX package's ``val.py`` at 32x32, 4 samples, batch 2.

The port reads, as ``--ckpt``, a flat npz of the variables that the JAX CLI
initializes (``model.init(jax.random.key(0), first batch)``, params and
batch_stats), so both run the same weights: the printed mIoU and pixel
accuracy must be equal to 4 decimals, the PNGs equal on at least 99.9% of
pixels (the argmax of random-init logits can tie), ``--data_parallel`` over
two CPU devices equal to the run without it, and a u_net npz without
``batch_stats`` refused by name."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from video_layout_generation_tpu import val as jval
from video_layout_generation_tpu.models.legacy import Simple as JSimple
from video_layout_generation_tpu_torch import val
from video_layout_generation_tpu_torch.parallel.mesh import make_mesh

ARGS = ["--bs", "2", "--size", "32", "--n_samples", "4"]
PNG_AGREEMENT = 0.999


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def jax_cli_variables(model_name: str) -> dict:
    """The variables ``val.py`` initializes, as a flat ``"/"`` mapping."""
    imgs, segs, masks = jval._synthetic_arrays(4, (32, 32), 29)
    model = JSimple(29, 15, model_name)
    return flat(jax.jit(model.init)(jax.random.key(0), masks[:2], segs[:2],
                                    imgs[:2]))


def pngs(folder) -> np.ndarray:
    return np.stack([np.asarray(Image.open(os.path.join(folder, f"{i}.png"))
                             .convert("RGB")) for i in range(4)])


def last_line(capsys) -> str:
    return capsys.readouterr().out.strip().splitlines()[-1]


@pytest.mark.parametrize("model_name", ["u_net", "encoder_decoder"])
def test_val_cli_matches_jax(tmp_path, capsys, monkeypatch, model_name):
    npz = tmp_path / "vars.npz"
    np.savez(npz, **jax_cli_variables(model_name))
    capsys.readouterr()
    jval.main(["--model", model_name, *ARGS, "--save_dir",
               str(tmp_path / "jax")])
    want = last_line(capsys)
    out = val.main(["--model", model_name, *ARGS, "--ckpt", str(npz),
                    "--device", "cpu", "--save_dir", str(tmp_path / "port"),
                    "--nw", "2"])
    got = last_line(capsys)
    assert got == want and got.startswith("mIoU: ")
    assert got == f"mIoU: {out['miou']:.4f}  pixel-acc: {out['pixel_acc']:.4f}"
    assert len(out["eval_s"]) == len(out["save_s"]) == 2
    sub = f"{model_name}_eval_32x32"
    a, b = pngs(tmp_path / "jax" / sub), pngs(tmp_path / "port" / sub)
    assert a.shape == b.shape == (4, 32, 32, 3)
    assert (a == b).all(-1).mean() >= PNG_AGREEMENT

    # --data_parallel: each batch split over a mesh of two CPU devices
    monkeypatch.setattr(val, "make_mesh",
                        lambda *a, **k: make_mesh(["cpu"] * 2))
    dp = val.main(["--model", model_name, *ARGS, "--ckpt", str(npz),
                   "--device", "cpu", "--data_parallel", "--save_dir",
                   str(tmp_path / "dp")])
    assert last_line(capsys) == got
    assert dp["ids_sha256"] == out["ids_sha256"]
    with pytest.raises(SystemExit, match="divisible by the device count 2"):
        val.main(["--model", model_name, "--bs", "1", "--size", "32",
                  "--n_samples", "4", "--device", "cpu", "--data_parallel",
                  "--save_dir", str(tmp_path / "dp1")])


def test_unet_checkpoint_without_batch_stats_is_refused(tmp_path):
    variables = jax_cli_variables("u_net")
    npz = tmp_path / "params_only.npz"
    np.savez(npz, **{k: v for k, v in variables.items()
                     if k.startswith("params/")})
    with pytest.raises(ValueError, match="batch_stats"):
        val.main(["--model", "u_net", *ARGS, "--ckpt", str(npz),
                  "--device", "cpu", "--save_dir", str(tmp_path)])


def test_port_checkpoint_and_load_dir(tmp_path, capsys):
    """A checkpoint of the port's own format, named relative to
    ``--load_dir``, gives the same ids as the npz it was made from; without
    a card the default ``--device cuda`` raises instead of running on the
    CPU."""
    from video_layout_generation_tpu_torch.io.checkpoint import (
        CheckpointManager)
    from video_layout_generation_tpu_torch.io.weights import params_from_flax
    variables = jax_cli_variables("u_net")
    npz = tmp_path / "vars.npz"
    np.savez(npz, **variables)
    CheckpointManager(str(tmp_path / "models")).save(
        0, params_from_flax(variables), {}, 0, "simple29_unet")
    a = val.main(["--model", "u_net", *ARGS, "--ckpt", str(npz), "--device",
                  "cpu", "--save_dir", str(tmp_path / "a")])
    b = val.main(["--model", "u_net", *ARGS, "--ckpt", "000", "--load_dir",
                  str(tmp_path / "models"), "--device", "cpu",
                  "--save_dir", str(tmp_path / "b")])
    assert a["ids_sha256"] == b["ids_sha256"] and a["miou"] == b["miou"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            val.main(["--model", "u_net", *ARGS, "--save_dir",
                      str(tmp_path / "c")])
