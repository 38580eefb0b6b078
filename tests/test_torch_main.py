"""The port's CLI (``main.py``) in its three modes and its snapshot runner
(``runner.py``), on the CPU with ``--device cpu`` at a tiny size: the
training loop writes ``experiment.log``, ``checkpoint/001`` and the
``predict/`` stack; ``--validate`` returns the metrics; the rollout from
four PNG paths saves an npy stack of the two seeds and ``rollout_frames``
generated frames.
"""

import pathlib

import numpy as np
import pytest
from PIL import Image

from video_layout_generation_tpu_torch import main as tmain
from video_layout_generation_tpu_torch.runner import main as runner_main
from video_layout_generation_tpu_torch.runner import snapshot_and_run

ROOT = pathlib.Path(__file__).resolve().parents[1] / "artifacts_store"
TINY = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "32",
        "32", "--filters_level", "4", "6", "8", "--compute_dtype", "float32",
        "-bs", "4", "--synthetic_train_size", "8", "--synthetic_val_size",
        "4", "--rollout_frames", "2", "-j", "2", "--no_edge",
        "--vgg_weights", str(ROOT / "vgg_synth.npz")]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    path = tmp_path_factory.mktemp("exp")
    metrics = tmain.main(TINY + ["-e", "1", "-p", str(path)])
    return path, metrics


def test_fit_writes_log_checkpoint_and_predict_stack(fitted):
    path, metrics = fitted
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["miou"] <= 1
    log = (path / "experiment.log").read_text()
    for line in ("Start of experiment", "Device: cpu", "device: cpu",
                 "Epoch [1/1][1/2]", "samples/s", "mIoU", "Saving checkpoint"):
        assert line in log, line
    assert (path / "checkpoint" / "001" / "checkpoint.pt").is_file()
    assert (path / "checkpoint" / "latest").exists()
    stacks = sorted((path / "predict").glob("val_*_stack.npy"))
    assert len(stacks) == 1
    stack = np.load(stacks[0])
    assert stack.shape == (4, 32, 32, 16) and np.isfinite(stack).all()


def test_validate_returns_metrics(fitted, tmp_path):
    path, _ = fitted
    out = tmain.main(TINY + ["--validate", "-p", str(tmp_path), "--ckpt",
                             str(path / "checkpoint" / "latest")])
    assert set(out) == {"loss", "miou", "pixel_acc", "per_class_iou"}
    assert np.isfinite(out["loss"]) and out["per_class_iou"].shape == (20,)
    assert not (tmp_path / "checkpoint" / "001").exists()   # no training


def _write_pngs(d: pathlib.Path):
    rng = np.random.default_rng(0)
    paths = {}
    for name in ("img1", "img2"):
        paths[name] = d / f"{name}.png"
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(paths[name])
    for name in ("seg1", "seg2"):
        paths[name] = d / f"{name}.png"
        Image.fromarray(rng.integers(0, 20, (40, 48), dtype=np.uint8)
                        ).save(paths[name])
    return paths


def test_png_rollout_saves_the_sequence(fitted, tmp_path):
    path, _ = fitted
    pngs = _write_pngs(tmp_path)
    exp = tmp_path / "exp"
    argv = TINY + ["-p", str(exp), "--ckpt", str(path / "checkpoint" / "001")]
    for k, p in pngs.items():
        argv += [f"--{k}", str(p)]
    imgs, segs = tmain.main(argv)
    assert tuple(imgs.shape) == (1, 2, 32, 32, 3)
    assert tuple(segs.shape) == (1, 2, 32, 32, 1)
    img = np.load(next((exp / "predict").glob("val_*_img.npy")))
    seg = np.load(next((exp / "predict").glob("val_*_seg.npy")))
    assert img.shape == (1, 2 + 2, 32, 32, 3) and seg.shape == (1, 4, 32, 32, 1)
    assert np.isfinite(img).all()
    assert set(np.unique(seg[:, 2:])) <= set(range(20))
    # a missing path logs and returns nothing, as the JAX package does
    argv[argv.index("--img1") + 1] = str(tmp_path / "missing.png")
    assert tmain.main(argv) is None


def test_help_names_the_device_and_the_unported_flags(capsys):
    with pytest.raises(SystemExit) as e:
        tmain.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out and "no effect in the port" in out


def _tree(tmp_path):
    src = tmp_path / "proj"
    (src / "sub").mkdir(parents=True)
    (src / "code.py").write_text("x = 1\n")
    (src / "sub" / "data.txt").write_text("d\n")
    (src / "__pycache__").mkdir()
    (src / "__pycache__" / "junk.pyc").write_text("j")
    (src / "playground").mkdir()
    return src


def test_runner_runs_the_command_in_a_snapshot(tmp_path, monkeypatch):
    src = _tree(tmp_path)
    assert snapshot_and_run("exp1", "echo $run_name > ran.txt",
                            src_dir=src) == 0
    dst = tmp_path / "playground" / "exp1" / "proj"
    assert (dst / "code.py").read_text() == "x = 1\n"
    assert (dst / "sub" / "data.txt").exists()
    assert not (dst / "__pycache__").exists()
    assert not (dst / "playground").exists()
    assert (dst / "ran.txt").read_text().strip() == "exp1"
    assert snapshot_and_run("exp2", "exit 7", src_dir=src) == 7
    assert snapshot_and_run("exp1", "touch again.txt", force=True,
                            src_dir=src) == 0
    assert (dst / "again.txt").exists() and not (dst / "ran.txt").exists()
    monkeypatch.chdir(src)
    with pytest.raises(SystemExit) as e:
        runner_main(["-rn", "exp3", "-f", "-c", "exit 3"])
    assert e.value.code == 3


def test_meters_match_jax():
    from video_layout_generation_tpu.utils import meters as jmeters
    from video_layout_generation_tpu_torch.utils import meters as tmeters
    j, t = jmeters.AverageMeter(), tmeters.AverageMeter()
    for val, n in ((3.0, 1), (5.0, 3), (-1.5, 2)):
        j.update(val, n)
        t.update(val, n)
        assert (t.val, t.sum, t.count, t.avg) == (j.val, j.sum, j.count,
                                                  j.avg)
    timer = tmeters.StepTimer()
    timer.mark_loaded()
    timer.mark_computed()
    assert timer.load_time >= 0 and timer.comp_time >= 0
