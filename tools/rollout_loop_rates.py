"""Train samples/s of the port's rollout-fidelity recipe under the loop
options, for comparing two checkouts on one card.

    python3 tools/rollout_loop_rates.py [--root DIR] [--label NAME]
        [--epochs 3] [--train 128] [--out FILE]
        [--device cpu --size 32 --batch 2]      # a rehearsal on the CPU

Builds the README's finetune recipe (GridNet warm-started from
``artifacts_store/flagship_096.npz``, ``--multistep_k 4
--multistep_feedback_noise 0.1 --lr 5e-5``, edges, 256x256, b16, bf16,
synthetic windows, the committed ``hned_synth``/``vgg_synth`` weights)
through the port's ``main.build_trainer`` once for each option set:
host-fed (none), ``--chunk_steps 2``, ``--device_data`` and
``--device_data --epoch_scan``. Each trains ``--epochs`` epochs of
``--train`` samples without validation; one JSON line a set gives every
epoch's samples/s and the mean over all but the first (which builds and
tunes). ``--root`` imports the package from another checkout, whose
kernels build in its own ``build/``; the weights come from this one.
Compare checkouts in one call, alternating: parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(HERE, "artifacts_store")
OPTION_SETS = {"host": [], "chunk_steps 2": ["--chunk_steps", "2"],
               "device_data": ["--device_data"],
               "device_data epoch_scan": ["--device_data", "--epoch_scan"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--train", type=int, default=128)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from video_layout_generation_tpu_torch import main as cli
    from video_layout_generation_tpu_torch.config import config_from_args

    cuda = args.device != "cpu"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip() if cuda else "cpu"
    root = tempfile.mkdtemp(prefix="vlg_loop_rates_")
    lines = []
    for name, extra in OPTION_SETS.items():
        argv_ = ["--dataset", "synthetic", "--synthetic_train_size",
                 str(args.train), "--synthetic_val_size", "16", "-bs",
                 str(args.batch), "--image_size", str(args.size),
                 str(args.size), "--device", args.device,
                 "--hed_weights", os.path.join(STORE, "hned_synth.npz"),
                 "--vgg_weights", os.path.join(STORE, "vgg_synth.npz"),
                 "--arch", "GridNet", "--ckpt",
                 os.path.join(STORE, "flagship_096.npz"), "--multistep_k",
                 "4", "--multistep_feedback_noise", "0.1", "--lr", "5e-5",
                 "-p", os.path.join(root, name.replace(" ", "_")), *extra]
        trainer = cli.build_trainer(config_from_args(argv_))
        rates = []
        for epoch in range(args.epochs):
            if cuda:
                torch.cuda.synchronize()
            trainer.set_epoch(epoch)
            trainer.train()
            if cuda:
                torch.cuda.synchronize()
            st = trainer.epoch_stats
            rates.append(st["samples"] / st["wall_s"])
        steady = rates[1:] or rates
        line = dict(label=args.label, root=args.root, options=name,
                    samples_per_s=rates,
                    mean_after_first=sum(steady) / len(steady),
                    package=os.path.dirname(cli.__file__),
                    steps=len(trainer.train_loader), card=card,
                    at=time.strftime("%Y-%m-%dT%H:%M:%S"))
        print(json.dumps(line), flush=True)
        lines.append(line)
        del trainer
        if cuda:
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
