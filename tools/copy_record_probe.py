"""How many copy records a torch.profiler trace returns for the train
loop's copies to the card, against the copies that were made.

    python3 tools/copy_record_probe.py [--traces 8]

Builds phase 11's fit loop of ``chip_smoke.py`` (the CLI's default
CoordGridNet, 64 synthetic samples, b16, 4 batches an epoch), warms it up
for one epoch, then traces ``--traces`` train epochs a leg with the
feeder thread off, on, on, off: first with CUDA activity alone, then with
CPU and CUDA activity. For each trace it prints the ``Memcpy`` device
records, the runtime's ``cudaMemcpyAsync`` calls, the launches of kernel
A, and how many batches the loader filled into its buffers and whether
every one of those buffers was pinned. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=8)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    import chip_smoke as cs
    from video_layout_generation_tpu_torch import main as cli
    from video_layout_generation_tpu_torch.config import config_from_args
    from video_layout_generation_tpu_torch.data import pipeline
    from video_layout_generation_tpu_torch.ops.kernels import _build
    if not torch.cuda.is_available():
        print("copy_record_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t0 = time.time()
    _build.build()
    print(f"build {time.time() - t0:.1f} s", flush=True)

    fills = []
    fill = pipeline._Slot.fill

    def checked_fill(slot, host_batch):
        fill(slot, host_batch)
        fills.append(all(b.is_pinned() for b in slot.pinned.values()))

    pipeline._Slot.fill = checked_fill
    root = tempfile.mkdtemp(prefix="vlg_copy_probe_")
    trainer = cli.build_trainer(config_from_args(cs.cli_argv(
        os.path.join(root, "exp"), "-e", "1", "--put_thread",
        "--seed", "1024")))
    trainer.set_epoch(0)
    trainer.train()
    for mode in ("cuda", "cpu+cuda"):
        acts = [ProfilerActivity.CUDA]
        if mode == "cpu+cuda":
            acts.append(ProfilerActivity.CPU)
        for flag in (False, True, True, False):
            trainer.train_loader.put_thread = flag
            for i in range(args.traces):
                fills.clear()
                torch.cuda.synchronize()
                with tprofile(activities=acts) as prof:
                    trainer.set_epoch(100 + i)
                    trainer.train()
                    torch.cuda.synchronize()
                rows = prof.key_averages()
                records = {ev.key: ev.count for ev in rows
                           if ev.key.startswith("Memcpy")}
                calls = {ev.key: ev.count for ev in rows
                         if ev.key.startswith("cudaMemcpy")}
                a = sum(ev.count for ev in rows
                        if "conv3x3_mma_kernel" in ev.key)
                print(f"{mode} put_thread {flag} {i} records {records} "
                      f"api {calls} A {a} fills {len(fills)} {all(fills)}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
