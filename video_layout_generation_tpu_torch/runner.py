"""Experiment snapshot runner (the JAX package's ``runner.py``): copy the
current source tree into ``../playground/<run_name>/`` so that results stay
tied to the exact code that produced them, then run the given command there
with ``run_name`` exported, and return its exit code. Interrupt-guarded
wait.

Usage:
  python -m video_layout_generation_tpu_torch.runner -rn exp1 \
      -c "python -m video_layout_generation_tpu_torch.main --dataset synthetic"
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import subprocess
import sys


def snapshot_and_run(run_name: str, command: str, force: bool = False,
                     src_dir: pathlib.Path | None = None) -> int:
    src_dir = src_dir or pathlib.Path.cwd()
    run_dir = src_dir.parent / "playground" / run_name

    if run_dir.is_dir():
        while not force:
            ans = input(f"run name {run_name} exists, overwrite or not "
                        "[Y/n] ").strip()
            if ans == "Y":
                break
            if ans in ("N", "n"):
                return 1
        shutil.rmtree(run_dir)

    run_dir.mkdir(parents=True, exist_ok=False)
    dst = run_dir / src_dir.name
    shutil.copytree(src_dir, dst,
                    ignore=shutil.ignore_patterns(
                        "__pycache__", ".jax_cache", ".git",
                        ".pytest_cache", "playground"))

    env = dict(os.environ, run_name=run_name)
    proc = subprocess.Popen(command, shell=True, cwd=dst, env=env)
    while True:
        try:
            return proc.wait()
        except KeyboardInterrupt:
            print("\tPlease double press Ctrl-C within 1 second", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--run_name", "-rn", default="default")
    p.add_argument("--force", "-f", action="store_true")
    p.add_argument("--command", "-c", required=True)
    args = p.parse_args(argv)
    sys.exit(snapshot_and_run(args.run_name, args.command, args.force))


if __name__ == "__main__":
    main()
