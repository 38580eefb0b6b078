"""Typed configuration of the port (the JAX package's ``config.py``).

A frozen dataclass with the JAX package's fields, defaults and flag names,
plus one field of the port's own: ``device`` (``--device``, default
``"cuda"``), where the entry points run. ``"cpu"`` runs every kernel's
plain PyTorch version, as everywhere in the port.

Fields that name the JAX package's TPU executors are kept so that an
invocation carries over; ``train/trainer.py:check_supported`` decides in one
place what each does here:

- ``fast_train`` and ``fast_rollout`` choose the JAX package's packed
  (space-to-depth) executors, which the port does not have: it runs the
  NHWC model, whose kernels serve every path. Accepted, no effect.
- ``chunk_steps`` and ``epoch_scan`` choose the JAX package's executors
  that fuse K steps, or an epoch, into one compiled scan so that the host
  syncs once a chunk or an epoch. An eager step here already queues its
  work without a sync, and the train loop fetches a loss only on logged
  steps, so the port runs every configuration step by step. Accepted, no
  effect; the JAX package's ``ValueError`` for the combinations it refuses
  stays (``train/trainer.py:check_options``), so an invocation is valid in
  both packages or in neither.
- ``put_thread`` moves the loader's host side to a feeder thread
  (``data/pipeline.py:DeviceLoader``): the same batches in the same order.
- ``mesh_shape`` is the data-parallel mesh: one process a card, launched
  by ``torchrun --nproc_per_node N`` (the JAX package drives N devices
  from one program), so its product must equal the number of processes;
  ``parallel/mesh.py:training_mesh`` raises the JAX package's
  ``ValueError`` otherwise, naming the launch.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class Config:
    # -- dataset -----------------------------------------------------------
    dataset: str = "cityscape"          # 'cityscape' | 'synthetic'
    train_dir: str = "/data/train"
    val_dir: str = "/data/val"
    test_dir: str = "/data/test"
    image_size: Tuple[int, int] = (256, 256)
    n_classes: int = 20
    synthetic_train_size: int = 64      # samples when dataset == 'synthetic'
    synthetic_val_size: int = 16

    # -- mode --------------------------------------------------------------
    validate: bool = False              # run validation only
    edge: bool = True                   # include HNED edge channels in input
    val_interval: int = 1

    # -- model -------------------------------------------------------------
    arch: str = "CoordGridNet"          # 'GridNet' | 'CoordGridNet' | 'ResnetGenerator'
    generator: str = "ResnetGenerator"
    discriminator: str = "NLayerDiscriminator"
    input_nc: int = 8                   # channels w/o edges; +2 when edge=True
    output_nc: int = 3
    ngf: int = 64
    ndf: int = 64
    netD: str = "basic"                 # 'basic' | 'n_layers' | 'pixel'
    netG: str = "resnet_9blocks"
    n_layers_D: int = 3
    norm: str = "instance"              # 'instance' | 'batch' | 'none'
    filters_level: Tuple[int, int, int] = (32, 64, 96)  # GridNet row widths
    init_type: str = "normal"           # 'normal' | 'xavier' | 'kaiming' | 'orthogonal'
    init_gain: float = 0.02
    no_dropout: bool = False
    gan_mode: str = "lsgan"             # 'lsgan' | 'vanilla' | 'wgangp'
    gan_train: bool = False             # adversarial G/D alternating updates

    # -- optimization ------------------------------------------------------
    batch_size: int = 32
    epochs: int = 10
    optimizer: str = "adam"             # 'adam' | 'adamax' | 'sgd'
    lr: float = 2e-4
    beta1: float = 0.5
    adam_mu_dtype: str = "float32"      # 'bfloat16': Adam's first moment
                                        # kept in bf16 (train/state.py)
    lr_decay_step: int = 5              # epochs between decays (sgd)
    lr_decay_gamma: float = 0.1
    start_epoch: int = 1
    # pix2pix-style schedulers; None keeps sgd's staircase decay only
    lr_policy: Optional[str] = None     # 'linear' | 'step' | 'plateau' | 'cosine'
    niter: int = 100                    # linear: constant epochs; cosine: T_max
    niter_decay: int = 100              # linear: decay-to-zero epochs
    lr_decay_iters: int = 50            # step: epochs per 0.1x decay
    epoch_count: int = 1                # linear: starting epoch offset

    # -- loss weights -------------------------------------------------------
    w_l1: float = 40.0
    w_style: float = 20.0
    w_seg: float = 10.0

    # -- rollout-fidelity training (train/multistep.py, train/scheduled.py) --
    multistep_k: int = 1                # > 1: K-step backprop through the
                                        # rollout on K+2-frame windows
    multistep_remat: bool = True        # recompute each step in backward
    multistep_discount: float = 1.0
    multistep_feedback_noise: float = 0.0
    multistep_layout_noise: float = 0.0
    multistep_image_weight: float = 1.0
    multistep_image_discount: float = 1.0
    scheduled_sampling: float = 0.0     # p of feeding back the model's own
                                        # prediction (4-frame windows)
    scheduled_ramp: int = 0             # epochs to ramp p up (0: constant)

    # -- precision / performance -------------------------------------------
    compute_dtype: str = "bfloat16"     # activation dtype inside the nets
    loss_dtype: str = "float32"         # losses always reduced in f32
    remat: bool = False                 # recompute GridNet's grid columns
    fast_rollout: bool = True           # the JAX package's packed executors:
    fast_train: bool = True             # accepted, no effect in the port
    transfer_uint8: bool = True         # batches leave the host as uint8
                                        # (decoded on the device)
    device_data: bool = False           # synthetic: render batches on the
                                        # card (data/device_synthetic.py)
    epoch_scan: bool = False            # the JAX package's scan executors:
    chunk_steps: int = 0                # accepted, no effect in the port
    put_thread: bool = False            # feeder thread (data/pipeline.py)

    # -- runtime ------------------------------------------------------------
    workers: int = 4
    seed: int = 1024
    print_freq: int = 10
    disp_interval: int = 10
    path: Optional[str] = None          # experiment dir
    ckpt: Optional[str] = None          # warm-start weights
    resume: Optional[str] = None        # full resume (epoch+model+opt)
    port: Optional[int] = None          # kept for CLI compatibility; unused

    # -- rollout ------------------------------------------------------------
    img1: Optional[str] = None
    img2: Optional[str] = None
    seg1: Optional[str] = None
    seg2: Optional[str] = None
    rollout_frames: int = 8
    rollout_edge_scale: int = 1         # HNED on a 1/k downsample (opt-in)
    rollout_upsample: str = "bilinear"  # or "nearest" (opt-in)
    rollout_fidelity_every: int = 0     # every N epochs: per-step rollout
    rollout_fidelity_scenes: int = 8    # mIoU on held-out synthetic scenes

    # -- pretrained weight artifacts ----------------------------------------
    hed_weights: Optional[str] = None   # converted HNED weights (.npz)
    vgg_weights: Optional[str] = None   # converted VGG19 weights (.npz)

    # -- parallelism ---------------------------------------------------------
    mesh_shape: Optional[Sequence[int]] = None  # one card a process; None:
                                                # every process of the run

    # -- the port's own -------------------------------------------------------
    device: str = "cuda"                # 'cuda' | 'cpu' (the plain versions)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def model_in_channels(self) -> int:
        """Channels fed to the predictor: e1(1)+s1(1)+f1(3)+f2(3)+s2(1)+e2(1)
        or 8 without edges."""
        return 10 if self.edge else 8


def default_exp_path() -> str:
    return "../log/exp-{0}".format(
        datetime.datetime.now().strftime("%m-%d-%H:%M:%S"))


_NO_EFFECT = "accepted for compatibility; no effect in the port"


def build_arg_parser() -> argparse.ArgumentParser:
    """Argparse shim with the JAX package's flag names, plus ``--device``."""
    p = argparse.ArgumentParser(
        description="Train a video layout generation network "
                    "(PyTorch/CUDA port)")
    p.add_argument("-d", "--dataset", type=str, default="cityscape",
                   choices=["cityscape", "synthetic"])
    p.add_argument("--train_dir", type=str, default="/data/train")
    p.add_argument("--val_dir", type=str, default="/data/val")
    p.add_argument("--test_dir", type=str, default="/data/test")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--edge", action="store_true", default=True)
    p.add_argument("--no_edge", dest="edge", action="store_false")
    p.add_argument("--val_interval", type=int, default=1)
    p.add_argument("-a", "--arch", type=str, default="CoordGridNet",
                   choices=["GridNet", "CoordGridNet", "ResnetGenerator"])
    p.add_argument("--discriminator", type=str, default="NLayerDiscriminator")
    p.add_argument("--generator", type=str, default="ResnetGenerator")
    p.add_argument("-bs", "--batch_size", type=int, default=32)
    p.add_argument("-e", "--epochs", type=int, default=10)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--img1", type=str, default=None)
    p.add_argument("--img2", type=str, default=None)
    p.add_argument("--seg1", type=str, default=None)
    p.add_argument("--seg2", type=str, default=None)
    p.add_argument("-j", "--workers", type=int, default=4)
    p.add_argument("--port", type=int, default=None, help=_NO_EFFECT)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("-p", "--path", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--start_epoch", type=int, default=1)
    p.add_argument("--disp_interval", type=int, default=10)
    p.add_argument("--o", dest="optimizer", default="adam",
                   choices=["adamax", "adam", "sgd"])
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--adam_mu_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of Adam's first moment")
    p.add_argument("--lr_decay_step", type=int, default=5)
    p.add_argument("--lr_decay_gamma", type=float, default=0.1)
    p.add_argument("--lr_policy", type=str, default=None,
                   choices=["linear", "step", "plateau", "cosine"])
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--niter_decay", type=int, default=100)
    p.add_argument("--lr_decay_iters", type=int, default=50)
    p.add_argument("--epoch_count", type=int, default=1)
    p.add_argument("--input_nc", type=int, default=8)
    p.add_argument("--output_nc", type=int, default=3)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--netD", type=str, default="basic")
    p.add_argument("--netG", type=str, default="resnet_9blocks")
    p.add_argument("--n_layers_D", type=int, default=3)
    p.add_argument("--norm", type=str, default="instance")
    p.add_argument("--init_type", type=str, default="normal")
    p.add_argument("--init_gain", type=float, default=0.02)
    p.add_argument("--no_dropout", action="store_true")
    p.add_argument("--gan_mode", type=str, default="lsgan")
    p.add_argument("--gan_train", action="store_true")
    p.add_argument("--hed_weights", type=str, default=None)
    p.add_argument("--vgg_weights", type=str, default=None)
    p.add_argument("--rollout_frames", type=int, default=8)
    p.add_argument("--rollout_edge_scale", type=int, default=1)
    p.add_argument("--rollout_upsample", type=str, default="bilinear",
                   choices=("bilinear", "nearest"))
    p.add_argument("--rollout_fidelity_every", type=int, default=0)
    p.add_argument("--rollout_fidelity_scenes", type=int, default=8)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--loss_dtype", type=str, default="float32")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--image_size", type=int, nargs=2, default=(256, 256),
                   metavar=("H", "W"))
    p.add_argument("--n_classes", type=int, default=20)
    p.add_argument("--synthetic_train_size", type=int, default=64)
    p.add_argument("--synthetic_val_size", type=int, default=16)
    p.add_argument("--filters_level", type=int, nargs=3, default=(32, 64, 96),
                   metavar=("R0", "R1", "R2"))
    p.add_argument("--w_l1", type=float, default=40.0)
    p.add_argument("--w_style", type=float, default=20.0)
    p.add_argument("--w_seg", type=float, default=10.0)
    p.add_argument("--fast_train", dest="fast_train", action="store_true",
                   default=True, help=_NO_EFFECT)
    p.add_argument("--no_fast_train", dest="fast_train",
                   action="store_false", help=_NO_EFFECT)
    p.add_argument("--fast_rollout", dest="fast_rollout",
                   action="store_true", default=True, help=_NO_EFFECT)
    p.add_argument("--no_fast_rollout", dest="fast_rollout",
                   action="store_false", help=_NO_EFFECT)
    p.add_argument("--mesh_shape", type=int, nargs="+", default=None,
                   help="the data-parallel mesh: its product is the number "
                        "of processes (torchrun --nproc_per_node N, one "
                        "card each)")
    p.add_argument("--transfer_uint8", dest="transfer_uint8",
                   action="store_true", default=True)
    p.add_argument("--no_transfer_uint8", dest="transfer_uint8",
                   action="store_false")
    p.add_argument("--multistep_k", type=int, default=1)
    p.add_argument("--multistep_discount", type=float, default=1.0)
    p.add_argument("--multistep_feedback_noise", type=float, default=0.0)
    p.add_argument("--multistep_layout_noise", type=float, default=0.0)
    p.add_argument("--multistep_image_weight", type=float, default=1.0)
    p.add_argument("--multistep_image_discount", type=float, default=1.0)
    p.add_argument("--scheduled_sampling", type=float, default=0.0)
    p.add_argument("--scheduled_ramp", type=int, default=0)
    p.add_argument("--device_data", action="store_true", default=False)
    p.add_argument("--epoch_scan", action="store_true", default=False,
                   help=_NO_EFFECT)
    p.add_argument("--chunk_steps", type=int, default=0, help=_NO_EFFECT)
    p.add_argument("--put_thread", dest="put_thread",
                   action="store_true", default=False,
                   help="pin and copy batches on a feeder thread")
    p.add_argument("--multistep_remat", dest="multistep_remat",
                   action="store_true", default=True)
    p.add_argument("--no_multistep_remat", dest="multistep_remat",
                   action="store_false")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the port runs: 'cuda' (the kernels) or "
                        "'cpu' (their plain versions)")
    return p


def config_from_args(argv=None) -> Config:
    args = build_arg_parser().parse_args(argv)
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in names}
    for k in ("image_size", "filters_level", "mesh_shape"):
        if kw.get(k) is not None:
            kw[k] = tuple(kw[k])
    return Config(**kw)
