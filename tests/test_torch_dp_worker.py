"""Helpers of the port's data-parallel tests (it holds no test itself):
``run_ranks`` starts a Gloo group of CPU processes with
``torch.multiprocessing.spawn`` and the ``torchrun`` variables, and the
scenarios below run the same code inside the group, each rank on its rows
of the global batch (``rows = rank_rows``), and in the test's own process
on the whole global batch (``rows = whole``): the one-process reference on
the concatenated rank batches. Only torch and the port are imported here,
so that a rank starts in about a second.
"""

import contextlib
import os
import socket
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
VGG_NPZ = str(ROOT / "artifacts_store" / "vgg_synth.npz")
HW = (16, 16)
FILTERS = (4, 6, 8)
N_CLASSES = 20
GLOBAL_BATCH = 4


@contextlib.contextmanager
def torch_threads(n: int):
    """``n`` torch threads inside the block, the caller's after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, out_dir, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    torch.set_num_threads(1)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from video_layout_generation_tpu_torch.parallel import (
        maybe_initialize_distributed)
    assert maybe_initialize_distributed("cpu")
    try:
        torch.save(fn(*args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, out_dir, world: int = 2, args=(), meanwhile=None):
    """``fn(*args)`` on each of ``world`` ranks of a Gloo group; returns
    each rank's result, in rank order, and what ``meanwhile()`` returned,
    which runs in this process while the ranks do (the reference)."""
    ctx = mp.spawn(_entry, args=(world, free_port(), fn, str(out_dir), args),
                   nprocs=world, join=False)
    here = meanwhile() if meanwhile is not None else None
    while not ctx.join():
        pass
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(world)]
    return ranks, here


def rank_rows(x):
    """This rank's rows of a global batch (array or tensor)."""
    from video_layout_generation_tpu_torch.parallel.mesh import (
        local_rows, process_count, process_index)
    return local_rows(x, process_index(), process_count())


def whole(x):
    return x


# ---- data ------------------------------------------------------------------

def packed_batch(n: int, seed: int, frames: int = 3) -> np.ndarray:
    """uint8 (N, H, W, 12) triplets (``frames=3``), or (N, T, H, W, 4)
    windows: smooth frames and blocky layouts."""
    rng = np.random.default_rng(seed)
    cells = (n, frames, HW[0] // 4, HW[1] // 4)

    def up(a):
        return a.repeat(4, axis=2).repeat(4, axis=3)

    f = up(rng.random(cells + (3,)))
    f = np.clip(f + 0.05 * up(rng.standard_normal(cells + (3,))), 0, 1)
    s = up(rng.integers(0, N_CLASSES, cells))[..., None]
    win = np.concatenate([(f * 255 + 0.5).astype(np.uint8),
                          s.astype(np.uint8)], axis=-1)
    if frames != 3:
        return win
    return np.concatenate([win[:, i, ..., :3] for i in range(3)]
                          + [win[:, i, ..., 3:] for i in range(3)], axis=-1)


def seg_batch(n: int, seed: int, frames: int = 1) -> torch.Tensor:
    """(N, H, W) (or (N, T, H, W)) int64 blocky layouts."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N_CLASSES, (n, frames, HW[0] // 4, HW[1] // 4))
    ids = torch.from_numpy(ids.repeat(4, axis=2).repeat(4, axis=3))
    return ids[:, 0] if frames == 1 else ids


# ---- what a scenario reports ------------------------------------------------

def recording(state):
    """Keep, in ``state.applied``, the gradients each update applies."""
    state.applied = []
    apply = state.apply_gradients

    def keep(grads):
        state.applied.append({k: g.detach().clone() for k, g in grads.items()})
        return apply(grads)

    state.apply_gradients = keep
    return state


def report(states, metrics_by_step) -> dict:
    return dict(
        metrics=[{k: v.detach().clone() for k, v in m.items()
                  if isinstance(v, torch.Tensor)} for m in metrics_by_step],
        params={f"{i}/{k}": v.detach().clone()
                for i, st in enumerate(states) for k, v in st.params.items()},
        grads=[{k: g for k, g in applied.items()}
               for st in states for applied in st.applied])


def _gridnet(seed: int):
    from video_layout_generation_tpu_torch.models import GridNet
    torch.manual_seed(seed)
    return GridNet(n_channels=8, filters_level=FILTERS)


def _combined():
    from video_layout_generation_tpu_torch.losses import CombinedLoss
    return CombinedLoss.create(VGG_NPZ, None, device="cpu")


# ---- scenarios: each runs on the rows ``rows`` gives it ---------------------

def gridnet_steps(rows) -> dict:
    """Two GridNet train steps, a per-example flip coin: the metrics of
    both, the gradients and parameters of the first (the second starts
    from parameters that differ in the last bits, and a pre-activation or
    a max-pool tie that the difference moves across its edge moves a
    gradient by one pixel's share)."""
    from video_layout_generation_tpu_torch.train.state import (
        TrainState, make_optimizer)
    from video_layout_generation_tpu_torch.train.steps import make_train_step
    model = _gridnet(0)
    state = recording(TrainState.create(model, make_optimizer("sgd", 1e-2)))
    gen = torch.Generator()
    step = make_train_step(model, None, _combined(), flip_mode="per_example",
                           device="cpu", generator=gen)
    out = None
    for s in range(2):
        gen.manual_seed(100 + s)
        state, m = step(state, {"packed6": rows(packed_batch(
            GLOBAL_BATCH, s))})
        if out is None:
            out = report([state], [m])
        else:
            out["metrics"].append(m)
    return out


def gan_step(rows) -> dict:
    """One WGAN-GP step: GridNet generator, PatchGAN critic."""
    from video_layout_generation_tpu_torch.models import NLayerDiscriminator
    from video_layout_generation_tpu_torch.train.gan import (
        GanTrainState, make_gan_train_step)
    from video_layout_generation_tpu_torch.train.state import (
        TrainState, make_optimizer)
    gen_net = _gridnet(1)
    disc = NLayerDiscriminator(9, 4, n_layers=2,
                               generator=torch.Generator().manual_seed(2))
    state = GanTrainState(
        gen=recording(TrainState.create(gen_net, make_optimizer("sgd", 1e-2))),
        disc=recording(TrainState.create(disc, make_optimizer("sgd", 1e-2))))
    flip, gp = torch.Generator().manual_seed(3), torch.Generator()
    gp.manual_seed(4)
    step = make_gan_train_step(gen_net, disc, None, _combined(), "wgangp",
                               flip_mode="per_example", device="cpu",
                               generator=flip, gp_generator=gp)
    state, m = step(state, {"packed6": rows(packed_batch(GLOBAL_BATCH, 5))})
    return report([state.gen, state.disc], [m])


def multistep_step(rows) -> dict:
    """One K=2 step with feedback noise and layout corruption."""
    from video_layout_generation_tpu_torch.train.multistep import (
        make_multistep_train_step)
    from video_layout_generation_tpu_torch.train.state import (
        TrainState, make_optimizer)
    model = _gridnet(6)
    state = recording(TrainState.create(model, make_optimizer("sgd", 1e-2)))
    coin, noise = torch.Generator().manual_seed(7), torch.Generator()
    noise.manual_seed(8)
    step = make_multistep_train_step(
        model, None, _combined(), 2, feedback_noise=0.1, layout_noise=0.2,
        device="cpu", generator=coin, noise_generator=noise)
    state, m = step(state, {"packedseq": rows(packed_batch(
        GLOBAL_BATCH, 9, frames=4))})
    return report([state], [m])


# the per-dimension KL of the VAE scenario is about 1.96-2.03 at the start:
# the floor holds some dimensions and not others, and the capacity lies
# between the two ranks' own KL (32.23 and 32.09), above the global 32.16
VAE_FREE_BITS = 2.005
VAE_CAPACITY = 32.2


def vae_step(rows) -> dict:
    """One VAE step with class weights, free bits and capacity."""
    from video_layout_generation_tpu_torch.models.vae import LayoutVAE
    from video_layout_generation_tpu_torch.train.state import (
        TrainState, make_optimizer)
    from video_layout_generation_tpu_torch.train.vae_steps import (
        make_vae_train_step)
    model = LayoutVAE(N_CLASSES, 4, widths=(4, 8, 8),
                      generator=torch.Generator().manual_seed(10))
    state = recording(TrainState.create(model, make_optimizer("sgd", 1e-2)))
    gen = torch.Generator()
    gen.manual_seed(11)
    step = make_vae_train_step(model, N_CLASSES, free_bits=VAE_FREE_BITS,
                               use_capacity=True,
                               class_weights=[0.25] + [1.0] * 19,
                               device="cpu", generator=gen)
    # rank 1's rows are all background: a local class-weight sum differs
    ids = seg_batch(GLOBAL_BATCH, 12)
    ids[GLOBAL_BATCH // 2:] = 0
    state, m = step(state, rows(ids), 0.5, VAE_CAPACITY)
    return report([state], [m])


def cvae_step(rows) -> dict:
    """One CVAE step, its latent noise drawn from the step's generator."""
    from video_layout_generation_tpu_torch.models.vae import LayoutCVAE
    from video_layout_generation_tpu_torch.train.state import (
        TrainState, make_optimizer)
    from video_layout_generation_tpu_torch.train.vae_steps import (
        make_cvae_train_step)
    model = LayoutCVAE(N_CLASSES, 4, generator=torch.Generator().manual_seed(13))
    state = recording(TrainState.create(model, make_optimizer("sgd", 1e-2)))
    gen = torch.Generator()
    gen.manual_seed(14)
    step = make_cvae_train_step(model, N_CLASSES, device="cpu", generator=gen)
    win = seg_batch(GLOBAL_BATCH, 15, frames=3)
    state, m = step(state, rows(win[:, :2]), rows(win[:, 2]), 0.7)
    return report([state], [m])


def validation(rows) -> dict:
    """``validate`` over two global batches."""
    from video_layout_generation_tpu_torch.train.steps import make_eval_step
    from video_layout_generation_tpu_torch.train.trainer import validate
    step = make_eval_step(_gridnet(16), None, _combined(),
                          n_classes=N_CLASSES, device="cpu")
    batches = [{"packed6": rows(packed_batch(GLOBAL_BATCH, 17 + i))}
               for i in range(2)]
    out = validate(step, batches, N_CLASSES)
    return {"loss": out["loss"], "miou": out["miou"],
            "cm_iou": out["per_class_iou"]}


STEP_SCENARIOS = ("gridnet_steps", "gan_step", "multistep_step", "vae_step",
                  "cvae_step", "validation")


def all_step_scenarios(rows=rank_rows) -> dict:
    """Every scenario of ``STEP_SCENARIOS`` on ``rows`` (this rank's)."""
    return {name: globals()[name](rows) for name in STEP_SCENARIOS}


# ---- the trainers' fit epochs ------------------------------------------------

class ConcatRanks:
    """A loader yielding, for each batch index, the concatenation of every
    rank's batch: what the global batch of a run over ``len(loaders)``
    ranks holds."""

    def __init__(self, loaders):
        self.loaders = loaders

    def set_epoch(self, epoch: int):
        for ld in self.loaders:
            ld.set_epoch(epoch)

    def __len__(self):
        return len(self.loaders[0])

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def rank_loaders(cfg, dataset, shuffle: bool, world: int = 2):
    """What the ranks' loaders of ``cfg`` over ``world`` ranks yield, made
    in one process."""
    from video_layout_generation_tpu_torch.data.pipeline import (
        DeviceLoader, HostLoader)
    return ConcatRanks([DeviceLoader(HostLoader(
        dataset, cfg.batch_size // world, shuffle=shuffle, seed=cfg.seed,
        workers=1, process_index=r, process_count=world,
        transfer_uint8=cfg.transfer_uint8), "cpu") for r in range(world)])


def trainer_config(**kw):
    from video_layout_generation_tpu_torch.config import Config
    base = dict(dataset="synthetic", device="cpu", image_size=HW,
                filters_level=FILTERS, synthetic_train_size=GLOBAL_BATCH,
                synthetic_val_size=4, batch_size=GLOBAL_BATCH, edge=False,
                workers=1, epochs=1, optimizer="sgd", lr=1e-2,
                vgg_weights=VGG_NPZ, path=None, put_thread=True,
                print_freq=1, compute_dtype="float32")
    base.update(kw)
    return Config(**base)


def fit_trainer(concat: bool, path: str) -> dict:
    """One ``Trainer.fit`` epoch with ``--put_thread`` into the experiment
    directory ``path`` (every rank's the same, as on one host); ``concat``
    feeds a one-process trainer the concatenated rank batches. Returns the
    parameters, the validation, and the files the run left: the
    checkpoint's tags and the ``predict/`` dump of the validation batch."""
    from video_layout_generation_tpu_torch.parallel.mesh import is_primary
    from video_layout_generation_tpu_torch.train.trainer import Trainer
    t = Trainer(trainer_config(path=path))
    if concat:
        from video_layout_generation_tpu_torch.data import get_dataset
        train, val = get_dataset(t.cfg)
        t.train_loader = rank_loaders(t.cfg, train, True)
        t.val_loader = rank_loaders(t.cfg, val, False)
    val = t.fit()
    out = dict(params={k: v.detach().clone()
                       for k, v in t.model.state_dict().items()},
               val={k: val[k] for k in ("loss", "miou", "pixel_acc")},
               cm_iou=val["per_class_iou"], step=t.global_step)
    if is_primary():
        predict = Path(path) / "predict"
        out["tags"] = sorted(p.name for p in (Path(path) / "checkpoint")
                             .iterdir())
        out["dumps"] = [np.load(f) for f in sorted(predict.iterdir())]
    return out


def fit_layout_trainer(concat: bool) -> dict:
    """One ``LayoutTrainer.fit`` epoch of the VAE with its collapse
    remedies (class weight, free bits, capacity)."""
    from video_layout_generation_tpu_torch.train.layout_trainer import (
        LayoutTrainer)
    cfg = trainer_config(put_thread=False)
    t = LayoutTrainer(cfg, family="vae", latent_dim=4, vae_widths=(4, 8, 8),
                      free_bits=VAE_FREE_BITS, capacity_max=1.0,
                      capacity_steps=4, bg_weight=0.25, kl_warmup_steps=2)
    if concat:
        from video_layout_generation_tpu_torch.data import get_dataset
        train, val = get_dataset(cfg)
        t.train_loader = rank_loaders(cfg, train, True)
        t.val_loader = rank_loaders(cfg, val, False)
    val = t.fit()
    return dict(params={k: v.detach().clone()
                        for k, v in t.model.state_dict().items()},
                val={k: val[k] for k in ("miou", "pixel_acc")},
                cm_iou=val["per_class_iou"], step=t.global_step)


def both_fits(path: str, concat: bool = False) -> dict:
    return {"trainer": fit_trainer(concat, path),
            "layout_trainer": fit_layout_trainer(concat)}


# ---- the process group's primitives and the two traps -----------------------

def trap_inputs():
    """Inputs of the loss-level traps, global batch 4 (rank 1 holds rows
    2-3): logits and labels whose class weights differ between the ranks
    (rank 0's rows all background), and posterior statistics whose
    per-dimension KL lies above the free-bits floor on one rank and below
    it on the other, and whose KL puts the capacity between the ranks'."""
    g = torch.Generator().manual_seed(20)
    logits = torch.randn((GLOBAL_BATCH, 4, 4, N_CLASSES), generator=g)
    labels = torch.randint(1, N_CLASSES, (GLOBAL_BATCH, 4, 4), generator=g)
    labels[:GLOBAL_BATCH // 2] = 0
    mu = torch.randn((GLOBAL_BATCH, 2, 2, 3), generator=g) * 0.5
    mu[GLOBAL_BATCH // 2:] *= 3.0
    logvar = torch.randn((GLOBAL_BATCH, 2, 2, 3), generator=g) * 0.1
    return logits, labels, mu, logvar


TRAP_FREE_BITS = 0.5
TRAP_CAPACITY = 10.0
TRAP_CLASS_WEIGHTS = [0.25] + [1.0] * (N_CLASSES - 1)


def trap_losses(rows) -> dict:
    """``vae_loss`` with every remedy and ``class_weighted_ce`` on ``rows``
    of ``trap_inputs``: the values (shares in a group) and the gradients
    with respect to the rows' logits, mu and logvar."""
    from video_layout_generation_tpu_torch.losses.ce import class_weighted_ce
    from video_layout_generation_tpu_torch.losses.vae import vae_loss
    logits, labels, mu, logvar = (rows(t).clone() for t in trap_inputs())
    for t in (logits, mu, logvar):
        t.requires_grad_(True)
    total, metrics = vae_loss(logits, labels, mu, logvar, beta=0.5,
                              free_bits=TRAP_FREE_BITS,
                              capacity=TRAP_CAPACITY,
                              class_weights=TRAP_CLASS_WEIGHTS)
    grads = torch.autograd.grad(total, (logits, mu, logvar))
    ce = class_weighted_ce(logits.detach(), labels, TRAP_CLASS_WEIGHTS)
    return dict(total=total.detach(), ce=ce,
                metrics={k: v.detach() for k, v in metrics.items()},
                grads=[g.detach() for g in grads])


def trap_draws(rows) -> dict:
    """Every per-sample draw of the port for ``rows`` of the global batch
    (in a group: the rank's rows of the global batch's draw), each from its
    generator seeded alike, and a WGAN-GP penalty (a mean over the rows)
    whose mixing weights are such a draw."""
    from video_layout_generation_tpu_torch.losses.gan import gradient_penalty
    from video_layout_generation_tpu_torch.models.vae import reparameterize
    from video_layout_generation_tpu_torch.train.multistep import (
        draw_rollout_noise)
    from video_layout_generation_tpu_torch.train.scheduled import (
        draw_sampling_mask)
    from video_layout_generation_tpu_torch.train.steps import flip_coin
    from video_layout_generation_tpu_torch.train.vae_steps import (
        draw_cvae_noise)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    real = rows(torch.linspace(0, 1, GLOBAL_BATCH * 8).reshape(
        GLOBAL_BATCH, 2, 2, 2))
    n = real.shape[0]
    pen, _ = gradient_penalty(lambda x: (x ** 3).sum(), real, 1.0 - real,
                              gen(21))
    return dict(
        flip=flip_coin("per_example", n, gen(22), "cpu"),
        mask=draw_sampling_mask(n, 0.5, gen(24), "cpu"),
        rollout=draw_rollout_noise(3, n, (4, 4), N_CLASSES, 0.1, 0.3,
                                   gen(24), "cpu"),
        cvae=draw_cvae_noise(2, n, (8, 8), 3, N_CLASSES, "prior", 0.3,
                             gen(25), "cpu"),
        eps=reparameterize(torch.zeros(n, 2, 2, 3), torch.zeros(n, 2, 2, 3),
                           generator=gen(26)),
        penalty=pen.detach())


def primitives() -> dict:
    """The group's helpers on this rank."""
    from video_layout_generation_tpu_torch import parallel as par
    from video_layout_generation_tpu_torch.train.trainer import (
        sharded_loader)
    r = par.process_index()
    out = dict(rank=r, world=par.process_count(), primary=par.is_primary(),
               again=par.maybe_initialize_distributed("cpu"))
    par.cross_process_barrier("test")
    par.build_then_barrier("cpu")
    f32 = torch.full((3,), float(r + 1))
    i64 = torch.tensor([[r, 10 * r]])
    out["reduced"] = par.all_reduce_flat([f32, i64, f32 * 2])
    out["global_sum"] = par.global_sum(torch.tensor(float(r + 1)))
    mesh = par.make_mesh()
    out["mesh"] = (mesh.shape, mesh.size, [str(d) for d in mesh.devices])
    out["training_mesh"] = par.training_mesh([2]).size
    try:
        par.training_mesh([4])
    except ValueError as e:
        out["too_big"] = str(e)
    batch = {"x": np.arange(8).reshape(4, 2)}
    out["shard"] = par.shard_batch(batch, mesh)[0]["x"]
    t = torch.full((2,), float(r))
    par.replicate([t])
    out["replicated"] = t
    cfg = trainer_config(batch_size=3)
    try:
        sharded_loader(cfg, None, True, "cpu")
    except ValueError as e:
        out["indivisible"] = str(e)
    out["traps"] = trap_losses(rank_rows)
    out["draws"] = trap_draws(rank_rows)
    return out
