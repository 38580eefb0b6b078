#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (video_layout_generation_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0]

Phases:
  1. print the card's name and power limit, build the CUDA kernels from
     ``video_layout_generation_tpu_torch/csrc`` with nvcc (sm_90a); fail on
     any register spill in the two conv kernels and count the tensor-core
     instructions (HMMA / HGMMA) in their SASS, which must be there;
  2. kernels: hold kernel A (prelu_conv3x3, with and without its ReLU
     epilogue) and kernel B (fused_lateral) against their plain PyTorch
     versions in bf16 at the shapes of the rollout, at every conv shape
     of VGG19 and HNED (batch 16, 256x256), at the two 512-channel shapes
     at batch 1 and at ragged shapes that cut every tile, chunk and channel
     block; each case runs twice and must give the same bits; time each
     beside its plain version, a cuDNN yardstick and its bound; hold the
     fused SSIM kernel (ssim_loss) against its plain version in f32 and
     bf16 at the validation step's shape, at batch 1, at ragged shapes and
     at one of 5 channels and two passes a row, once with x = y (loss
     exactly 0), printing its launch plan, asserting from a profiler trace
     that each call is one kernel launch, and timing it beside a ``copy_``
     of the same bytes; hold the three InstanceNorm kernels (forward that
     keeps y and rstd, forward that keeps nothing, backward) against the
     plain version and its autograd in bf16 and f32 at every InstanceNorm shape
     of the pix2pix generator and discriminator (batch 16) and at a ragged
     one, with a constant plane (exactly 0) and a bf16 plane of large mean,
     printing each shape's launch plan (regime, channel tile, cluster size,
     clusters the card holds at once), asserting from a profiler trace that
     each call is one kernel launch and that repeats give the same bits;
     hold kernel A's data gradient (a second launch of A) against autograd
     of the plain version at the conv -> ReLU shapes, beside cuDNN's bf16
     input gradient and its bound; hold the backward of A's and B's
     autograd Functions (the library's VJP, which launches neither) against
     autograd of the plain versions at GridNet's training shapes and time
     it. Every time is device time from a
     torch.profiler trace (CUDA events where the profiler keeps coming
     back with an incomplete trace; the ``kernels`` line's ``timed_by``
     says which);
  3. slice: LayoutPredictor at full width (8-channel GridNet, filters
     32/64/96, 256x256, 8 frames, batch 16, bf16, random weights from
     ``--seed`` passed through the flax weight bridge) answers 3 requests
     (full, padded, pipelined: eager, CUDA-graph capture, replay); the
     launch counters of the eager request and the trace's kernel records
     of a replayed one prove every conv went through the kernels; step 1 is held against the same predictor on the
     plain versions; rollout frames/s, batch-1 latency and a
     torch.profiler breakdown of one b16 request are printed;
  4. validation: the edge-mode validation step at full width (10-channel
     GridNet + HNED + VGG19 ``CombinedLoss``, all bf16 with
     f32 loss islands, random weights from ``--seed`` through the weight
     bridges) runs ``validate`` over 3 uint8 ``packed6`` batches of 16; the
     launch counts of every step are asserted, the loss terms, layouts and
     frames are held against the same step on the plain versions (HNED
     alone, GridNet alone on one shared edge map, and end to end), and
     validation samples/s and a profile of one step are printed;
  5. edge rollout: ``LayoutPredictor(use_edges=True)`` (the same three
     nets) answers b16 requests of 8 frames; launch counts (the eager
     request's counters, a replayed request's trace), step-1
     agreement with the plain versions, frames/s, batch-1 latency and a
     profile of one request are printed;
  6. train: 3 steps of ``make_train_step`` on the full-width pix2pix
     ``ResnetGenerator`` (10 channels in, ngf 64, 9 blocks, InstanceNorm,
     bf16 activations, f32 parameters and Adam state) with HNED and the
     VGG19 ``CombinedLoss`` from uint8 ``packed6`` batches of 16; launch
     counts asserted per step; step 1's loss terms and every parameter's
     gradient held against the same step on the plain versions; train
     samples/s and a profile of one step printed;
  7. GAN train: 2 steps of ``make_gan_train_step`` (lsgan) with the
     full-width ``NLayerDiscriminator`` (ndf 64, 3 layers, InstanceNorm),
     the same checks for both nets, then one wgangp step at batch 4 whose
     gradient penalty must be finite and non-zero;
  8. validation of the ResnetGenerator: one ``make_eval_step`` batch, which
     launches the forward-only InstanceNorm kernel and the SSIM kernel;
  9. GridNet train: 3 steps of ``make_train_step`` at b16 on the
     10-channel GridNet at full width from the committed ``flagship_096``
     snapshot (read with numpy through the weight bridge) and on the
     CoordGridNet (the JAX package's default model) from ``--seed``, with
     HNED and VGG19, bf16 activations, f32 parameters and Adam state;
     launch counts asserted per step (93 A, 15 B), every parameter must
     move and the weight-pack cache must not grow; step 1's loss terms and
     every gradient (each tensor's L2 error printed) held against the plain
     step; samples/s, wall and busy ms, idle share, a profile by kernel
     group and peak memory at b16, and one timed step at b32;
 10. GridNet GAN train: 2 lsgan steps of ``make_gan_train_step`` on the
     flagship GridNet with the full-width PatchGAN, the same checks for
     both nets;
 11. train CLI: ``main.py`` -> ``Config`` -> ``Trainer`` at the JAX
     package's default training configuration (CoordGridNet, edges, 256x256,
     bf16) on the synthetic dataset (64 train, 16 validation samples, b16)
     with the committed HNED and VGG19 snapshots: (a) a fresh 2-epoch run,
     every train step's and validation batch's launches asserted, finite
     losses, checkpoints 001, 002 and latest, the ``predict/`` dump and the
     log lines; (b) ``--resume latest -e 3``: the restored parameters,
     moments, step and learning rate equal the checkpoint's bits, the
     validation before training equals (a)'s last, epoch 3 trains; (c)
     ``--arch GridNet --ckpt artifacts_store/flagship_096.npz --validate``:
     every tensor loaded, validation held against the plain versions on the
     same batch. Printed: the fit loop's train samples/s over epoch 2 with
     its loader wait and compute time, validation samples/s, a profile of
     two steps of the loop (idle share, copies to the card from pinned and
     pageable memory, none of the latter allowed), checkpoint save and
     restore times;
 12. rollout-fidelity training: (a) the JAX package's finetune recipe
     (``--arch GridNet --ckpt artifacts_store/flagship_096.npz
     --multistep_k 4 --multistep_feedback_noise 0.1 --lr 5e-5``, per-step
     recomputation on) through ``main.py`` on phase 11's data as 6-frame
     windows, one epoch: every step's launches asserted (553 A, 120 B;
     ``launches_per_rollout_step``), finite losses with 4 per-step losses;
     (b) step 1 of that K=4 step (flagship, a coin that flips, fixed
     feedback noise) through the kernels against the plain versions, loss
     terms and per-step losses within 2e-2, every gradient within 0.5 in
     L2, and through the kernels with and without recomputation: equal
     losses, gradients within 1e-2 in L2; (c) scheduled sampling (p 0.5)
     on the CoordGridNet, 137 A and 30 B a step; (d) the recipe with
     ``--device_data``: the first batch rendered on the card against the
     host dataset's windows (under 1e-4 of layout pixels differ, colours
     within the host's rounding), one copy to the card in the epoch (its
     indices, from pinned memory) and finite losses. Printed: train
     samples/s of each, busy ms a step, idle share and peak memory of the
     recipe.

 13. the layout families (BASELINE.json's configs 1-3; their convs are the
     library's, as the JAX package's are XLA's, so no kernel of the port
     runs and every launch counter must stay 0): (a) the committed
     ``cvae256_036`` CVAE snapshot (256x256, latent 64, b16) through
     ``LayoutTrainer(ckpt=...)``: ``validate`` over 64 synthetic samples in
     bf16 and in f32 with the same noise (mIoU within 0.01, layouts of one
     batch >= 0.98 equal; f32 mIoU within 0.03 of the JAX package's 0.7834
     on this snapshot and data), ``evaluate_layout_rollout`` over 16 frames
     of 16 scenes, rollout frames/s at b16, b1 latency, a profile and peak
     memory of one rollout; (b) CVAE training through ``layout_cli`` (2
     epochs of 64, b16), the K=3 exposure leg from the snapshot (lr 5e-5,
     5-frame windows, one epoch), and step 1 of that K=3 step in f32 on the
     card (TF32 off) against the CPU with the same batch and noise (loss
     and reconstruction within 1e-3, the KL within one f32 ulp at 1 a
     latent element, gradients within 1e-2 in L2); (c) the ConvLSTM
     (128x128, hidden 64, b16) and the VAE (64x64, b4) through
     ``layout_cli``, two epochs each (the rate of the second), the
     ConvLSTM's 4-frame rollout fidelity; (d) a resume of (b): parameters, moments, step and the first
     validation equal to the checkpoint's bits, then epoch 3. Printed:
     scores, the per-step rollout curve beside the JAX package's, train
     samples/s of each, and the phase's time.
 14. data parallelism, the feeder thread and the native decoder: (a)
     phase 11's fit loop (CoordGridNet, 64 synthetic samples, b16) with and
     without ``--put_thread`` in the order off, on, on, off: one epoch's
     batches equal by sha256, one copy to the card from pinned memory a
     batch and none from pageable memory in a traced epoch of each, the
     rate, loader wait and compute of each leg; (b) in a process of its own
     with the ``torchrun`` variables, three train steps and a validation of
     the CLI's Trainer inside an NCCL group of one rank equal the same run
     outside a group bit for bit (cuDNN deterministic in both), and the
     gradient all-reduce's device ms and bytes a step; (c) two ranks on the
     one card over Gloo with CUDA tensors (NCCL refuses two ranks on one
     device), each on 8 rows of a global b16: two CoordGridNet train steps
     (93 A and 15 B a step a rank), a VAE step with class weights, free
     bits and capacity, a CVAE step and a ``validate``, against this
     process on the concatenated batches: loss terms within 1e-5
     relative, bf16 gradients within 1e-2 in L2 (the slopes as one
     tensor; the f32 layout gradients too: cuDNN picks other algorithms at
     b8), per-class IoU equal;
     (d) ``LayoutPredictor(mesh=make_mesh())`` equals the predictor without
     a mesh bit for bit, and its overhead a request; (e) the native PNG
     decoder, built from ``native/vlg_loader.cpp``, against cv2 / PIL on 8
     triplets of 256x512 PNGs (ids bit for bit, RGB within 2.5/255) and
     its decode ms a triplet both ways, or, where it does not build (no
     libdeflate headers), the compiler's message and the fallback's decode
     ms; then one ``--put_thread`` CLI epoch of ``CityscapesTriplets``
     over them with the decoder the dataset chose.

The launch counters are set to 0 just before each of the phases 3-14 and
read just after it; a kernel of a phase's path that was launched no time
fails the run. Any failure exits non-zero. The line before the last is the
``kernels`` JSON object; the last line is ``{"ok": true, "device": {...}}``. With no CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOP_PER_S = 67e12    # H100 SXM f32 outside the tensor cores
BATCH, HW, FRAMES, FILTERS = 16, (256, 256), 8, (32, 64, 96)
N_CLASSES = 20
VAL_BATCHES = 3
DEVICE = "cuda"
# Launches from the code: a GridNet forward is 31 A + 15 B, an HNED forward
# 13 A, a VGG19 forward to relu4_4 12 A.
NO_LAUNCHES = {"prelu_conv3x3": 0, "fused_lateral": 0, "ssim_loss": 0,
               "instance_norm_fwd": 0, "instance_norm_fwd_only": 0,
               "instance_norm_bwd": 0}
LAUNCHES_PER_ROLLOUT = dict(NO_LAUNCHES, prelu_conv3x3=31 * FRAMES,
                            fused_lateral=15 * FRAMES)
# eval step: GridNet + HNED on frames 1 and 2 + VGG19 on output and target
LAUNCHES_PER_EVAL_STEP = dict(NO_LAUNCHES, prelu_conv3x3=31 + 2 * 13 + 2 * 12,
                              fused_lateral=15, ssim_loss=1)
# edge rollout: per frame GridNet + HNED, plus HNED on the two seed frames
LAUNCHES_PER_EDGE_ROLLOUT = dict(
    NO_LAUNCHES, prelu_conv3x3=(31 + 13) * FRAMES + 2 * 13,
    fused_lateral=15 * FRAMES)
# The pix2pix nets at full width. A ResnetGenerator forward is 5 + 2 * 9
# InstanceNorms, a PatchGAN forward 3. A train step: HNED on frames 1 and 2
# (26 A), VGG19 on output and target (24 A) and the VGG19 data gradient
# (12 A); the SSIM term is the plain formula under autograd.
NGF, N_BLOCKS, NDF = 64, 9, 64
IN_PER_GEN, IN_PER_DISC = 5 + 2 * N_BLOCKS, 3
LAUNCHES_PER_TRAIN_STEP = dict(
    NO_LAUNCHES, prelu_conv3x3=2 * 13 + 2 * 12 + 12,
    instance_norm_fwd=IN_PER_GEN, instance_norm_bwd=IN_PER_GEN)
# the same step under kernels.plain() with the loss under plain(False):
# VGG19's forwards and its data gradient on kernel A, nothing else
LAUNCHES_VGG_PINNED_STEP = dict(NO_LAUNCHES, prelu_conv3x3=2 * 12 + 12)
# GAN step: D on the detached fake pair and the real pair (forward and
# backward), then D on the fake pair for G (forward and backward)
LAUNCHES_PER_GAN_STEP = dict(
    LAUNCHES_PER_TRAIN_STEP,
    instance_norm_fwd=IN_PER_GEN + 3 * IN_PER_DISC,
    instance_norm_bwd=IN_PER_GEN + 3 * IN_PER_DISC)
LAUNCHES_PER_RESNET_EVAL_STEP = dict(
    NO_LAUNCHES, prelu_conv3x3=2 * 13 + 2 * 12, ssim_loss=1,
    instance_norm_fwd_only=IN_PER_GEN)
TRAIN_STEPS, GAN_STEPS, WGANGP_BATCH = 3, 2, 4
# GridNet training: the GridNet forward (31 A + 15 B), HNED on frames 1 and 2
# (26 A), VGG19 on output and target (24 A) and its data gradient (12 A);
# A's and B's own backward is the library's and launches neither. The GAN
# step adds the PatchGAN's InstanceNorms (3 forwards, each differentiated).
LAUNCHES_PER_GRIDNET_TRAIN_STEP = dict(
    NO_LAUNCHES, prelu_conv3x3=31 + 2 * 13 + 2 * 12 + 12, fused_lateral=15)
LAUNCHES_PER_GRIDNET_GAN_STEP = dict(
    LAUNCHES_PER_GRIDNET_TRAIN_STEP, instance_norm_fwd=3 * IN_PER_DISC,
    instance_norm_bwd=3 * IN_PER_DISC)
TRAIN_BATCH_LARGE = 32   # the JAX package's default batch: one timed step
FLAGSHIP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "artifacts_store", "flagship_096.npz")
BWD_TOL = 2e-2       # A's and B's backward vs the plain version's autograd
BWD_MEAN_TOL = 1e-2  # the same in the mean, B's PReLU1 mask flips included
SLOPE_TOL = 2.0 ** -8   # a slope's gradient, of sum |terms|: bf16 rounding
IN_F32_TOL = 1e-5    # max |kernel - plain|, f32, values of order 1
IN_BF16_TOL = 2e-2   # of the plain version's largest value, bf16
DGRAD_TOL = 2e-2     # kernel A's data gradient, of the largest value
DGRAD_MEAN_TOL = 1e-2   # mean error over mean value, ReLU mask included
GRAD_TOL = 5e-2      # a parameter's gradient with VGG19 through kernel A
GRAD_E2E_TOL = 0.5   # L2, the whole step through the kernels vs plain
RESNET_AGREEMENT = 0.9   # layouts of the random generator, kernels vs plain
SSIM_PLANE_TOL = 1e-5   # max |kernel - plain| per plane; values in [0, 1]
LOSS_TERM_RTOL = 2e-2   # kernel path vs plain path, bf16 nets
# Edge-mode frames, kernel path vs plain path. The max-norm limit of the
# no-edge phase (IMG_MAX_TOL of the largest value) is for nets that see
# identical inputs, and is held in edge mode too where GridNet gets one
# shared, plain HNED edge map. End to end the two edge channels come from
# HNED through the kernels, whose own bf16 differences (held under
# EDGE_MAP_TOL) move single pixels further: there the mean |difference|
# over mean |plain| is held, and the share of values within IMG_MAX_TOL.
IMG_MAX_TOL = 2e-2
EDGE_MAP_TOL = 2e-2      # HNED fused edge map in [0, 1], max abs
EDGE_IMG_MEAN_TOL = 1e-2
EDGE_IMG_SHARE = 0.999   # of the values within IMG_MAX_TOL of the maximum
ROUTES = {
    "prelu_conv3x3": dict(
        source="video_layout_generation_tpu_torch/csrc/conv3x3.cu",
        replaces=("video_layout_generation_tpu/ops/pallas/conv_packed.py:165; "
                  "video_layout_generation_tpu/ops/pallas/conv1x2.py:93; "
                  "video_layout_generation_tpu/ops/pallas/conv3x3.py:65"),
        main_case="A prelu row0"),
    "fused_lateral": dict(
        source="video_layout_generation_tpu_torch/csrc/lateral.cu",
        replaces="video_layout_generation_tpu/ops/pallas/conv_packed.py:308",
        main_case="B row0 +res"),
    "ssim_loss": dict(
        source="video_layout_generation_tpu_torch/csrc/ssim.cu",
        replaces="video_layout_generation_tpu/ops/pallas/ssim.py:62",
        main_case="SSIM f32 eval shape"),
    "instance_norm_fwd": dict(
        source="video_layout_generation_tpu_torch/csrc/instance_norm.cu",
        replaces=("video_layout_generation_tpu/ops/pallas/"
                  "instance_norm.py:80"),
        main_case="IN fwd bfloat16 (16, 64, 64, 256)"),
    "instance_norm_fwd_only": dict(
        source="video_layout_generation_tpu_torch/csrc/instance_norm.cu",
        replaces=("video_layout_generation_tpu/ops/pallas/"
                  "instance_norm.py:119"),
        main_case="IN fwd_only bfloat16 (16, 64, 64, 256)"),
    "instance_norm_bwd": dict(
        source="video_layout_generation_tpu_torch/csrc/instance_norm.cu",
        replaces=("video_layout_generation_tpu/ops/pallas/"
                  "instance_norm.py:101"),
        main_case="IN bwd bfloat16 (16, 64, 64, 256)"),
}


TRACE_TRIES = 6           # profiler traces taken before giving up on one
COPY_TRACE_TRIES = 3      # traces taken for a complete set of copy records
EVENT_TIMED = []          # one entry for each timing taken with CUDA events


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def retry_pause(attempt: int) -> None:
    """The pause before the ``attempt``-th try of a profiler trace. A trace
    now and then comes back empty or holds only some of the launches, and
    such traces come in runs of a few in a row (five once), so the tries
    are spread over seconds, not taken back to back."""
    if attempt:
        time.sleep(0.5 * attempt)


def complete(rows, calls: int) -> bool:
    """Whether a trace of ``calls`` calls of the same function holds all of
    their launches: every call launches at least one kernel, and the same
    kernels each time, so every row counts a multiple of ``calls``."""
    return (sum(count for _, count in rows) >= calls
            and all(count % calls == 0 for _, count in rows))


def device_ms(torch, fn, reps: int = 20):
    """Mean device time per call of ``fn``: the summed time of every kernel
    and copy that ``reps`` calls put on the card, from a torch.profiler
    trace. Every ``ms``, ``plain_ms`` and ``library_ms`` of the script comes
    from here. Host time and the gaps between kernels are left out, so a
    kernel shorter than its wrapper's host path is timed as the card ran
    it. An incomplete trace is taken again; after ``TRACE_TRIES`` of them
    the calls are timed with CUDA events instead (``event_ms``), and
    ``EVENT_TIMED`` counts that."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    for attempt in range(TRACE_TRIES):
        retry_pause(attempt)
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [ev for ev in prof.key_averages() if on_device(torch, ev)]
        if complete([(ev.key, ev.count) for ev in rows], reps):
            return sum(ev.self_device_time_total for ev in rows) / 1e3 / reps
        print(f"device_ms: incomplete trace ({sum(ev.count for ev in rows)} "
              f"launches for {reps} calls), taking it again", flush=True)
    EVENT_TIMED.append(1)
    ms = event_ms(torch, fn, reps)
    print(f"device_ms: {TRACE_TRIES} incomplete traces; timed with CUDA "
          f"events instead: {ms:.6f} ms a call", flush=True)
    return ms


def event_ms(torch, fn, reps: int) -> float:
    """Mean time per call of ``reps`` calls of ``fn`` between two CUDA
    events. The calls are enqueued behind a sleep kernel that outlasts the
    host's loop, so they run back to back and host time is left out; the
    gaps between kernels are counted, so this reads a little above the
    profiler's sum."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e6 cycles a millisecond is the H100's top clock: at a lower one the
    # sleep only lasts longer
    torch.cuda._sleep(int((2 * host_ms + 5.0) * 2e6))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timing_method(n_event_timed: int) -> str:
    """``timed_by`` of a case whose timings fell back to CUDA events
    ``n_event_timed`` times."""
    if n_event_timed == 0:
        return "torch.profiler device time"
    return (f"torch.profiler device time; CUDA events for {n_event_timed} "
            f"of its timings (the profiler's traces were incomplete)")


def on_device(torch, ev) -> bool:
    """A row of ``key_averages()`` that is a kernel or a copy on the card.
    Rows of host-side ops are left out: a kernel launched straight from an
    autograd Function (no aten op around it) also counts its device time on
    the Function's own row, which would count it twice."""
    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not ev.key.startswith("Activity"))


def bound(nbytes: int, flops: int, peak_flops: float = PEAK_BF16_FLOP_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---- phase 1: what the compiler made of the conv kernels -------------------

TENSOR_CORE_KERNELS = ("conv3x3", "lateral")


def check_no_spills(logs):
    """Fail on any register spill that ptxas reports for the conv kernels
    (their accumulators fill most of the register file)."""
    for name in TENSOR_CORE_KERNELS:
        for line in logs.get(name, "").splitlines():
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            check(m is None or (m.group(1), m.group(2)) == ("0", "0"),
                  f"ptxas {name}: {line.strip()}")


def count_tensor_core_instructions(_build):
    """Count HMMA / HGMMA instructions in the SASS of the built conv
    libraries with the ``cuobjdump`` that stands beside ``nvcc``; they must be
    there. Without ``cuobjdump`` the line says so."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print("sass: cuobjdump not found beside nvcc; tensor-core "
              "instructions not counted", flush=True)
        return
    for name in TENSOR_CORE_KERNELS:
        out = subprocess.run([tool, "-sass", str(_build._target(name))],
                             capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"cuobjdump {name}: {out.stderr[:500]}")
        hmma = out.stdout.count("HMMA")
        hgmma = out.stdout.count("HGMMA")
        print(f"sass {name}: {hmma} HMMA, {hgmma} HGMMA instructions",
              flush=True)
        check(hmma + hgmma > 0,
              f"{name}: no tensor-core instruction in the built library")


# ---- phase 2: kernels ------------------------------------------------------

def kernel_cases():
    """(kernel, name, shape (N, H, W, Ci), Co, stride, prelu, residual,
    relu_out, norm-error bound)."""
    r0, r1, r2 = ((BATCH, 256, 256), (BATCH, 128, 128), (BATCH, 64, 64))
    a = [
        ("A prelu row0", r0 + (32,), 32, 1, True, False),
        ("A prelu+res row0", r0 + (32,), 32, 1, True, True),
        ("A plain C64 128^2 (TPU conv1x2)", r1 + (64,), 64, 1, False, False),
        ("A plain C128 128^2 (TPU conv3x3)", r1 + (128,), 128, 1, False,
         False),
        ("A stride2 32->64", r0 + (32,), 64, 2, True, False),
        ("A input 8->32", r0 + (8,), 32, 1, True, False),
        ("A head 32->20", r0 + (32,), 20, 1, True, False),
        # ragged in every direction: tiles, channel chunks and the channel
        # block are all cut, so every mask of the kernel is exercised
        ("A ragged 24->20 (3,37,53) +res", (3, 37, 53, 24), 20, 1, True,
         True),
        ("A ragged 24->20 (3,37,53) stride2 +res", (3, 37, 53, 24), 20, 2,
         True, True),
    ]
    r3, r4 = (BATCH, 32, 32), (BATCH, 16, 16)
    # every conv -> ReLU shape of VGG19 (to relu4_4) and HNED (5 stages)
    relu = [
        ("A relu 3->64 256^2 (VGG/HNED conv1_1)", r0 + (3,), 64),
        ("A relu 64->64 256^2 (VGG/HNED conv1_2)", r0 + (64,), 64),
        ("A relu 64->128 128^2 (VGG/HNED conv2_1)", r1 + (64,), 128),
        ("A relu 128->128 128^2 (VGG/HNED conv2_2)", r1 + (128,), 128),
        ("A relu 128->256 64^2 (VGG/HNED conv3_1)", r2 + (128,), 256),
        ("A relu 256->256 64^2 (VGG/HNED stage 3)", r2 + (256,), 256),
        ("A relu 256->512 32^2 (VGG/HNED conv4_1)", r3 + (256,), 512),
        ("A relu 512->512 32^2 (VGG/HNED stage 4)", r3 + (512,), 512),
        ("A relu 512->512 16^2 (HNED stage 5)", r4 + (512,), 512),
        # batch 1: the edge-mode request's latency hangs on these two
        ("A relu 512->512 32^2 b1", (1, 32, 32, 512), 512),
        ("A relu 512->512 16^2 b1", (1, 16, 16, 512), 512),
    ]
    b = []
    for row, shp, c in (("row0", r0, 32), ("row1", r1, 64), ("row2", r2, 96)):
        b.append((f"B {row}", shp + (c,), c, 1, True, False))
        b.append((f"B {row} +res", shp + (c,), c, 1, True, True))
    b.append(("B ragged C40 (3,37,53) +res", (3, 37, 53, 40), 40, 1, True,
              True))
    return ([("prelu_conv3x3",) + x + (False, 1e-2) for x in a]
            + [("prelu_conv3x3",) + x + (1, False, False, True, 1e-2)
               for x in relu]
            + [("fused_lateral",) + x + (False, 2e-2) for x in b])


def run_kernel_case(torch, F, kern, case, seed):
    kernel, name, shape, co, stride, act, with_res, relu_out, tol = case
    n, h, w, ci = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    x = randn(n, h, w, ci)
    res = randn(n, ho, wo, co) if with_res else None
    alpha = torch.tensor(0.25, device=dev)
    if kernel == "prelu_conv3x3":
        wt = randn(3, 3, ci, co, scale=(9 * ci) ** -0.5)
        bias = randn(co, scale=0.1, dtype=torch.float32)
        al = alpha if act else None
        args = (x, wt, bias, al, res, stride, relu_out)
        fn, plain = kern.prelu_conv3x3, kern.prelu_conv3x3_plain
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        x_cl = x.permute(0, 3, 1, 2)   # channels_last view, no copy

        def library():
            y = F.conv2d(x_cl, w_oihw, bias.to(x.dtype), stride=stride,
                         padding=1)
            return F.relu(y) if relu_out else y
        flops = 2 * n * ho * wo * co * 9 * ci
        nbytes = 2 * (x.numel() + wt.numel() + n * ho * wo * co
                      + (res.numel() if with_res else 0)) + 4 * co
    else:
        w0 = randn(3, 3, ci, ci, scale=(9 * ci) ** -0.5)
        w1 = randn(3, 3, ci, ci, scale=(9 * ci) ** -0.5)
        b0 = randn(ci, scale=0.1, dtype=torch.float32)
        b1 = randn(ci, scale=0.1, dtype=torch.float32)
        a1 = torch.tensor(0.1, device=dev)
        args = (x, w0, b0, alpha, w1, b1, a1, res)
        fn, plain = kern.fused_lateral, kern.fused_lateral_plain
        w0o = w0.permute(3, 2, 0, 1).contiguous()
        w1o = w1.permute(3, 2, 0, 1).contiguous()
        x_cl = x.permute(0, 3, 1, 2)

        def library():
            y = F.conv2d(x_cl, w0o, b0.to(x.dtype), padding=1)
            return F.conv2d(y, w1o, b1.to(x.dtype), padding=1)
        flops = 2 * 2 * n * h * w * ci * 9 * ci
        nbytes = 2 * (2 * x.numel() + w0.numel() + w1.numel()
                      + (res.numel() if with_res else 0)) + 8 * ci
    got = fn(*args)
    again = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    check(got.shape == (n, ho, wo, co) and got.dtype == torch.bfloat16,
          f"{name}: output {tuple(got.shape)} {got.dtype}")
    # a race between the asynchronous copies and the tensor-core reads
    # would show as a rare difference between two launches
    check(bool(torch.equal(got, again)),
          f"{name}: two launches on the same inputs differ")
    diff = (got.float() - ref.float()).abs()
    max_abs = float(diff.max())
    norm = max_abs / max(float(ref.float().abs().max()), 1e-30)
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    ms = device_ms(torch, lambda: fn(*args))
    plain_ms = device_ms(torch, lambda: plain(*args))
    library_ms = device_ms(torch, library)
    b_ms, b_by = bound(nbytes, flops)
    check(not relu_out or float(got.float().min()) == 0.0,
          f"{name}: the ReLU epilogue left a value below zero or none at 0")
    rec = dict(case=name, kernel=kernel, shape=list(shape), co=co,
               stride=stride, relu_out=relu_out, max_abs_err=max_abs,
               norm_err=norm,
               norm_err_bound=tol, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
               flops=flops, bytes=nbytes,
               roofline_share=b_ms / ms)
    print("case " + json.dumps(rec), flush=True)
    check(norm <= tol, f"{name}: normalized error {norm:.3e} > {tol:.0e}")
    return rec


def ssim_cases():
    """(name, shape, dtype name, same: x == y)."""
    full = (BATCH,) + HW + (3,)
    return [("SSIM f32 eval shape", full, "float32", False),
            ("SSIM bf16 eval shape", full, "bfloat16", False),
            ("SSIM f32 b1 (1,256,256,3)", (1,) + HW + (3,), "float32",
             False),
            ("SSIM f32 ragged (5,130,94,3)", (5, 130, 94, 3), "float32",
             False),
            ("SSIM bf16 ragged (5,130,94,3)", (5, 130, 94, 3), "bfloat16",
             False),
            # C = 5 (the instance for any C), rows wider than one pass,
            # ends off 16 bytes
            ("SSIM bf16 C=5 two passes (2,20,300,5)", (2, 20, 300, 5),
             "bfloat16", False),
            ("SSIM f32 x == y", full, "float32", True)]


def ssim_inputs(torch, shape, dtype, same, seed, pairs=4):
    """``pairs`` input pairs on the card: x in [0, 1], y = x plus noise
    (or x itself)."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(pairs):
        x = (torch.randn(shape, generator=g, device=dev) * 0.2
             + 0.5).clamp(0, 1)
        y = x if same else (x + 0.1 * torch.randn(
            shape, generator=g, device=dev)).clamp(0, 1)
        out.append((x.to(dtype), y.to(dtype).clone()))
    return out


def ssim_bound(torch, shape, dtype):
    """(bound ms, bound by, bytes, flops) of one SSIM call: x and y read
    once, the (N, C) f32 planes written once; per output value 15
    operations for the horizontal sums, 10 for the vertical ones, about 30
    for the SSIM map and the clip, 1 to accumulate."""
    n, h, w, c = shape
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * n * h * w * c * esize + 4 * n * c
    flops = 56 * n * (h - 2) * (w - 2) * c
    b_ms, b_by = bound(nbytes, flops, PEAK_F32_FLOP_PER_S)
    return b_ms, b_by, nbytes, flops


def run_ssim_case(torch, kern, case, seed):
    """Hold the fused SSIM kernel against its plain version per plane, assert
    from a profiler trace that a call is one kernel launch and that repeats
    give the same bits, print its launch plan, and time it beside the plain
    version and a ``copy_`` of the same bytes (x read and written: what a
    plain copy takes for the bytes the kernel must read). The timed launches
    rotate over 4 input pairs (100 MB in f32 at the eval shape) so that none
    finds its inputs in the 50 MB L2."""
    name, shape, dtype_name, same = case
    mod = kern.ssim
    dtype = getattr(torch, dtype_name)
    pairs = ssim_inputs(torch, shape, dtype, same, seed)
    x, y = pairs[0]
    n, h, w, c = shape
    plan = dict(mod.plan_for(x), active_clusters=mod.active_clusters(x))
    print(f"SSIM plan {dtype_name} {shape}: " + json.dumps(plan), flush=True)
    check(plan["active_clusters"] > 0,
          f"{name}: the card holds no cluster of the plan {plan}")
    got = kern.ssim_planes(x, y)
    again = kern.ssim_planes(x, y)
    ref = kern.ssim_planes_plain(x, y)
    loss = kern.ssim_loss(x, y)
    torch.cuda.synchronize()
    check(got.shape == (n, c) and got.dtype == torch.float32,
          f"{name}: output {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    check(bool(torch.equal(got, again)),
          f"{name}: two launches on the same inputs differ")
    rows = kernels_on_card(torch, lambda: kern.ssim_planes(x, y))
    check(len(rows) == 1 and rows[0][1] == 1 and "ssim_kernel" in rows[0][0],
          f"{name}: kernels of one call {rows}")
    max_abs = float((got - ref).abs().max())
    loss_err = abs(float(loss) - float(ref.mean(dim=0).sum()))
    if same:
        check(float(got.abs().max()) == 0.0 and float(loss) == 0.0,
              f"{name}: loss of x against itself is {float(loss)!r}, not 0")
    turn = [0]

    def rotate(fn):
        def call():
            turn[0] = (turn[0] + 1) % len(pairs)
            return fn(*pairs[turn[0]])
        return call

    dst = torch.empty_like(x)
    ms = device_ms(torch, rotate(kern.ssim_planes), reps=200)
    plain_ms = device_ms(torch, rotate(kern.ssim_planes_plain), reps=40)
    copy_ms = device_ms(torch, rotate(lambda a, _: dst.copy_(a)), reps=200)
    b_ms, b_by, nbytes, flops = ssim_bound(torch, shape, dtype)
    rec = dict(case=name, kernel="ssim_loss", shape=list(shape),
               dtype=dtype_name, max_abs_err=max_abs, loss_abs_err=loss_err,
               plane_err_bound=SSIM_PLANE_TOL, loss=float(loss), ms=ms,
               plain_ms=plain_ms, library_ms=None, copy_ms=copy_ms,
               bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
               roofline_share=b_ms / ms, launches_a_call=1, plan=plan)
    print("case " + json.dumps(rec), flush=True)
    check(max_abs <= SSIM_PLANE_TOL,
          f"{name}: plane error {max_abs:.3e} > {SSIM_PLANE_TOL:.0e}")
    return rec


def instance_norm_cases():
    """(shape, dtype name, kind): every InstanceNorm shape of the full-width
    ResnetGenerator (C=64 at 256^2, 128 at 128^2, 256 at 64^2) and
    NLayerDiscriminator (128 at 64^2, 256 at 32^2, 512 at 31^2) at batch 16,
    a ragged one, a constant plane and a bf16 plane of large mean."""
    shapes = [(BATCH, 256, 256, 64), (BATCH, 128, 128, 128),
              (BATCH, 64, 64, 256), (BATCH, 64, 64, 128),
              (BATCH, 32, 32, 256), (BATCH, 31, 31, 512), (3, 17, 23, 20)]
    cases = [(shp, dt, "random") for dt in ("bfloat16", "float32")
             for shp in shapes]
    return cases + [((BATCH, 64, 64, 256), "bfloat16", "constant"),
                    ((BATCH, 64, 64, 256), "float32", "constant"),
                    ((BATCH, 31, 31, 512), "bfloat16", "large mean")]


def run_instance_norm_case(torch, F, kern, case, seed):
    """Hold the three InstanceNorm kernels against the plain version and
    its autograd, and time each beside the plain version and
    ``F.instance_norm``. The timed launches rotate over 3 sets of inputs so
    that the larger shapes do not find theirs in the 50 MB L2."""
    shape, dtype_name, kind = case
    mod = kern.instance_norm
    dtype = getattr(torch, dtype_name)
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)
    n, h, w, c = shape

    def make_x():
        if kind == "constant":   # exact in bf16, and so is every sum of it
            return (1.0 + 0.5 * (torch.arange(c, device=dev) % 7)).expand(
                shape).to(dtype).contiguous()
        x = torch.randn(shape, generator=g, device=dev) * 1.5
        offset = 100.0 if kind == "large mean" else 2.0
        x = x + offset * torch.randn((n, 1, 1, c), generator=g, device=dev)
        return x.to(dtype)

    xs = [make_x() for _ in range(3)]
    dys = [torch.randn(shape, generator=g, device=dev).to(dtype)
           for _ in range(3)]
    x, dy = xs[0], dys[0]
    tag = f"{dtype_name} {shape}" + ("" if kind == "random" else f" {kind}")

    plans = {}
    for short, backward in (("fwd", False), ("bwd", True)):
        plan = mod.instance_norm_plan(n, h, w, c, dtype, backward,
                                      mod.sm_count(x.device))
        plans[short] = dict(regime=plan["regime"], ct=plan["ct"],
                            k=plan["k"], rows=plan["rows"],
                            held=plan["held"], smem=plan["smem"],
                            active_clusters=mod.active_clusters(x, backward))
    print(f"IN plan {dtype_name} {shape}: " + json.dumps(plans), flush=True)

    before = kern.launch_counts()
    xk = x.clone().requires_grad_(True)
    y, rstd = mod.InstanceNormFunction.apply(xk, mod.EPS)
    y2, rstd2 = mod.InstanceNormFunction.apply(xk, mod.EPS)   # again
    with torch.no_grad():
        only = mod.instance_norm(x)            # keeps nothing
    dx, = torch.autograd.grad(y, xk, dy, retain_graph=True)
    dx2, = torch.autograd.grad(y, xk, dy)
    xp = x.clone().requires_grad_(True)
    ref = mod.instance_norm_plain(xp)
    dx_ref, = torch.autograd.grad(ref, xp, dy)
    torch.cuda.synchronize()
    after = kern.launch_counts()
    diff = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    check(diff == {"instance_norm_fwd": 2, "instance_norm_fwd_only": 1,
                   "instance_norm_bwd": 2}, f"IN {tag}: launches {diff}")
    check(y.dtype == dtype and y.shape == shape and rstd.shape == (n, c)
          and rstd.dtype == torch.float32, f"IN {tag}: output types")
    check(bool(torch.equal(y, y2)) and bool(torch.equal(rstd, rstd2))
          and bool(torch.equal(y, only)),
          f"IN {tag}: the three forwards differ")
    # one launch a call, whatever the regime: the only kernel on the card
    with torch.no_grad():
        one = {
            "fwd": kernels_on_card(torch, lambda: mod.InstanceNormFunction
                                   .apply(x, mod.EPS)),
            "fwd_only": kernels_on_card(torch, lambda: mod.instance_norm(x)),
            "bwd": kernels_on_card(torch, lambda: mod._InstanceNormBackward
                                   .apply(dy, y.detach(), rstd.detach()))}
    for short, rows in one.items():
        name = "instance_norm_bwd_kernel" if short == "bwd" else \
            "instance_norm_fwd_kernel"
        check(len(rows) == 1 and rows[0][1] == 1 and name in rows[0][0],
              f"IN {short} {tag}: kernels of one call {rows}")
    check(bool(torch.equal(dx, dx2)),
          f"IN {tag}: two backward launches differ")
    errs = {}
    for name, got, want in (("fwd", y, ref), ("bwd", dx, dx_ref)):
        check(bool(torch.isfinite(got.float()).all()),
              f"IN {name} {tag}: non-finite")
        d = float((got.float() - want.float()).detach().abs().max())
        top = max(float(want.float().detach().abs().max()), 1e-30)
        errs[name] = (d, d / top)
    if kind == "constant":
        top = float(y.detach().float().abs().max())
        check(top == 0.0, f"IN {tag}: a constant plane gives {top!r}, not 0")
    var = x.float().var(dim=(1, 2), unbiased=False)
    rstd_err = float((rstd.detach() - torch.rsqrt(var + mod.EPS)).abs().max()
                     / rstd.detach().abs().max())

    turn = [0]

    def rotate(fn, *lists):
        def call():
            turn[0] = (turn[0] + 1) % 3
            return fn(*(lst[turn[0]] for lst in lists))
        return call

    esize = x.element_size()
    numel = x.numel()
    recs = []
    timed = kind == "random"
    if timed:
        x_grads = [t.clone().requires_grad_(True) for t in xs]
        saved = [mod.InstanceNormFunction.apply(t, mod.EPS) for t in x_grads]
        ys = [s[0].detach() for s in saved]
        rstds = [s[1].detach() for s in saved]
        x_cl = [t.permute(0, 3, 1, 2) for t in xs]    # channels_last views
        lib_in = [t.clone().requires_grad_(True) for t in x_cl]
        lib_out = [F.instance_norm(t) for t in lib_in]
        dy_cl = [t.permute(0, 3, 1, 2) for t in dys]
        with torch.no_grad():
            ms_only = device_ms(torch, rotate(mod.instance_norm, xs))
            plain_fwd = device_ms(torch, rotate(mod.instance_norm_plain, xs))
            lib_fwd = device_ms(torch, rotate(F.instance_norm, x_cl))
            plain_bwd = device_ms(torch, rotate(mod.instance_norm_bwd_plain,
                                                dys, ys, rstds))
        ms_fwd = device_ms(torch, rotate(
            lambda t: mod.InstanceNormFunction.apply(t, mod.EPS), x_grads))
        ms_bwd = device_ms(torch, rotate(
            lambda s, t, d: torch.autograd.grad(s[0], t, d,
                                                retain_graph=True),
            saved, x_grads, dys))
        lib_bwd = device_ms(torch, rotate(
            lambda o, t, d: torch.autograd.grad(o, t, d, retain_graph=True),
            lib_out, lib_in, dy_cl))
    for kernel, short, err, nbytes, flops in (
            ("instance_norm_fwd", "fwd", errs["fwd"],
             2 * numel * esize + 4 * n * c, 8 * numel),
            ("instance_norm_fwd_only", "fwd_only", errs["fwd"],
             2 * numel * esize, 8 * numel),
            ("instance_norm_bwd", "bwd", errs["bwd"],
             3 * numel * esize + 4 * n * c, 10 * numel)):
        b_ms, b_by = bound(nbytes, flops, PEAK_F32_FLOP_PER_S)
        rec = dict(case=f"IN {short} {tag}", kernel=kernel,
                   shape=list(shape), dtype=dtype_name, kind=kind,
                   max_abs_err=err[0], norm_err=err[1],
                   rstd_rel_err=rstd_err, bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, flops=flops,
                   plan=plans["bwd" if short == "bwd" else "fwd"],
                   launches_a_call=1)
        if timed:
            ms, plain_ms, library_ms = {
                "fwd": (ms_fwd, plain_fwd, lib_fwd),
                "fwd_only": (ms_only, plain_fwd, lib_fwd),
                "bwd": (ms_bwd, plain_bwd, lib_bwd)}[short]
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       roofline_share=b_ms / ms)
        recs.append(rec)
        print("case " + json.dumps(rec), flush=True)
    for name, (d, rel) in errs.items():
        if dtype == torch.float32:
            # absolute for values of order 1; the constant plane's backward
            # is 316 x dy (rstd = eps^-1/2), so it is held relative there
            check(d <= IN_F32_TOL * max(1.0, d / max(rel, 1e-30)),
                  f"IN {name} {tag}: error {d:.3e} > {IN_F32_TOL:.0e}")
        else:
            check(rel <= IN_BF16_TOL, f"IN {name} {tag}: normalized error "
                  f"{rel:.3e} > {IN_BF16_TOL:.0e}")
    check(rstd_err <= 1e-3, f"IN {tag}: rstd error {rstd_err:.3e}")
    return recs


def run_dgrad_case(torch, kern, case, seed):
    """Kernel A's data gradient (the backward of its autograd Function, a
    second launch of A with the flipped kernel) against autograd of the
    plain version, at one conv -> ReLU shape of VGG19 / HNED."""
    _, name, shape, co, _, _, _, _, _ = case
    n, h, w, ci = shape
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    x = randn(n, h, w, ci)
    wt = randn(3, 3, ci, co, scale=(2.0 / (9 * ci)) ** 0.5)
    bias = randn(co, scale=0.1, dtype=torch.float32)
    up = randn(n, h, w, co)
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    before = kern.launch_counts()["prelu_conv3x3"]
    yk = kern.prelu_conv3x3(xk, wt, bias, relu_out=True)
    dxk, = torch.autograd.grad(yk, xk, up, retain_graph=True)
    torch.cuda.synchronize()
    check(kern.launch_counts()["prelu_conv3x3"] - before == 2,
          f"{name}: forward and data gradient are not two launches of A")
    dxk2, = torch.autograd.grad(yk, xk, up, retain_graph=True)
    check(bool(torch.equal(dxk, dxk2)),
          f"{name}: two data-gradient launches on the same inputs differ")
    yp = kern.prelu_conv3x3_plain(xp, wt, bias, relu_out=True)
    dxp, = torch.autograd.grad(yp, xp, up, retain_graph=True)
    # The ReLU's mask is a step: where the kernel's and the plain version's
    # y fall on opposite sides of zero (sums in another order), one entry of
    # dz flips and moves 9 x Ci values of dx by |dy| x |w|. So the data
    # gradient itself is held in max norm against autograd of the plain conv
    # on the kernel's own mask, and against the plain conv -> ReLU in the
    # mean, with the share of flipped mask entries beside it.
    xl = x.clone().requires_grad_(True)
    yl = kern.prelu_conv3x3_plain(xl, wt, bias)
    dxl, = torch.autograd.grad(yl, xl, up * (yk.detach() > 0))
    check(dxk.shape == x.shape and dxk.dtype == torch.bfloat16,
          f"{name}: gradient {tuple(dxk.shape)} {dxk.dtype}")
    check(bool(torch.isfinite(dxk.float()).all()), f"{name}: non-finite")
    max_abs = float((dxk.float() - dxl.float()).abs().max())
    norm = max_abs / max(float(dxl.float().abs().max()), 1e-30)
    relu_mean_err = float((dxk.float() - dxp.float()).abs().mean()
                          / dxp.float().abs().mean())
    mask_flips = float(((yk > 0) != (yp > 0)).float().mean())
    ms = device_ms(torch, lambda: torch.autograd.grad(
        yk, xk, up, retain_graph=True), reps=10)
    plain_ms = device_ms(torch, lambda: torch.autograd.grad(
        yp, xp, up, retain_graph=True), reps=10)
    # the yardstick: cuDNN's bf16 input gradient of the same conv (the plain
    # version's backward is an f32 conv, which is none)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous()
    up_cl = up.permute(0, 3, 1, 2)     # channels_last view, no copy
    library_ms = device_ms(torch, lambda: torch.nn.grad.conv2d_input(
        (n, ci, h, w), w_oihw, up_cl, padding=1), reps=10)
    flops = 2 * n * h * w * co * 9 * ci
    nbytes = 2 * (2 * up.numel() + wt.numel() + x.numel())
    b_ms, b_by = bound(nbytes, flops)
    rec = dict(case=name.replace("A relu", "A dgrad relu"),
               kernel="prelu_conv3x3", shape=list(shape), co=co,
               max_abs_err=max_abs, norm_err=norm, norm_err_bound=DGRAD_TOL,
               relu_autograd_mean_err=relu_mean_err, mask_flips=mask_flips,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
               roofline_share=b_ms / ms)
    print("case " + json.dumps(rec), flush=True)
    check(norm <= DGRAD_TOL,
          f"{name}: data gradient error {norm:.3e} > {DGRAD_TOL:.0e}")
    check(relu_mean_err <= DGRAD_MEAN_TOL,
          f"{name}: mean data gradient error against the plain conv -> ReLU "
          f"{relu_mean_err:.3e} > {DGRAD_MEAN_TOL:.0e}")
    return rec


def backward_cases():
    """(kernel, name, shape (N, H, W, Ci), Co, stride, residual): kernel A's
    and kernel B's Functions at GridNet's training shapes (batch 16)."""
    r0, r1, r2 = ((BATCH, 256, 256), (BATCH, 128, 128), (BATCH, 64, 64))
    return [("prelu_conv3x3", "A bwd prelu+res row0 32->32", r0 + (32,), 32,
             1, True),
            ("prelu_conv3x3", "A bwd stride2 32->64", r0 + (32,), 64, 2,
             False),
            ("prelu_conv3x3", "A bwd head 32->20", r0 + (32,), 20, 1, False),
            ("fused_lateral", "B bwd row0 +res", r0 + (32,), 32, 1, True),
            ("fused_lateral", "B bwd row1 +res", r1 + (64,), 64, 1, True),
            ("fused_lateral", "B bwd row2 +res", r2 + (96,), 96, 1, True)]


def lateral_on_own_intermediate(torch, kern, args):
    """Kernel B's function in f32 math, as ``fused_lateral_plain`` computes
    it, but with the intermediate's value (and so PReLU1's mask) taken from
    the Function's backward, which recomputes it with the library's bf16
    conv: the gradient of this is what that backward must match, value for
    value. A value within rounding of zero may fall on the other side of
    it in the plain version; there its slope, not 1, scales the gradient."""
    from video_layout_generation_tpu_torch.ops.kernels.conv3x3 import (
        conv3x3_plain_f32, prelu_plain)
    x, w0, b0, a0, w1, b1, a1, res = args
    z0 = conv3x3_plain_f32(prelu_plain(x, a0), w0, b0)
    with torch.no_grad():
        _, own = kern.lateral._conv0(x.detach(), w0.detach(), b0.detach(),
                                     a0.detach())
    y0 = z0 + (own.float() - z0).detach()
    slope = a1.reshape(()).to(x.dtype).float()
    y1 = torch.where(y0 >= 0, y0, (slope * y0).to(x.dtype).float())
    out = conv3x3_plain_f32(y1, w1, b1)
    if res is not None:
        out = out + res.float()
    return out.to(x.dtype), (own, y0)


def run_backward_case(torch, kern, case, seed):
    """The backward of kernel A's or kernel B's autograd Function (the
    library's VJP, recomputed from the saved inputs) against autograd of
    the plain version on the same bf16 inputs: dx, the weights, biases and
    residual within ``BWD_TOL`` of their largest value, each slope within
    ``SLOPE_TOL`` of the size of its terms (a sum over a whole activation
    that random inputs make cancel about a thousandfold, so that bf16's
    rounding of its terms moves it by a few percent of itself; the relative
    error is printed). For kernel B these are held on the backward's
    own intermediate (``lateral_on_own_intermediate``: PReLU1's mask is a
    step, and the library's recomputation rounds conv0's output before its
    bias where the kernel rounds once), and every tensor's mean error
    against the plain version itself within ``BWD_MEAN_TOL`` of its mean
    value, with the share of flipped mask entries printed. Asserts that the
    backward launches no kernel of the port, and times it (device time)
    beside the plain version's backward."""
    kernel, name, shape, co, stride, with_res = case
    n, h, w, ci = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    x = randn(n, h, w, ci)
    res = randn(n, ho, wo, co) if with_res else None
    dy = randn(n, ho, wo, co)
    if kernel == "prelu_conv3x3":
        args = [x, randn(3, 3, ci, co, scale=(9 * ci) ** -0.5),
                randn(co, scale=0.1, dtype=torch.float32),
                torch.tensor(0.25, device=dev), res]
        names = ["x", "w", "b", "alpha", "residual"]
        fn, plain = kern.prelu_conv3x3, kern.prelu_conv3x3_plain
        extra = (stride,)
        flops = 2 * 2 * n * ho * wo * co * 9 * ci
        n_convs = 1
    else:
        args = [x, randn(3, 3, ci, ci, scale=(9 * ci) ** -0.5),
                randn(ci, scale=0.1, dtype=torch.float32),
                torch.tensor(0.25, device=dev),
                randn(3, 3, ci, ci, scale=(9 * ci) ** -0.5),
                randn(ci, scale=0.1, dtype=torch.float32),
                torch.tensor(0.1, device=dev), res]
        names = ["x", "w0", "b0", "a0", "w1", "b1", "a1", "residual"]
        fn, plain = kern.fused_lateral, kern.fused_lateral_plain
        extra = ()
        flops = 2 * 2 * 2 * n * h * w * ci * 9 * ci
        n_convs = 2
    present = [i for i, a in enumerate(args) if a is not None]

    def grads_of(f):
        """(output, gradients of the present arguments, extra) of f on
        fresh leaves."""
        leaves = list(args)
        for i in present:
            leaves[i] = args[i].clone().requires_grad_(True)
        y, more = f(leaves)
        wrt = [leaves[i] for i in present]
        return y, wrt, torch.autograd.grad(y, wrt, dy, retain_graph=True), \
            more

    yk, wrt_k, gk, _ = grads_of(lambda a: (fn(*a, *extra), None))
    before = kern.launch_counts()
    gk = torch.autograd.grad(yk, wrt_k, dy, retain_graph=True)
    torch.cuda.synchronize()
    check(kern.launch_counts() == before,
          f"{name}: the backward launched a kernel of the port")
    yp, wrt_p, gp, _ = grads_of(lambda a: (plain(*a, *extra), None))
    flips = 0.0
    # a slope's gradient is sum(v * g) over the negative entries v of its
    # PReLU's input, g the gradient of its output, which is the gradient of
    # v over the slope there: sum(|v * g|) is the size of its terms
    if kernel == "fused_lateral":
        yo, _, go, (own, y0o) = grads_of(
            lambda a: lateral_on_own_intermediate(torch, kern, a))
        dy0, = torch.autograd.grad(yo, [y0o], dy, retain_graph=True)
        with torch.no_grad():
            z0 = kern.conv3x3.conv3x3_plain_f32(
                kern.conv3x3.prelu_plain(x, args[3]), args[1],
                args[2]).to(x.dtype)
        flips = float(((own < 0) != (z0 < 0)).float().mean())
        slope_inputs = {"a0": (x, go[0], args[3]),
                        "a1": (own, dy0, args[6])}
    else:
        go = gp
        slope_inputs = {"alpha": (x, go[0], args[3])}
    terms = {k: float((torch.where(v < 0, v.float(), 0.0) * gv.float()
                       ).abs().sum() / float(a))
             for k, (v, gv, a) in slope_inputs.items()}
    errs, mean_errs, slope_errs = {}, {}, {}
    for i, a, o, p in zip(present, gk, go, gp):
        check(a.shape == p.shape and bool(torch.isfinite(a.float()).all()),
              f"{name}: gradient of {names[i]} {tuple(a.shape)}")
        a, o, p = a.float(), o.float(), p.float()
        k = names[i]
        if k in terms:
            slope_errs[k] = dict(
                of_terms=float((a - o).abs()) / terms[k],
                relative=float((a - o).abs() / o.abs().clamp_min(1e-30)),
                relative_to_plain=float((a - p).abs()
                                        / p.abs().clamp_min(1e-30)),
                cancellation=terms[k] / max(float(o.abs()), 1e-30))
            continue
        errs[k] = float((a - o).abs().max() / o.abs().max().clamp_min(1e-30))
        mean_errs[k] = float((a - p).abs().mean()
                             / p.abs().mean().clamp_min(1e-30))
    ms = device_ms(torch, lambda: torch.autograd.grad(
        yk, wrt_k, dy, retain_graph=True), reps=10)
    plain_ms = device_ms(torch, lambda: torch.autograd.grad(
        yp, wrt_p, dy, retain_graph=True), reps=5)
    # the VJP's least work: dx and dW of each conv (two products of the
    # forward's size each); x and dy read once, dx and the residual's
    # gradient written once, each kernel read and its gradient written once
    nbytes = (2 * (2 * x.numel() + dy.numel()
                   + (res.numel() if with_res else 0))
              + 2 * 2 * n_convs * 9 * ci * co + 8 * co)
    b_ms, b_by = bound(nbytes, flops)
    rec = dict(case=name, kernel=kernel, shape=list(shape), co=co,
               stride=stride, backward="library VJP (aten "
               "convolution_backward, bf16)", norm_err=errs,
               norm_err_bound=BWD_TOL, mean_err_vs_plain=mean_errs,
               mean_err_bound=BWD_MEAN_TOL, slope_err=slope_errs,
               slope_err_bound=SLOPE_TOL, prelu1_mask_flips=flips, ms=ms,
               plain_ms=plain_ms, library_ms=ms, bound_ms=b_ms,
               bound_by=b_by, flops=flops, bytes=nbytes,
               roofline_share=b_ms / ms)
    print("case " + json.dumps(rec), flush=True)
    for k, e in errs.items():
        check(e <= BWD_TOL, f"{name}: gradient of {k} differs from the "
              f"plain version's by {e:.3e} > {BWD_TOL:.0e} of its maximum")
    for k, e in mean_errs.items():
        check(e <= BWD_MEAN_TOL, f"{name}: gradient of {k}: mean error "
              f"against the plain version {e:.3e} > {BWD_MEAN_TOL:.0e} of "
              f"its mean")
    for k, e in slope_errs.items():
        check(e["of_terms"] <= SLOPE_TOL, f"{name}: gradient of {k} "
              f"differs by {e['of_terms']:.3e} of the size of its terms "
              f"> {SLOPE_TOL:.1e}")
    return rec


# ---- phase 3: the serving slice --------------------------------------------

def random_flat_params(seed: int, n_channels: int = 8):
    """A flat flax-style weight map ("params/col_1/down_01/Conv_0/kernel")
    for the full-width GridNet, made with numpy from ``seed``:
    lecun-scaled kernels, small biases, PReLU slopes 0.25."""
    from video_layout_generation_tpu_torch.models import GridNet
    return _random_flat(GridNet(n_channels=n_channels,
                                filters_level=FILTERS), seed, gain=1.0)


def random_flat_relu_net(module, seed: int):
    """The same for a conv -> ReLU net (VGG19, HNED): He-scaled 3x3 kernels
    keep the activations' size through the trunk. HNED's 1x1 score kernels
    are scaled down by 50, so that the scores of its [0, 255]-ranged input
    are O(1) and the sigmoid edge maps do not saturate."""
    flat = _random_flat(module, seed, gain=2.0)
    for key in flat:
        if "/score" in key and key.endswith("kernel"):
            flat[key] = flat[key] * np.float32(0.02 / np.sqrt(2.0))
    return flat


def _random_flat(module, seed: int, gain: float):
    rng = np.random.default_rng(seed)
    flat = {}
    for key, t in sorted(module.state_dict().items()):
        shape = tuple(t.shape)
        if key.endswith("kernel"):
            v = rng.standard_normal(shape) * np.sqrt(
                gain / np.prod(shape[:3]))
        elif key.endswith("bias"):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = np.full(shape, 0.25)
        flat["params/" + key.replace(".", "/")] = v.astype(np.float32)
    return flat


def make_request(n: int, seed: int):
    """Blocky random frames and layouts (8x8-pixel cells) at 256x256."""
    rng = np.random.default_rng(seed)
    cells = (n, HW[0] // 8, HW[1] // 8)

    def up(a):
        return a.repeat(8, axis=1).repeat(8, axis=2)

    img1 = up(rng.random(cells + (3,))).astype(np.float32)
    img2 = np.clip(img1 + 0.05 * up(rng.standard_normal(cells + (3,))),
                   0, 1).astype(np.float32)
    seg1 = up(rng.integers(0, 20, cells))
    seg2 = seg1.copy()
    return img1, img2, seg1, seg2


def check_output(name, frames, layouts, n):
    check(frames.shape == (n, FRAMES) + HW + (3,),
          f"{name}: frames {frames.shape}")
    check(layouts.shape == (n, FRAMES) + HW, f"{name}: layouts "
          f"{layouts.shape}")
    check(bool(np.isfinite(frames).all()), f"{name}: non-finite frames")
    check(frames.min() >= 0.0 and frames.max() <= 1.0,
          f"{name}: frames outside [0, 1]")
    check(layouts.min() >= 0 and layouts.max() < 20,
          f"{name}: layout ids outside [0, 20)")


def counted_call(torch, kern, name, fn, expected):
    """Run ``fn`` and check the launches it made against ``expected``."""
    before = kern.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = kern.launch_counts()
    diff = {k: after[k] - before[k] for k in after}
    check(diff == expected, f"{name}: launches {diff}, expected {expected}")
    return out, diff


def run_slice(torch, kern, seed: int):
    from video_layout_generation_tpu_torch.serving import LayoutPredictor
    flat = random_flat_params(seed)
    kw = dict(n_frames=FRAMES, batch=BATCH, image_hw=HW,
              filters_level=FILTERS, use_bf16=True, device=DEVICE)
    pred = LayoutPredictor("GridNet", flat, **kw)
    req = make_request(BATCH, seed + 1)
    small = tuple(a[:5] for a in req)

    # the first request runs eagerly and is counted by the wrappers; the
    # second captures the rollout's CUDA graphs, and it and the third
    # replay them
    kern.reset_launch_counts()
    t0 = time.perf_counter()
    full, _ = counted_call(torch, kern, "full", lambda: pred.predict(*req),
                           LAUNCHES_PER_ROLLOUT)
    launches = kern.launch_counts()
    padded = pred.predict(*small)
    piped = list(pred.predict_pipelined([req]))[0]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    check(pred.rollouts == {"replayed": 2, "eager": 1, "captured": 1},
          f"slice: requests served {pred.rollouts}")
    check(pred.staging == {"staged": 3, "buffers": 1},
          f"slice: staging {pred.staging}")
    replayed = replayed_launches(torch, "slice", pred,
                                 lambda: pred.predict(*req),
                                 LAUNCHES_PER_ROLLOUT)
    print(f"slice: 3 requests in {main_s:.3f} s (eager, capture, replay); "
          f"launches of the eager request by the counters {launches}; of a "
          f"replayed request by the trace {replayed}; requests served "
          f"{pred.rollouts}, staging {pred.staging}", flush=True)

    check_output("full", *full, BATCH)
    check_output("padded", *padded, 5)
    check_output("pipelined", *piped, BATCH)
    check(np.array_equal(padded[0], full[0][:5])
          and np.array_equal(padded[1], full[1][:5]),
          "padded request differs from the full request's first 5")
    check(np.array_equal(piped[0], full[0])
          and np.array_equal(piped[1], full[1]),
          "pipelined request differs from predict")

    with kern.plain():
        ref = LayoutPredictor("GridNet", flat, **kw).predict(*req)
    agree, img_err = [], []
    for t in range(FRAMES):
        agree.append(float((full[1][:, t] == ref[1][:, t]).mean()))
        img_err.append(float(np.abs(full[0][:, t] - ref[0][:, t]).max()
                             / max(np.abs(ref[0][:, t]).max(), 1e-30)))
    print("slice vs plain: layout agreement per frame "
          + json.dumps(agree) + "; image normalized error per frame "
          + json.dumps(img_err), flush=True)
    check(img_err[0] <= IMG_MAX_TOL,
          f"step 1 image error {img_err[0]:.3e} > {IMG_MAX_TOL:.0e}")
    check(agree[0] >= 0.99, f"step 1 layout agreement {agree[0]:.4f} < 0.99")

    # rollout throughput at b16 and latency at b1 (host clock, upload to
    # fetch; every predict ends in a device->host copy)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.predict(*req)
        times.append(time.perf_counter() - t0)
    fps = BATCH * FRAMES / min(times)
    pred1 = LayoutPredictor("GridNet", flat, **dict(kw, batch=1))
    one = tuple(a[:1] for a in req)
    pred1.predict(*one)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred1.predict(*one)
        lat.append(time.perf_counter() - t0)
    print(f"slice timing: b{BATCH} predict times s {json.dumps(times)}; "
          f"rollout frames/s {fps:.1f}; b1 latency s median "
          f"{sorted(lat)[2]:.4f} all {json.dumps(lat)}", flush=True)
    profile_call("no-edge b16 request", lambda: pred.predict(*req))
    return launches, dict(fps=fps, b1_latency_s=sorted(lat)[2],
                          agreement=agree, img_err=img_err)


def kernels_on_card(torch, fn, calls: int = 4):
    """(name, launches a call) of every kernel and copy that one call of
    ``fn`` puts on the card, from a torch.profiler trace of ``calls`` calls;
    an incomplete trace is taken again, as in ``device_ms``, twice as many
    times since no other means counts launches on the card."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    for attempt in range(2 * TRACE_TRIES):
        retry_pause(attempt)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(ev.key, ev.count) for ev in prof.key_averages()
                if on_device(torch, ev)]
        if complete(rows, calls):
            return [(key, count // calls) for key, count in rows]
        print(f"kernels_on_card: incomplete trace {rows}, taking it again",
              flush=True)
    raise SmokeFailure(f"no complete profiler trace in {2 * TRACE_TRIES} "
                       f"tries")


# the kernel records of kernels A and B in a trace, by launch counter
CONV_KERNELS = {"prelu_conv3x3": "conv3x3_mma_kernel",
                "fused_lateral": "fused_lateral_mma_kernel"}


def replayed_launches(torch, name, pred, fn, expected) -> dict:
    """Kernel A's and B's launches on the card in one call of ``fn``, a
    request that ``pred`` serves by replaying its CUDA graphs, counted from
    the trace's kernel records (the wrappers count in Python, so a replay
    moves the counters only by the capture's count) and held against
    ``expected``."""
    before = dict(pred.rollouts)
    rows = kernels_on_card(torch, fn)
    check(pred.rollouts["eager"] == before["eager"]
          and pred.rollouts["captured"] == before["captured"],
          f"{name}: a traced request was not replayed: {pred.rollouts}")
    got = {k: sum(n for key, n in rows if sub in key)
           for k, sub in CONV_KERNELS.items()}
    want = {k: expected[k] for k in CONV_KERNELS}
    check(got == want, f"{name}: a replayed request launched {got} on the "
          f"card, expected {want}")
    return got


IN_KERNELS = ("instance_norm_fwd_kernel", "instance_norm_bwd_kernel")


def in_launches(per_step) -> tuple:
    """(forward, backward) InstanceNorm kernel launches of a step."""
    return per_step["instance_norm_fwd"], per_step["instance_norm_bwd"]


# (label, substrings of a kernel's name) for the device-time breakdown of a
# profiled call; the first label that matches takes the row
KERNEL_GROUPS = (
    ("kernel A", ("conv3x3_mma_kernel",)),
    ("kernel B", ("fused_lateral_mma_kernel",)),
    ("InstanceNorm", ("instance_norm_",)),
    ("SSIM", ("ssim_kernel",)),
    ("cuDNN backward", ("dgrad", "wgrad")),
    ("cuDNN forward", ("fprop",)),
    ("upsample", ("upsample",)),
)


def kernel_group(key: str) -> str:
    low = key.lower()
    for label, names in KERNEL_GROUPS:
        if any(n in low for n in names):
            return label
    return "other"


def profile_call(name, fn, in_launches=(0, 0)):
    """Device time by kernel over one call of ``fn`` (which must end in a
    fetch or a synchronize), and the device's busy time beside the call's
    wall time. Only rows of kernels and copies are summed (``on_device``),
    so that no device time is counted twice. A trace with no kernel, or
    with other counts of the InstanceNorm kernels than ``in_launches``
    (forward, backward), is taken again, as in ``device_ms``. Returns
    ``wall_ms``, ``busy_ms``, ``idle`` (share), the InstanceNorm kernels'
    device ms ``in_fwd`` and ``in_bwd``, and ``groups``: device ms by
    ``KERNEL_GROUPS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    for attempt in range(TRACE_TRIES):
        retry_pause(attempt)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        rows = []
        for ev in prof.key_averages():
            dev_us = ev.self_device_time_total
            if dev_us > 0 and on_device(torch, ev):
                rows.append((dev_us, ev.count, ev.key))
        seen = tuple(sum(r[1] for r in rows if k in r[2]) for k in IN_KERNELS)
        if rows and seen == tuple(in_launches):
            break
        print(f"profile [{name}]: incomplete trace ({len(rows)} kernels, "
              f"InstanceNorm launches {seen}), taking it again", flush=True)
    else:
        raise SmokeFailure(f"profile [{name}]: no complete trace in "
                           f"{TRACE_TRIES} tries")
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    groups = {}
    for dev_us, _, key in rows:
        label = kernel_group(key)
        groups[label] = groups.get(label, 0.0) + dev_us / 1e3
    print(f"profile [{name}]: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_s * 1e3:.1f} ms, idle share {1 - busy_s / wall:.3f}; "
          f"device ms by group " + json.dumps(groups), flush=True)
    # the 15 largest rows, and the SSIM and InstanceNorm kernels wherever
    # they rank
    small = ("ssim_", "instance_norm_")
    for dev_us, count, key in rows[:15] + [
            r for r in rows[15:] if any(k in r[2] for k in small)]:
        print(f"profile: {dev_us / 1e3:9.2f} ms {count:6d}x {key[:90]}",
              flush=True)
    in_fwd, in_bwd = (sum(r[0] for r in rows if k in r[2]) / 1e3
                      for k in IN_KERNELS)
    return dict(wall_ms=wall * 1e3, busy_ms=busy_s * 1e3,
                idle=1 - busy_s / wall, in_fwd=in_fwd, in_bwd=in_bwd,
                groups=groups)


# ---- phases 4 and 5: the edge-mode validation step and rollout ---------------

def edge_mode_weights(seed: int):
    """Flat flax-style weights of the three nets of the edge-mode path: the
    10-channel GridNet, HNED and VGG19 to relu4_4."""
    from video_layout_generation_tpu_torch.losses import VGG19Features
    from video_layout_generation_tpu_torch.models import HNED
    return dict(gridnet=random_flat_params(seed + 10, n_channels=10),
                hned=random_flat_relu_net(HNED(), seed + 11),
                vgg=random_flat_relu_net(VGG19Features(), seed + 12))


def make_packed_batch(n: int, seed: int):
    """One uint8 ``packed6`` batch (n, H, W, 12): three blocky frames that
    drift a little and three layouts."""
    img1, img2, seg1, seg2 = make_request(n, seed)
    rng = np.random.default_rng(seed + 1000)
    cells = (n, HW[0] // 8, HW[1] // 8)
    drift = rng.standard_normal(cells + (3,)).repeat(8, axis=1).repeat(
        8, axis=2)
    img3 = np.clip(img2 + 0.05 * drift, 0, 1)
    seg3 = np.where(rng.random(seg2.shape) < 0.9, seg2,
                    rng.integers(0, N_CLASSES, seg2.shape))
    frames = [(f * 255.0 + 0.5).astype(np.uint8) for f in (img1, img2, img3)]
    segs = [s.astype(np.uint8)[..., None] for s in (seg1, seg2, seg3)]
    return {"packed6": np.concatenate(frames + segs, axis=-1)}


def run_validation(torch, kern, weights, seed: int):
    from video_layout_generation_tpu_torch.io.weights import params_from_flax
    from video_layout_generation_tpu_torch.losses import CombinedLoss
    from video_layout_generation_tpu_torch.models import HNED, GridNet
    from video_layout_generation_tpu_torch.train.assemble import \
        normalize_model_output
    from video_layout_generation_tpu_torch.train.steps import (
        decode_batch, make_eval_step, prepare_inputs)
    from video_layout_generation_tpu_torch.train.trainer import validate
    dt = torch.bfloat16
    model = GridNet(n_channels=10, filters_level=FILTERS, dtype=dt)
    model.load_state_dict(params_from_flax(weights["gridnet"]), strict=True)
    hned = HNED(dtype=dt)
    hned.load_state_dict(params_from_flax(weights["hned"]), strict=True)
    # the nets are built on the CPU; make_eval_step moves them to the card,
    # and CombinedLoss.create picks bf16 there
    combined = CombinedLoss.create(params=weights["vgg"], device=DEVICE)
    step = make_eval_step(model, hned, combined, n_classes=N_CLASSES,
                          device=DEVICE)
    check(all(p.device.type == "cuda" for net in
              (model, hned, combined.vgg_model) for p in net.parameters()),
          "make_eval_step left a net off the card")
    batches = [make_packed_batch(BATCH, seed + 20 + i)
               for i in range(VAL_BATCHES)]
    first = {"cm_total": 0.0}

    def counted_step(batch):
        out, _ = counted_call(torch, kern, "eval step", lambda: step(batch),
                              LAUNCHES_PER_EVAL_STEP)
        first.setdefault("out", out)
        first["cm_total"] += float(out[0]["cm"].sum())
        return out

    kern.reset_launch_counts()
    t0 = time.perf_counter()
    result = validate(counted_step, batches, N_CLASSES)
    main_s = time.perf_counter() - t0
    launches = kern.launch_counts()
    print(f"validation: {VAL_BATCHES} batches of {BATCH} in {main_s:.3f} s; "
          f"launches per eval step {LAUNCHES_PER_EVAL_STEP}; total "
          f"{launches}", flush=True)

    n_px = VAL_BATCHES * BATCH * HW[0] * HW[1]
    check(np.isfinite(result["loss"]), f"validation loss {result['loss']}")
    check(0.0 <= result["miou"] <= 1.0 and 0.0 <= result["pixel_acc"] <= 1.0,
          f"validation scores {result['miou']}, {result['pixel_acc']}")
    check(result["per_class_iou"].shape == (N_CLASSES,), "per-class IoU shape")
    metrics, seg_ids, img_n = first["out"]
    check(tuple(seg_ids.shape) == (BATCH,) + HW
          and tuple(img_n.shape) == (BATCH,) + HW + (3,),
          f"eval step outputs {tuple(seg_ids.shape)} {tuple(img_n.shape)}")
    check(bool(torch.isfinite(img_n).all()), "eval step: non-finite frame")
    check(first["cm_total"] == n_px,
          f"confusion total {first['cm_total']} != {n_px}")

    with kern.plain():
        ref_metrics, ref_ids, ref_img = step(batches[0])
    terms = {}
    for k in ("loss", "loss_l1", "loss_style", "loss_seg"):
        a, b = float(metrics[k]), float(ref_metrics[k])
        terms[k] = dict(kernels=a, plain=b, rel_err=abs(a - b) / abs(b))
    agree = float((seg_ids == ref_ids).float().mean())
    diff = (img_n - ref_img).abs()
    top = ref_img.abs().max()
    img_err = float(diff.max() / top)
    img_share = float((diff <= IMG_MAX_TOL * top).float().mean())
    img_mean_err = float(diff.mean() / ref_img.abs().mean())
    # the cause of the end-to-end maximum, taken apart: HNED alone, then
    # GridNet alone on one shared, plain HNED edge map
    with torch.no_grad():
        batch0 = decode_batch({"packed6": torch.from_numpy(
            batches[0]["packed6"]).to(DEVICE)})
        edge_k = hned(batch0["img1"])[-1]
        with kern.plain():
            edge_err = float((edge_k - hned(batch0["img1"])[-1]).abs().max())
            x, _ = prepare_inputs(hned, batch0)
            seg_p, out_p = model(x)
        seg_k, out_k = model(x)
        out_k = normalize_model_output(out_k.float())
        out_p = normalize_model_output(out_p.float())
    shared_img_err = float((out_k - out_p).abs().max() / out_p.abs().max())
    shared_agree = float((seg_k.argmax(-1) == seg_p.argmax(-1)).float().mean())
    print("validation vs plain: " + json.dumps(terms) + f"; layout agreement "
          f"{agree:.5f}; image normalized error max {img_err:.4f} mean "
          f"{img_mean_err:.5f}, share within {IMG_MAX_TOL:.0e} "
          f"{img_share:.6f}; HNED edge map max abs error {edge_err:.4f}; "
          f"GridNet on one shared plain edge map: image normalized error max "
          f"{shared_img_err:.4f}, layout agreement {shared_agree:.5f}",
          flush=True)
    check(edge_err <= EDGE_MAP_TOL,
          f"HNED edge map error {edge_err:.3e} > {EDGE_MAP_TOL:.0e}")
    check(shared_img_err <= IMG_MAX_TOL,
          f"GridNet on shared edges: image error {shared_img_err:.3e} > "
          f"{IMG_MAX_TOL:.0e}")
    check(shared_agree >= 0.99,
          f"GridNet on shared edges: layout agreement {shared_agree:.4f}")
    check(img_share >= EDGE_IMG_SHARE,
          f"eval image: only {img_share:.6f} of the values within "
          f"{IMG_MAX_TOL:.0e} of the maximum")
    for k, v in terms.items():
        check(v["rel_err"] <= LOSS_TERM_RTOL,
              f"{k}: {v['kernels']} vs plain {v['plain']}, relative error "
              f"{v['rel_err']:.3e} > {LOSS_TERM_RTOL:.0e}")
    check(agree >= 0.99, f"eval layout agreement {agree:.4f} < 0.99")
    check(img_mean_err <= EDGE_IMG_MEAN_TOL,
          f"eval mean image error {img_mean_err:.3e} > "
          f"{EDGE_IMG_MEAN_TOL:.0e}")

    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = validate(step, batches, N_CLASSES)   # ends in a fetch
        times.append(time.perf_counter() - t0)
    check(again["loss"] == result["loss"],
          f"validation is not repeatable: {again['loss']} {result['loss']}")
    sps = VAL_BATCHES * BATCH / min(times)
    print(f"validation timing: {VAL_BATCHES} x b{BATCH} times s "
          f"{json.dumps(times)}; validation samples/s {sps:.1f}; loss "
          f"{result['loss']:.4f} mIoU {result['miou']:.4f} pixAcc "
          f"{result['pixel_acc']:.4f}", flush=True)

    def one_step():
        float(step(batches[0])[0]["loss"])

    profile_call("eval step b16", one_step)
    return launches, dict(samples_per_s=sps, terms=terms, agreement=agree,
                          loss=result["loss"])


def run_edge_rollout(torch, kern, weights, seed: int):
    from video_layout_generation_tpu_torch.models import HNED
    from video_layout_generation_tpu_torch.serving import LayoutPredictor
    kw = dict(n_frames=FRAMES, batch=BATCH, image_hw=HW,
              filters_level=FILTERS, use_bf16=True, device=DEVICE,
              use_edges=True, hned_params=weights["hned"])

    def predictor(**over):
        return LayoutPredictor("GridNet", weights["gridnet"],
                               hned=HNED(dtype=torch.bfloat16),
                               **dict(kw, **over))

    pred = predictor()
    req = make_request(BATCH, seed + 31)
    small = tuple(a[:5] for a in req)

    # eager, then the capture and its replay, as in the slice
    kern.reset_launch_counts()
    t0 = time.perf_counter()
    full, _ = counted_call(torch, kern, "edge full",
                           lambda: pred.predict(*req),
                           LAUNCHES_PER_EDGE_ROLLOUT)
    launches = kern.launch_counts()
    padded = pred.predict(*small)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    check(pred.rollouts == {"replayed": 1, "eager": 1, "captured": 1},
          f"edge rollout: requests served {pred.rollouts}")
    check(pred.staging == {"staged": 2, "buffers": 1},
          f"edge rollout: staging {pred.staging}")
    replayed = replayed_launches(torch, "edge rollout", pred,
                                 lambda: pred.predict(*req),
                                 LAUNCHES_PER_EDGE_ROLLOUT)
    print(f"edge rollout: 2 requests in {main_s:.3f} s (eager, capture); "
          f"launches of the eager request by the counters {launches}; of a "
          f"replayed request by the trace {replayed}; requests served "
          f"{pred.rollouts}, staging {pred.staging}", flush=True)
    check_output("edge full", *full, BATCH)
    check_output("edge padded", *padded, 5)
    check(np.array_equal(padded[0], full[0][:5])
          and np.array_equal(padded[1], full[1][:5]),
          "padded edge request differs from the full request's first 5")

    with kern.plain():
        ref = predictor().predict(*req)
    agree, img_err, img_mean_err, img_share = [], [], [], []
    for t in range(FRAMES):
        agree.append(float((full[1][:, t] == ref[1][:, t]).mean()))
        diff = np.abs(full[0][:, t] - ref[0][:, t])
        top = max(np.abs(ref[0][:, t]).max(), 1e-30)
        img_err.append(float(diff.max() / top))
        img_share.append(float((diff <= IMG_MAX_TOL * top).mean()))
        img_mean_err.append(float(diff.mean()
                                  / max(np.abs(ref[0][:, t]).mean(), 1e-30)))
    print("edge rollout vs plain: layout agreement per frame "
          + json.dumps(agree) + "; image normalized error per frame max "
          + json.dumps(img_err) + " mean " + json.dumps(img_mean_err)
          + f" share within {IMG_MAX_TOL:.0e} " + json.dumps(img_share),
          flush=True)
    check(img_share[0] >= EDGE_IMG_SHARE,
          f"edge step 1: only {img_share[0]:.6f} of the image values within "
          f"{IMG_MAX_TOL:.0e} of the maximum")
    check(img_mean_err[0] <= EDGE_IMG_MEAN_TOL,
          f"edge step 1 mean image error {img_mean_err[0]:.3e} > "
          f"{EDGE_IMG_MEAN_TOL:.0e}")
    check(agree[0] >= 0.99,
          f"edge step 1 layout agreement {agree[0]:.4f} < 0.99")

    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        pred.predict(*req)
        times.append(time.perf_counter() - t0)
    fps = BATCH * FRAMES / min(times)
    pred1 = predictor(batch=1)
    one = tuple(a[:1] for a in req)
    pred1.predict(*one)
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred1.predict(*one)
        lat.append(time.perf_counter() - t0)
    print(f"edge rollout timing: b{BATCH} predict times s "
          f"{json.dumps(times)}; edge rollout frames/s {fps:.1f}; b1 latency "
          f"s median {sorted(lat)[1]:.4f} all {json.dumps(lat)}", flush=True)
    profile_call("edge b16 request", lambda: pred.predict(*req))
    return launches, dict(fps=fps, b1_latency_s=sorted(lat)[1],
                          agreement=agree, img_err=img_err)


# ---- phases 6-8: training the pix2pix ResnetGenerator ----------------------
#
# How a step through the kernels is held against the plain versions. The
# full-depth generator with random weights amplifies a small difference: on
# an H100, moving only its two edge channels by HNED's kernel-vs-plain
# difference (at most 0.009 of a [0, 1] range) moves its output by 9% of the
# maximum and the first conv's gradient by 26%; even with f32 activations,
# where every InstanceNorm launch agrees with an f64 reference to 2e-7 on
# its own tensors, the first conv's gradient differs by 4% between the two
# paths. So a step through the kernels cannot agree with the plain step to
# a few percent in its gradients, whatever the kernels do, and the
# comparison is taken apart:
#   - every InstanceNorm call of one step is watched: its input and the
#     gradient that reaches its output are kept, and the forward and the
#     backward kernel are held against the plain version on those very
#     tensors (IN_BF16_TOL): local, so nothing is amplified;
#   - kernel A's data gradient alone: VGG19 through kernel A, everything
#     else plain, gradients within GRAD_TOL of the plain step;
#   - end to end: the loss terms within LOSS_TERM_RTOL, and every gradient
#     within GRAD_E2E_TOL in the L2 norm, which a wrong sign, a dropped term
#     or a factor of 2 would not pass.

def pix2pix_weights(seed: int):
    """Flat flax-style weights of the full-width ResnetGenerator and
    NLayerDiscriminator (He-scaled kernels, small biases)."""
    from video_layout_generation_tpu_torch.models import (
        NLayerDiscriminator, ResnetGenerator)
    return dict(
        gen=_random_flat(ResnetGenerator(input_nc=10, ngf=NGF,
                                         n_blocks=N_BLOCKS), seed + 40, 2.0),
        disc=_random_flat(NLayerDiscriminator(9, NDF, n_layers=3),
                          seed + 41, 2.0))


def build_pix2pix(torch, weights, with_disc: bool, vgg_kernels=False):
    """(generator, discriminator or None, HNED, CombinedLoss), bf16
    activations, weights through the bridge. ``vgg_kernels`` runs the loss
    under ``kernels.plain(False)``: its VGG19 trunk on kernel A inside a
    step under ``kernels.plain()``, forward and data gradient (the data
    gradient's Function keeps its forward's route in the backward). The
    nets are built on the CPU; the step factories move them to the card."""
    from video_layout_generation_tpu_torch.io.weights import params_from_flax
    from video_layout_generation_tpu_torch.losses import CombinedLoss
    from video_layout_generation_tpu_torch.models import (
        HNED, NLayerDiscriminator, ResnetGenerator)
    from video_layout_generation_tpu_torch.ops import kernels

    class PinnedLoss:
        def __init__(self, inner):
            self.inner, self.vgg_model = inner, inner.vgg_model

        def __call__(self, output, target):
            with kernels.plain(False):
                return self.inner(output, target)

    dt = torch.bfloat16
    gen = ResnetGenerator(input_nc=10, ngf=NGF, n_blocks=N_BLOCKS,
                          norm="instance", dtype=dt)
    gen.load_state_dict(params_from_flax(weights["gen"]), strict=True)
    disc = None
    if with_disc:
        disc = NLayerDiscriminator(9, NDF, n_layers=3, norm="instance",
                                   dtype=dt)
        disc.load_state_dict(params_from_flax(weights["disc"]), strict=True)
    hned = HNED(dtype=dt)
    hned.load_state_dict(params_from_flax(weights["hned"]), strict=True)
    combined = CombinedLoss.create(params=weights["vgg"], device=DEVICE)
    if vgg_kernels:
        combined = PinnedLoss(combined)
    return gen, disc, hned, combined


def watch_instance_norms(nets):
    """Forward hooks on every InstanceNorm of ``nets`` that keep each call's
    input and, where one arrives, the gradient that reaches its output.
    Returns (calls, handles); remove the handles when done."""
    from video_layout_generation_tpu_torch.models.norms import InstanceNorm
    calls, handles = [], []

    def hook(module, args, output):
        call = {"x": args[0].detach()}
        if output.requires_grad:
            output.register_hook(
                lambda g: call.__setitem__("dy", g.detach()))
        calls.append(call)

    for net in nets:
        for m in net.modules():
            if isinstance(m, InstanceNorm):
                handles.append(m.register_forward_hook(hook))
    return calls, handles


def check_watched_calls(torch, kern, name, calls, expect_calls, backward):
    """Every watched InstanceNorm call again, on its own tensors: the kernel
    against the plain version, forward and (with ``backward``) backward.
    Returns the largest normalized errors."""
    mod = kern.instance_norm
    check(len(calls) == expect_calls,
          f"{name}: {len(calls)} InstanceNorm calls, expected {expect_calls}")
    worst = {"fwd": 0.0, "bwd": 0.0}
    for i, call in enumerate(calls):
        x = call["x"]
        pairs = []
        if backward:
            check("dy" in call, f"{name}: no gradient reached InstanceNorm "
                  f"call {i}")
            dy = call["dy"].contiguous()
            xk = x.clone().requires_grad_(True)
            xp = x.clone().requires_grad_(True)
            yk = mod.instance_norm(xk)
            yp = mod.instance_norm_plain(xp)
            pairs.append(("bwd", torch.autograd.grad(yk, xk, dy)[0],
                          torch.autograd.grad(yp, xp, dy)[0]))
        else:
            with torch.no_grad():
                yk, yp = mod.instance_norm(x), mod.instance_norm_plain(x)
        pairs.append(("fwd", yk.detach(), yp.detach()))
        for kind, got, want in pairs:
            err = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max().clamp_min(1e-30))
            worst[kind] = max(worst[kind], err)
            check(err <= IN_BF16_TOL, f"{name}: InstanceNorm call {i} "
                  f"{tuple(x.shape)} {kind}: normalized error {err:.3e} > "
                  f"{IN_BF16_TOL:.0e}")
    return worst


def recording_state(model, tx):
    """A TrainState that keeps a copy of the last gradients it applied, so
    that the gradients of a step through the entry point can be read."""
    from video_layout_generation_tpu_torch.train.state import TrainState

    class RecordingState(TrainState):
        def apply_gradients(self, grads):
            self.last_grads = {k: g.detach().clone() for k, g in grads.items()}
            return super().apply_gradients(grads)

    base = TrainState.create(model, tx)
    return RecordingState(base.params, base.opt_state, base.tx, base.step,
                          base.module)


def adam():
    from video_layout_generation_tpu_torch.train.state import make_optimizer
    return make_optimizer("adam", 2e-4, 0.5)


def dead_biases(model, norm_followed):
    """Names of the conv biases that an InstanceNorm follows directly: their
    gradient is zero in exact arithmetic and rounding noise otherwise."""
    return {k for k in dict(model.named_parameters())
            if k.endswith(".bias") and norm_followed(k)}


def gen_dead_biases(gen):
    return dead_biases(gen, lambda k: not k.startswith("last_conv"))


def disc_dead_biases(disc):
    return dead_biases(disc, lambda k: k.split(".")[0] in (
        "Conv_1", "Conv_2", "Conv_3"))


def grad_errors(torch, name, got, want, dead):
    """Over the parameter tensors, the largest max-norm error (max |got -
    want| over max |want|) and the largest L2 error (|got - want| over
    |want|), each with its tensor. A dead bias is left out: both of its
    gradients are rounding noise."""
    worst_max, worst_l2 = (-1.0, ""), (-1.0, "")
    for k, gw in want.items():
        gk = got[k]
        check(bool(torch.isfinite(gk).all()),
              f"{name}: non-finite gradient of {k}")
        if k in dead:
            continue
        d = (gk - gw).float()
        worst_max = max(worst_max, (float(d.abs().max())
                                    / max(float(gw.abs().max()), 1e-30), k))
        worst_l2 = max(worst_l2, (float(d.norm())
                                  / max(float(gw.float().norm()), 1e-30), k))
    return dict(max=worst_max[0], max_at=worst_max[1], l2=worst_l2[0],
                l2_at=worst_l2[1])


def compare_terms(name, metrics, ref_metrics, keys, rtol=LOSS_TERM_RTOL):
    terms = {}
    for k in keys:
        a, b = float(metrics[k]), float(ref_metrics[k])
        check(np.isfinite(a), f"{name}: {k} is {a}")
        terms[k] = dict(kernels=a, plain=b,
                        rel_err=abs(a - b) / max(abs(b), 1e-30))
        check(terms[k]["rel_err"] <= rtol,
              f"{name}: {k} {a} vs plain {b}: relative error "
              f"{terms[k]['rel_err']:.3e} > {rtol:.0e}")
    return terms


def check_moved(torch, name, before, model, skip):
    still = [k for k, p in model.named_parameters()
             if k not in skip and bool(torch.equal(p.detach(), before[k]))]
    check(not still, f"{name}: parameters that did not move: {still[:5]}")


def snapshot(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def timed_steps(torch, step, state, batches, n=3):
    """Host-clock times of ``n`` steps, each ending in a fetch."""
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, batches[i % len(batches)])
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    return times


TRAIN_TERMS = ("loss", "loss_l1", "loss_style", "loss_seg")
GAN_TERMS = TRAIN_TERMS + ("loss_gan", "loss_d", "loss_d_fake", "loss_d_real")


def one_train_step(torch, kern, weights, batch, seed, vgg_kernels=False):
    """Step 1 of a fresh generator through ``make_train_step`` under
    ``kernels.plain()`` (with ``vgg_kernels`` its VGG19 trunk on kernel A,
    ``build_pix2pix``): its metrics, the gradients it applied and the
    launches it made, forward and backward."""
    from video_layout_generation_tpu_torch.train.steps import make_train_step
    gen, _, hned, combined = build_pix2pix(torch, weights, False, vgg_kernels)
    step = make_train_step(
        gen, hned, combined, flip_mode="batch", device=DEVICE,
        generator=torch.Generator().manual_seed(seed + 50))
    state = recording_state(gen, adam())
    name = "train step 1, " + ("VGG19 through kernel A" if vgg_kernels
                               else "plain")
    with kern.plain():
        (_, metrics), moved = counted_call(
            torch, kern, name, lambda: step(state, batch),
            LAUNCHES_VGG_PINNED_STEP if vgg_kernels else NO_LAUNCHES)
    return metrics, state.last_grads, moved


def run_train(torch, kern, weights, seed: int):
    from video_layout_generation_tpu_torch.train.steps import make_train_step
    gen, _, hned, combined = build_pix2pix(torch, weights, False)
    step = make_train_step(
        gen, hned, combined, flip_mode="batch", device=DEVICE,
        generator=torch.Generator().manual_seed(seed + 50))
    state = recording_state(gen, adam())
    check(all(p.device.type == torch.device(DEVICE).type
              and p.dtype == torch.float32 for p in gen.parameters()),
          "make_train_step left the generator off the device, or not f32")
    batches = [make_packed_batch(BATCH, seed + 60 + i)
               for i in range(TRAIN_STEPS)]
    start = snapshot(gen)

    kern.reset_launch_counts()
    t0 = time.perf_counter()
    history, first_grads = [], None
    for i, batch in enumerate(batches):
        (_, metrics), _ = counted_call(
            torch, kern, f"train step {i + 1}",
            lambda: step(state, batch), LAUNCHES_PER_TRAIN_STEP)
        history.append({k: float(v) for k, v in metrics.items()})
        if first_grads is None:
            first_grads, first_metrics = state.last_grads, metrics
    main_s = time.perf_counter() - t0
    launches = kern.launch_counts()
    print(f"train: {TRAIN_STEPS} steps of b{BATCH} in {main_s:.3f} s; "
          f"launches per step {LAUNCHES_PER_TRAIN_STEP}; total {launches}; "
          f"losses {json.dumps(history)}", flush=True)
    check(state.step == TRAIN_STEPS, f"train: step counter {state.step}")
    for m in history:
        check(all(np.isfinite(v) for v in m.values()), f"train: loss {m}")
    dead = gen_dead_biases(gen)
    check_moved(torch, "train", start, gen, dead)

    # end to end in bf16 against the plain step
    ref_metrics, ref_grads, _ = one_train_step(torch, kern, weights,
                                               batches[0], seed)
    terms = compare_terms("train step 1", first_metrics, ref_metrics,
                          TRAIN_TERMS)
    e2e = grad_errors(torch, "train step 1", first_grads, ref_grads, dead)
    # kernel A's data gradient alone: VGG19 through A, the rest plain
    _, vgg_grads, vgg_launches = one_train_step(torch, kern, weights,
                                                batches[0], seed,
                                                vgg_kernels=True)
    vgg = grad_errors(torch, "train step 1, VGG19 through kernel A",
                      vgg_grads, ref_grads, dead)
    del ref_grads, vgg_grads
    # every InstanceNorm call of one more step, on its own tensors
    calls, handles = watch_instance_norms([gen])
    step(state, batches[0])
    for h in handles:
        h.remove()
    local = check_watched_calls(torch, kern, "train step", calls,
                                IN_PER_GEN, backward=True)
    del calls
    print("train step 1 vs plain: " + json.dumps(terms) + "; gradients of "
          f"{len(first_grads) - len(dead)} tensors ({len(dead)} biases before "
          "an InstanceNorm left out): end to end " + json.dumps(e2e)
          + "; VGG19 through kernel A alone " + json.dumps(vgg)
          + f", its step's launches {json.dumps(vgg_launches)}"
          + f"; the {IN_PER_GEN} InstanceNorm calls of a step on their own "
          "tensors, kernel vs plain, largest normalized error "
          + json.dumps(local), flush=True)
    check(e2e["l2"] <= GRAD_E2E_TOL, f"train step 1: gradient of "
          f"{e2e['l2_at']} differs from the plain step by {e2e['l2']:.3e} "
          f"> {GRAD_E2E_TOL} in the L2 norm")
    check(vgg["max"] <= GRAD_TOL, f"train step 1, VGG19 through kernel A: "
          f"gradient of {vgg['max_at']} differs by {vgg['max']:.3e} > "
          f"{GRAD_TOL:.0e}")

    times = timed_steps(torch, step, state, batches)
    sps = BATCH / min(times)
    torch.cuda.reset_peak_memory_stats()
    prof = profile_call(
        "train step b16", lambda: float(step(state, batches[0])[1]["loss"]),
        in_launches=in_launches(LAUNCHES_PER_TRAIN_STEP))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    in_fwd, in_bwd = prof["in_fwd"], prof["in_bwd"]
    print(f"train timing: b{BATCH} step times s {json.dumps(times)}; train "
          f"samples/s {sps:.1f}; peak memory of one step {peak:.2f} GiB; "
          f"InstanceNorm device ms per step {in_fwd + in_bwd:.4f} (forward "
          f"{in_fwd:.4f}, backward {in_bwd:.4f})", flush=True)
    return launches, dict(samples_per_s=sps, terms=terms, grad_err=e2e,
                          losses=history, wall_ms=prof["wall_ms"],
                          busy_ms=prof["busy_ms"], idle=prof["idle"],
                          peak_gib=peak)


def build_gan(torch, weights, seed, gan_mode="lsgan"):
    from video_layout_generation_tpu_torch.train.gan import (
        GanTrainState, make_gan_train_step)
    gen, disc, hned, combined = build_pix2pix(torch, weights, True)
    step = make_gan_train_step(
        gen, disc, hned, combined, gan_mode=gan_mode, flip_mode="batch",
        device=DEVICE,
        generator=torch.Generator().manual_seed(seed + 70),
        gp_generator=torch.Generator(device=DEVICE).manual_seed(seed + 71))
    state = GanTrainState(gen=recording_state(gen, adam()),
                          disc=recording_state(disc, adam()))
    return gen, disc, step, state


def run_gan(torch, kern, weights, seed: int):
    gen, disc, step, state = build_gan(torch, weights, seed)
    batches = [make_packed_batch(BATCH, seed + 80 + i)
               for i in range(GAN_STEPS)]
    start_g, start_d = snapshot(gen), snapshot(disc)

    kern.reset_launch_counts()
    t0 = time.perf_counter()
    history, first = [], None
    for i, batch in enumerate(batches):
        (_, metrics), _ = counted_call(
            torch, kern, f"GAN step {i + 1}", lambda: step(state, batch),
            LAUNCHES_PER_GAN_STEP)
        history.append({k: float(v) for k, v in metrics.items()})
        if first is None:
            first = (metrics, state.gen.last_grads, state.disc.last_grads)
    main_s = time.perf_counter() - t0
    launches = kern.launch_counts()
    print(f"GAN train: {GAN_STEPS} steps of b{BATCH} in {main_s:.3f} s; "
          f"launches per step {LAUNCHES_PER_GAN_STEP}; total {launches}; "
          f"losses {json.dumps(history)}", flush=True)
    check(state.step == GAN_STEPS and state.disc.step == GAN_STEPS,
          f"GAN train: step counters {state.step}, {state.disc.step}")
    for m in history:
        check(all(np.isfinite(v) for v in m.values()), f"GAN train: loss {m}")
    dead_g, dead_d = gen_dead_biases(gen), disc_dead_biases(disc)
    check_moved(torch, "GAN train, generator", start_g, gen, dead_g)
    check_moved(torch, "GAN train, discriminator", start_d, disc, dead_d)

    _, _, ref_step, ref_state = build_gan(torch, weights, seed)
    with kern.plain():
        _, ref_metrics = ref_step(ref_state, batches[0])
    ref = (ref_metrics, ref_state.gen.last_grads, ref_state.disc.last_grads)
    del ref_step, ref_state
    terms = compare_terms("GAN step 1", first[0], ref[0], GAN_TERMS)
    e2e_g = grad_errors(torch, "GAN step 1, generator", first[1], ref[1],
                        dead_g)
    e2e_d = grad_errors(torch, "GAN step 1, discriminator", first[2], ref[2],
                        dead_d)
    del ref
    calls, handles = watch_instance_norms([gen, disc])
    step(state, batches[0])
    for h in handles:
        h.remove()
    local = check_watched_calls(torch, kern, "GAN step", calls,
                                IN_PER_GEN + 3 * IN_PER_DISC, backward=True)
    del calls
    print("GAN step 1 vs plain: " + json.dumps(terms) + "; gradients end to "
          "end: generator " + json.dumps(e2e_g) + ", discriminator "
          + json.dumps(e2e_d) + f"; the {IN_PER_GEN + 3 * IN_PER_DISC} "
          "InstanceNorm calls of a step on their own tensors, kernel vs "
          "plain, largest normalized error " + json.dumps(local), flush=True)
    for net, e2e in (("generator", e2e_g), ("discriminator", e2e_d)):
        check(e2e["l2"] <= GRAD_E2E_TOL, f"GAN step 1, {net}: gradient of "
              f"{e2e['l2_at']} differs from the plain step by "
              f"{e2e['l2']:.3e} > {GRAD_E2E_TOL} in the L2 norm")

    times = timed_steps(torch, step, state, batches)
    sps = BATCH / min(times)
    prof = profile_call(
        "GAN step b16", lambda: float(step(state, batches[0])[1]["loss"]),
        in_launches=in_launches(LAUNCHES_PER_GAN_STEP))
    in_fwd, in_bwd = prof["in_fwd"], prof["in_bwd"]
    print(f"GAN train timing: b{BATCH} step times s {json.dumps(times)}; GAN "
          f"train samples/s {sps:.1f}; InstanceNorm device ms per step "
          f"{in_fwd + in_bwd:.4f} (forward {in_fwd:.4f}, backward "
          f"{in_bwd:.4f})", flush=True)

    # one WGAN-GP step: the penalty differentiates the critic's input
    # gradient, so it runs the InstanceNorm backward's own backward
    _, _, gp_step, gp_state = build_gan(torch, weights, seed, "wgangp")
    before = kern.launch_counts()
    _, m = gp_step(gp_state, make_packed_batch(WGANGP_BATCH, seed + 90))
    torch.cuda.synchronize()
    after = kern.launch_counts()
    pen = float(m["loss_d"]) - 0.5 * (float(m["loss_d_fake"])
                                      + float(m["loss_d_real"]))
    print(f"wgangp step at b{WGANGP_BATCH}: "
          + json.dumps({k: float(v) for k, v in m.items()})
          + f"; gradient penalty {pen:.6f}; launches "
          + json.dumps({k: after[k] - before[k] for k in after}),
          flush=True)
    check(all(np.isfinite(float(v)) for v in m.values()),
          "wgangp step: non-finite loss")
    check(np.isfinite(pen) and pen > 0.0,
          f"wgangp step: gradient penalty {pen}")
    return launches, dict(samples_per_s=sps, terms=terms,
                          grad_err=dict(gen=e2e_g, disc=e2e_d),
                          losses=history)


def run_resnet_validation(torch, kern, weights, seed: int):
    from video_layout_generation_tpu_torch.train.steps import make_eval_step
    gen, _, hned, combined = build_pix2pix(torch, weights, False)
    step = make_eval_step(gen, hned, combined, n_classes=N_CLASSES,
                          device=DEVICE)
    batch = make_packed_batch(BATCH, seed + 95)
    kern.reset_launch_counts()
    (metrics, seg_ids, img_n), _ = counted_call(
        torch, kern, "ResnetGenerator eval step", lambda: step(batch),
        LAUNCHES_PER_RESNET_EVAL_STEP)
    launches = kern.launch_counts()
    check(tuple(seg_ids.shape) == (BATCH,) + HW
          and tuple(img_n.shape) == (BATCH,) + HW + (3,),
          f"ResnetGenerator eval outputs {tuple(seg_ids.shape)} "
          f"{tuple(img_n.shape)}")
    check(bool(torch.isfinite(img_n).all()), "ResnetGenerator eval: "
          "non-finite frame")
    check(float(metrics["cm"].sum()) == BATCH * HW[0] * HW[1],
          "ResnetGenerator eval: confusion total")
    with kern.plain():
        ref_metrics, ref_ids, ref_img = step(batch)
    terms = compare_terms("ResnetGenerator eval step", metrics, ref_metrics,
                          TRAIN_TERMS)
    agree = float((seg_ids == ref_ids).float().mean())
    img_err = float((img_n - ref_img).abs().max() / ref_img.abs().max())
    calls, handles = watch_instance_norms([gen])
    step(batch)
    for h in handles:
        h.remove()
    local = check_watched_calls(torch, kern, "ResnetGenerator eval step",
                                calls, IN_PER_GEN, backward=False)
    print(f"ResnetGenerator validation: launches per eval step "
          f"{LAUNCHES_PER_RESNET_EVAL_STEP}; vs plain: " + json.dumps(terms)
          + f"; layout agreement {agree:.5f}, image normalized error max "
          f"{img_err:.4f}; the {IN_PER_GEN} forward-only InstanceNorm calls "
          f"on their own tensors, kernel vs plain, largest normalized error "
          f"{local['fwd']:.5f}", flush=True)
    check(agree >= RESNET_AGREEMENT,
          f"ResnetGenerator eval layout agreement {agree:.4f} < "
          f"{RESNET_AGREEMENT}")
    return launches, dict(terms=terms, agreement=agree)


# ---- phases 9 and 10: training GridNet and CoordGridNet ---------------------
#
# The JAX package's default configuration: CoordGridNet, 10 channels in,
# filters 32/64/96, bf16 activations, f32 parameters and Adam(2e-4, 0.5)
# state; here also the plain GridNet on the trained flagship_096 snapshot,
# read with numpy through the weight bridge (the first agreement with
# trained weights on the card). GridNet's forward is kernels A and B; their
# backward is the library's VJP (cuDNN, bf16), which launches neither.

def flagship_flat():
    """The committed flagship_096 snapshot (10-channel GridNet at full
    width, ``params/...`` keys) as a dict of numpy arrays."""
    with np.load(FLAGSHIP) as snap:
        return {k: snap[k] for k in snap.files}


def gridnet_train_weights(seed: int) -> dict:
    """The two trained nets' weights: GridNet from the snapshot,
    CoordGridNet made with numpy from ``seed``."""
    from video_layout_generation_tpu_torch.models import CoordGridNet
    return {"GridNet": flagship_flat(),
            "CoordGridNet": _random_flat(
                CoordGridNet(n_channels=10, filters_level=FILTERS),
                seed + 110, gain=1.0)}


def build_gridnet(torch, arch, flat):
    from video_layout_generation_tpu_torch.io.weights import params_from_flax
    from video_layout_generation_tpu_torch.models import get_model_cls
    net = get_model_cls(arch)(n_channels=10, filters_level=FILTERS,
                              dtype=torch.bfloat16)
    net.load_state_dict(params_from_flax(flat), strict=True)
    return net


def frozen_nets(torch, weights):
    """(HNED, CombinedLoss) of the training paths, bf16, from the seeded
    weights; the step factories move them to the card."""
    from video_layout_generation_tpu_torch.io.weights import params_from_flax
    from video_layout_generation_tpu_torch.losses import CombinedLoss
    from video_layout_generation_tpu_torch.models import HNED
    hned = HNED(dtype=torch.bfloat16)
    hned.load_state_dict(params_from_flax(weights["hned"]), strict=True)
    return hned, CombinedLoss.create(params=weights["vgg"], device=DEVICE)


def gridnet_step(torch, weights, flat, arch, seed):
    """(net, step, state) of ``make_train_step`` on a fresh net."""
    from video_layout_generation_tpu_torch.train.steps import make_train_step
    net = build_gridnet(torch, arch, flat)
    hned, combined = frozen_nets(torch, weights)
    step = make_train_step(
        net, hned, combined, flip_mode="batch", device=DEVICE,
        generator=torch.Generator().manual_seed(seed + 120))
    return net, step, recording_state(net, adam())


def slopes_as_one(torch, grads):
    """The gradients with GridNet's 60 scalar PReLU slopes stacked into one
    vector ``"PReLU slopes"``: each slope's gradient is one sum over a whole
    activation, some with heavy cancellation (a sum 1e4 times smaller than
    the sum of its terms' sizes, seen at 32x32 on the CPU), so that bf16's
    rounding of the terms moves it by more than its own size. As one tensor
    each slope's error counts against the size of all of them."""
    slopes = sorted(k for k in grads if k.endswith(".alpha"))
    out = {k: v for k, v in grads.items() if k not in slopes}
    out["PReLU slopes"] = torch.stack([grads[k].reshape(()) for k in slopes])
    return out


def per_tensor_l2(torch, got, want):
    """|got - want| / |want| in L2 for every tensor, by name."""
    return {k: float((got[k] - w).float().norm()
                     / max(float(w.float().norm()), 1e-30))
            for k, w in want.items()}


def run_gridnet_train(torch, kern, weights, train_flats, seed: int):
    """``TRAIN_STEPS`` steps of GridNet (flagship) and of CoordGridNet
    (seeded) at b16 with the launch counts of every step, then each one's
    step 1 against the plain step, timings, a profile, and one b32 step."""
    batches = [make_packed_batch(BATCH, seed + 130 + i)
               for i in range(TRAIN_STEPS)]
    runs = {}
    kern.reset_launch_counts()
    for arch, flat in train_flats.items():
        net, step, state = gridnet_step(torch, weights, flat, arch, seed)
        check(all(p.device.type == torch.device(DEVICE).type
                  and p.dtype == torch.float32 for p in net.parameters()),
              f"{arch}: make_train_step left the net off the device, or "
              f"not f32")
        start = snapshot(net)
        history, packs, first = [], [], None
        for i, batch in enumerate(batches):
            (_, metrics), _ = counted_call(
                torch, kern, f"{arch} train step {i + 1}",
                lambda: step(state, batch), LAUNCHES_PER_GRIDNET_TRAIN_STEP)
            history.append({k: float(v) for k, v in metrics.items()})
            packs.append(len(kern.conv3x3._PACKS))
            if first is None:
                first = (metrics, state.last_grads)
        check(state.step == TRAIN_STEPS, f"{arch}: step counter {state.step}")
        for m in history:
            check(all(np.isfinite(v) for v in m.values()),
                  f"{arch} train: loss {m}")
        check_moved(torch, f"{arch} train", start, net, set())
        check(packs[0] == packs[-1], f"{arch}: the weight-pack cache grew "
              f"over the steps: {packs}")
        runs[arch] = dict(net=net, step=step, state=state, first=first,
                          history=history, packs=packs)
    launches = kern.launch_counts()
    print(f"GridNet train: {TRAIN_STEPS} steps of b{BATCH} each of "
          f"{list(train_flats)}; launches per step "
          f"{LAUNCHES_PER_GRIDNET_TRAIN_STEP}; total {launches}; losses "
          + json.dumps({a: r["history"] for a, r in runs.items()})
          + "; weight-pack cache entries after each step "
          + json.dumps({a: r["packs"] for a, r in runs.items()}), flush=True)

    stats = {}
    for arch, r in runs.items():
        _, ref_step, ref_state = gridnet_step(
            torch, weights, train_flats[arch], arch, seed)
        with kern.plain():
            _, ref_metrics = ref_step(ref_state, batches[0])
        ref_grads = ref_state.last_grads
        del ref_step, ref_state
        metrics, grads = r["first"]
        terms = compare_terms(f"{arch} train step 1", metrics, ref_metrics,
                              TRAIN_TERMS)
        e2e = grad_errors(torch, f"{arch} train step 1",
                          slopes_as_one(torch, grads),
                          slopes_as_one(torch, ref_grads), set())
        each = per_tensor_l2(torch, grads, ref_grads)
        del ref_grads
        print(f"{arch} train step 1 vs plain: " + json.dumps(terms)
              + f"; gradients of all {len(each)} tensors (the PReLU slopes "
              "as one), end to end "
              + json.dumps(e2e) + "; L2 error of each tensor "
              + json.dumps(each), flush=True)
        check(e2e["l2"] <= GRAD_E2E_TOL, f"{arch} train step 1: gradient "
              f"of {e2e['l2_at']} differs from the plain step by "
              f"{e2e['l2']:.3e} > {GRAD_E2E_TOL} in the L2 norm")

        times = timed_steps(torch, r["step"], r["state"], batches)
        sps = BATCH / min(times)
        torch.cuda.reset_peak_memory_stats()
        prof = profile_call(
            f"{arch} train step b{BATCH}",
            lambda: float(r["step"](r["state"], batches[0])[1]["loss"]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        big = [make_packed_batch(TRAIN_BATCH_LARGE, seed + 140)]
        r["step"](r["state"], big[0])                       # warm-up
        torch.cuda.reset_peak_memory_stats()
        big_times = timed_steps(torch, r["step"], r["state"], big, n=2)
        big_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stats[arch] = dict(
            samples_per_s=sps, wall_ms=prof["wall_ms"],
            busy_ms=prof["busy_ms"], idle=prof["idle"], peak_gib=peak,
            groups=prof["groups"], terms=terms, grad_err=e2e,
            b32_samples_per_s=TRAIN_BATCH_LARGE / min(big_times),
            b32_peak_gib=big_peak)
        print(f"{arch} train timing: b{BATCH} step times s "
              f"{json.dumps(times)}; train samples/s {sps:.1f}; wall "
              f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} "
              f"ms, idle share {prof['idle']:.3f}; peak memory of one step "
              f"{peak:.2f} GiB; b{TRAIN_BATCH_LARGE} step times s "
              f"{json.dumps(big_times)}, samples/s "
              f"{stats[arch]['b32_samples_per_s']:.1f}, peak "
              f"{big_peak:.2f} GiB", flush=True)
    return launches, stats


def run_gridnet_gan(torch, kern, weights, train_flats, seed: int):
    """``GAN_STEPS`` lsgan steps of the flagship GridNet against the
    full-width PatchGAN, with the same checks as the train phase."""
    from video_layout_generation_tpu_torch.io.weights import params_from_flax
    from video_layout_generation_tpu_torch.models import NLayerDiscriminator
    from video_layout_generation_tpu_torch.train.gan import (
        GanTrainState, make_gan_train_step)

    def build():
        gen = build_gridnet(torch, "GridNet", train_flats["GridNet"])
        disc = NLayerDiscriminator(9, NDF, n_layers=3, norm="instance",
                                   dtype=torch.bfloat16)
        disc.load_state_dict(params_from_flax(weights["disc"]), strict=True)
        hned, combined = frozen_nets(torch, weights)
        step = make_gan_train_step(
            gen, disc, hned, combined, gan_mode="lsgan", flip_mode="batch",
            device=DEVICE,
            generator=torch.Generator().manual_seed(seed + 150))
        state = GanTrainState(gen=recording_state(gen, adam()),
                              disc=recording_state(disc, adam()))
        return gen, disc, step, state

    gen, disc, step, state = build()
    batches = [make_packed_batch(BATCH, seed + 160 + i)
               for i in range(GAN_STEPS)]
    start_g, start_d = snapshot(gen), snapshot(disc)
    kern.reset_launch_counts()
    history, first = [], None
    for i, batch in enumerate(batches):
        (_, metrics), _ = counted_call(
            torch, kern, f"GridNet GAN step {i + 1}",
            lambda: step(state, batch), LAUNCHES_PER_GRIDNET_GAN_STEP)
        history.append({k: float(v) for k, v in metrics.items()})
        if first is None:
            first = (metrics, state.gen.last_grads, state.disc.last_grads)
    launches = kern.launch_counts()
    print(f"GridNet GAN train: {GAN_STEPS} steps of b{BATCH}; launches per "
          f"step {LAUNCHES_PER_GRIDNET_GAN_STEP}; total {launches}; losses "
          f"{json.dumps(history)}", flush=True)
    check(state.step == GAN_STEPS and state.disc.step == GAN_STEPS,
          f"GridNet GAN train: step counters {state.step}, "
          f"{state.disc.step}")
    for m in history:
        check(all(np.isfinite(v) for v in m.values()),
              f"GridNet GAN train: loss {m}")
    dead_d = disc_dead_biases(disc)
    check_moved(torch, "GridNet GAN train, generator", start_g, gen, set())
    check_moved(torch, "GridNet GAN train, discriminator", start_d, disc,
                dead_d)

    _, _, ref_step, ref_state = build()
    with kern.plain():
        _, ref_metrics = ref_step(ref_state, batches[0])
    ref = (ref_metrics, ref_state.gen.last_grads, ref_state.disc.last_grads)
    del ref_step, ref_state
    terms = compare_terms("GridNet GAN step 1", first[0], ref[0], GAN_TERMS)
    e2e_g = grad_errors(torch, "GridNet GAN step 1, generator",
                        slopes_as_one(torch, first[1]),
                        slopes_as_one(torch, ref[1]), set())
    e2e_d = grad_errors(torch, "GridNet GAN step 1, discriminator", first[2],
                        ref[2], dead_d)
    each = per_tensor_l2(torch, first[1], ref[1])
    del ref
    print("GridNet GAN step 1 vs plain: " + json.dumps(terms) + "; gradients "
          "end to end: generator " + json.dumps(e2e_g) + ", discriminator "
          + json.dumps(e2e_d) + "; L2 error of each generator tensor "
          + json.dumps(each), flush=True)
    for net, e2e in (("generator", e2e_g), ("discriminator", e2e_d)):
        check(e2e["l2"] <= GRAD_E2E_TOL, f"GridNet GAN step 1, {net}: "
              f"gradient of {e2e['l2_at']} differs from the plain step by "
              f"{e2e['l2']:.3e} > {GRAD_E2E_TOL} in the L2 norm")

    times = timed_steps(torch, step, state, batches)
    sps = BATCH / min(times)
    torch.cuda.reset_peak_memory_stats()
    prof = profile_call(
        f"GridNet GAN step b{BATCH}",
        lambda: float(step(state, batches[0])[1]["loss"]),
        in_launches=in_launches(LAUNCHES_PER_GRIDNET_GAN_STEP))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"GridNet GAN train timing: b{BATCH} step times s "
          f"{json.dumps(times)}; GAN train samples/s {sps:.1f}; wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms, "
          f"idle share {prof['idle']:.3f}; peak memory of one step "
          f"{peak:.2f} GiB", flush=True)
    return launches, dict(samples_per_s=sps, wall_ms=prof["wall_ms"],
                          busy_ms=prof["busy_ms"], idle=prof["idle"],
                          peak_gib=peak, terms=terms,
                          grad_err=dict(gen=e2e_g, disc=e2e_d))


# ---- phase 11: the training CLI ---------------------------------------------
#
# ``main.py`` -> ``Config`` -> ``Trainer`` at the JAX package's default
# training configuration (CoordGridNet, edges, filters 32/64/96, 256x256,
# bf16) on the synthetic dataset, with the committed HNED and VGG19
# snapshots: a fresh two-epoch run, a resume to a third epoch, and a warm
# start of the flagship GridNet from its npz snapshot, validated.

CLI_TRAIN, CLI_VAL, CLI_EPOCHS = 64, 16, 2
# part (a): CLI_EPOCHS epochs of CLI_TRAIN / BATCH train steps and
# CLI_VAL / BATCH validation batches
LAUNCHES_PER_CLI_RUN = {
    k: CLI_EPOCHS * (CLI_TRAIN // BATCH * LAUNCHES_PER_GRIDNET_TRAIN_STEP[k]
                     + CLI_VAL // BATCH * LAUNCHES_PER_EVAL_STEP[k])
    for k in NO_LAUNCHES}
HNED_NPZ = os.path.join(os.path.dirname(FLAGSHIP), "hned_synth.npz")
VGG_NPZ = os.path.join(os.path.dirname(FLAGSHIP), "vgg_synth.npz")
MEMCPY_PINNED = "Memcpy HtoD (Pinned -> Device)"
MEMCPY_PAGEABLE = "Memcpy HtoD (Pageable -> Device)"


def cli_argv(path: str, *extra) -> list:
    return ["--dataset", "synthetic", "--synthetic_train_size",
            str(CLI_TRAIN), "--synthetic_val_size", str(CLI_VAL), "-bs",
            str(BATCH), "--image_size", *map(str, HW), "--filters_level",
            *map(str, FILTERS), "--hed_weights", HNED_NPZ, "--vgg_weights",
            VGG_NPZ, "-p", path, "--device", DEVICE, *extra]


def watch_steps(kern, trainer, calls: dict,
                train_launches=LAUNCHES_PER_GRIDNET_TRAIN_STEP):
    """Wrap the trainer's train and eval steps: each call's launches must
    be those of one train step (``train_launches``) and one eval step."""
    def counted(name, fn, expected):
        def call(*args):
            before = kern.launch_counts()
            out = fn(*args)
            after = kern.launch_counts()
            diff = {k: after[k] - before[k] for k in after}
            check(diff == expected, f"train CLI, {name} {calls[name] + 1}: "
                  f"launches {diff}, expected {expected}")
            calls[name] += 1
            return out
        return call

    calls.setdefault("train step", 0)
    calls.setdefault("validation batch", 0)
    trainer._train_step = counted("train step", trainer._train_step,
                                  train_launches)
    trainer._eval_step = counted("validation batch", trainer._eval_step,
                                 LAUNCHES_PER_EVAL_STEP)


def check_restored(torch, trainer, saved: dict, label: str):
    """The trainer's parameters, moments, step and learning rate equal the
    checkpoint's, bit for bit."""
    def same(a, b, what):
        check(set(a) == set(b), f"{label}: {what} names differ")
        for k in a:
            check(torch.equal(a[k].detach().cpu(), b[k]),
                  f"{label}: {what} {k} differs from the checkpoint")

    same(trainer.model.state_dict(), saved["params"], "parameter")
    st = trainer.model_state
    for key in ("mu", "nu"):
        same(st.opt_state[key], saved["opt_state"][key], f"moment {key}")
    check(st.opt_state["count"] == saved["opt_state"]["count"]
          and st.opt_state["learning_rate"]
          == saved["opt_state"]["learning_rate"]
          and st.step == trainer.global_step == saved["step"],
          f"{label}: count / learning rate / step differ from the checkpoint")


def profile_loop_steps(torch, trainer, epoch: int):
    """A torch.profiler trace of the third and fourth steps of one more
    train epoch, the loader between them included: the wall time from the
    end of the second step to that of the fourth, each edge after a
    synchronize (the steps inside run as the loop runs them), the device
    busy time, the idle share, the copies to the card from pinned and from
    pageable memory, and the loader's wait a step over the epoch. A trace
    without both steps' launches of A and B is taken again with another
    epoch."""
    from torch.profiler import (ProfilerActivity, profile as tprofile,
                                schedule)
    step = trainer._train_step
    for attempt in range(TRACE_TRIES):
        retry_pause(attempt)
        marks = []

        def traced(*args):
            out = step(*args)
            if len(marks) in (1, 3):       # the window's two edges
                torch.cuda.synchronize()
            prof.step()
            marks.append(time.perf_counter())
            return out

        trainer._train_step = traced
        # the card's activity only: tracing the host's ops would slow the
        # host-bound loop and inflate its wall time
        with tprofile(activities=[ProfilerActivity.CUDA],
                      schedule=schedule(wait=1, warmup=1, active=2,
                                        repeat=1)) as prof:
            trainer.set_epoch(epoch + attempt)
            trainer.train()
        trainer._train_step = step
        # the schedule's own ``ProfilerStep#`` spans are no device work
        rows = [ev for ev in prof.key_averages() if on_device(torch, ev)
                and not ev.key.startswith("ProfilerStep")]
        a = sum(ev.count for ev in rows if "conv3x3_mma_kernel" in ev.key)
        b = sum(ev.count for ev in rows
                if "fused_lateral_mma_kernel" in ev.key)
        if (a, b) == (2 * LAUNCHES_PER_GRIDNET_TRAIN_STEP["prelu_conv3x3"],
                      2 * LAUNCHES_PER_GRIDNET_TRAIN_STEP["fused_lateral"]):
            break
        print(f"train CLI profile: incomplete trace (A {a}, B {b}), taking "
              f"it again", flush=True)
    else:
        raise SmokeFailure("train CLI profile: no complete trace")
    wall = marks[3] - marks[1]
    busy = sum(ev.self_device_time_total for ev in rows) / 1e6

    def copies(key):
        hit = [ev for ev in rows if ev.key == key]
        return dict(n=sum(ev.count for ev in hit),
                    ms=sum(ev.self_device_time_total for ev in hit) / 1e3)

    groups = {}
    for ev in rows:
        label = kernel_group(ev.key)
        groups[label] = groups.get(label, 0.0) + ev.self_device_time_total / 1e3
    for ev in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"train CLI profile: {ev.self_device_time_total / 1e3:9.2f} ms "
              f"{ev.count:6d}x {ev.key[:90]}", flush=True)
    stats = trainer.epoch_stats
    return dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3,
                idle=1 - busy / wall, pinned=copies(MEMCPY_PINNED),
                pageable=copies(MEMCPY_PAGEABLE), groups=groups,
                loader_wait_ms=stats["load_s"] / stats["steps"] * 1e3)


def run_train_cli(torch, kern, seed: int):
    """Parts (a) fresh run, (b) resume and (c) warm start of the CLI."""
    import shutil
    import tempfile
    from video_layout_generation_tpu_torch import main as cli
    from video_layout_generation_tpu_torch.config import config_from_args
    from video_layout_generation_tpu_torch.io.checkpoint import CKPT_FILE
    from video_layout_generation_tpu_torch.train.steps import make_eval_step
    from video_layout_generation_tpu_torch.train.trainer import validate

    root = tempfile.mkdtemp(prefix="vlg_train_cli_")
    try:
        path = os.path.join(root, "exp")
        steps_per_epoch = CLI_TRAIN // BATCH
        # -- (a) a fresh run: main -> Config -> Trainer.fit ----------------
        trainer = cli.build_trainer(config_from_args(
            cli_argv(path, "-e", str(CLI_EPOCHS), "--seed", str(1024 + seed))))
        calls = {}
        watch_steps(kern, trainer, calls)
        kern.reset_launch_counts()
        t0 = time.perf_counter()
        fit_a = cli.run_trainer(trainer)
        fit_s = time.perf_counter() - t0
        launches = kern.launch_counts()
        epoch2 = dict(trainer.epoch_stats)
        n_steps = CLI_EPOCHS * steps_per_epoch
        n_val = CLI_EPOCHS * (CLI_VAL // BATCH)
        # with tensorboardX installed the loop also logs image grids: one
        # more eval step on each epoch's first step
        n_val += CLI_EPOCHS if trainer.writer.active else 0
        check(calls == {"train step": n_steps, "validation batch": n_val},
              f"train CLI: calls {calls}, expected {n_steps} train steps "
              f"and {n_val} eval steps")
        want = {k: n_steps * LAUNCHES_PER_GRIDNET_TRAIN_STEP[k]
                + n_val * LAUNCHES_PER_EVAL_STEP[k] for k in NO_LAUNCHES}
        check(launches == want, f"train CLI: launches {launches}, expected "
              f"{want}")
        check(trainer.global_step == n_steps and trainer.epoch == CLI_EPOCHS,
              f"train CLI: step {trainer.global_step}, epoch {trainer.epoch}")
        check(np.isfinite(fit_a["loss"]) and 0 <= fit_a["miou"] <= 1,
              f"train CLI: validation {fit_a}")
        log = open(os.path.join(path, "experiment.log")).read()
        losses = [float(v) for v in re.findall(r"loss \[([-0-9.naif]+)\]",
                                                log)]
        check(len(losses) >= CLI_EPOCHS * 2 and all(np.isfinite(losses)),
              f"train CLI: logged losses {losses}")
        for line in ("Start of experiment", f"Device: {DEVICE}", "mIoU",
                     f"Epoch [{CLI_EPOCHS}/{CLI_EPOCHS}][1/{steps_per_epoch}]",
                     "samples/s", "Saving checkpoint"):
            check(line in log, f"train CLI: no '{line}' in experiment.log")
        ck = os.path.join(path, "checkpoint")
        for tag in ("001", "002", "latest"):
            check(os.path.isfile(os.path.join(ck, tag, CKPT_FILE)),
                  f"train CLI: no checkpoint {tag}")
        dumps = [f for f in os.listdir(os.path.join(path, "predict"))
                 if f.endswith("_stack.npy")]
        # one dump a validation, named by the second (two validations in
        # one second share a name, as in the JAX package)
        check(1 <= len(dumps) <= CLI_EPOCHS,
              f"train CLI: predict/ holds {dumps}")
        stack = np.load(os.path.join(path, "predict", dumps[0]),
                        mmap_mode="r")
        check(stack.shape == (BATCH,) + HW + (16,),
              f"train CLI: dumped stack {stack.shape}")
        sps = epoch2["samples"] / epoch2["wall_s"]
        trainer.predict_dir = None          # time validation without its dump
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.validate()
        val_sps = CLI_VAL / (time.perf_counter() - t0)
        print(f"train CLI (a): {CLI_EPOCHS} epochs of {steps_per_epoch} b"
              f"{BATCH} steps and {CLI_VAL // BATCH} validation batch in "
              f"{fit_s:.2f} s; launches per train step "
              f"{LAUNCHES_PER_GRIDNET_TRAIN_STEP}, per validation batch "
              f"{LAUNCHES_PER_EVAL_STEP}, total {launches}; validation "
              f"{json.dumps({k: fit_a[k] for k in ('loss', 'miou', 'pixel_acc')})}"
              f"; logged losses {losses}", flush=True)
        del trainer

        # -- (b) resume to a third epoch ------------------------------------
        saved = torch.load(os.path.join(ck, "latest", CKPT_FILE),
                           map_location="cpu", weights_only=True)
        trainer = cli.build_trainer(config_from_args(cli_argv(
            path, "--resume", "latest", "-e", str(CLI_EPOCHS + 1),
            "--seed", str(1024 + seed))))
        check(trainer.epoch == CLI_EPOCHS and trainer.global_step == n_steps,
              f"resume: epoch {trainer.epoch}, step {trainer.global_step}")
        check_restored(torch, trainer, saved, "resume")
        val_b = trainer.validate()
        for k in ("loss", "miou", "pixel_acc"):
            check(val_b[k] == fit_a[k], f"resume: validation {k} "
                  f"{val_b[k]!r} != {fit_a[k]!r} before the resume")
        calls_b = {}
        watch_steps(kern, trainer, calls_b)
        fit_b = cli.run_trainer(trainer)
        check(trainer.epoch == CLI_EPOCHS + 1 and trainer.global_step
              == n_steps + steps_per_epoch and calls_b["train step"]
              == steps_per_epoch and np.isfinite(fit_b["loss"]),
              f"resume: epoch {trainer.epoch}, step {trainer.global_step}, "
              f"calls {calls_b}, validation {fit_b}")
        check(os.path.isfile(os.path.join(ck, "003", CKPT_FILE)),
              "resume: no checkpoint 003")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save_checkpoint()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        trainer.load_checkpoint("latest")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        prof = profile_loop_steps(torch, trainer, CLI_EPOCHS + 1)
        print(f"train CLI (b): resumed at epoch {CLI_EPOCHS} step {n_steps}"
              f", parameters, moments, count, learning rate and step equal "
              f"to the checkpoint's bits; validation before training equal "
              f"to (a)'s last ({val_b['loss']!r}); epoch {CLI_EPOCHS + 1} "
              f"validation loss {fit_b['loss']:.4f}; checkpoint save "
              f"{save_s:.3f} s, restore {restore_s:.3f} s", flush=True)
        check(prof["pageable"]["n"] == 0, f"train CLI: {prof['pageable']} "
              f"copies to the card from pageable memory inside the steps")
        check(prof["pinned"]["n"] > 0, "train CLI: no copy from pinned "
              "memory in the profiled steps")
        del trainer

        # -- (c) warm start of the flagship GridNet, validated --------------
        trainer = cli.build_trainer(config_from_args(cli_argv(
            os.path.join(root, "warm"), "--arch", "GridNet", "--ckpt",
            FLAGSHIP, "--validate")))
        rep = trainer.warm_start_report["generator"]
        check(len(rep["loaded"]) == 182 and not (
            rep["missing"] or rep["unexpected"] or rep["shape_mismatch"]),
            f"warm start: {({k: len(v) for k, v in rep.items()})}")
        calls_c = {}
        watch_steps(kern, trainer, calls_c)
        val_c = cli.run_trainer(trainer)
        check(calls_c["validation batch"] == max(CLI_VAL // BATCH, 1),
              f"warm start: calls {calls_c}")
        batch = next(iter(trainer.val_loader))
        plain = make_eval_step(trainer.model, trainer.hned, trainer.combined,
                               n_classes=N_CLASSES, device=DEVICE)
        with kern.plain():
            val_p = validate(plain, [batch], N_CLASSES)
            ref_metrics, ref_ids, ref_img = plain(batch)
        metrics, ids, img = trainer._eval_step(batch)
        terms = {}
        for k in TRAIN_TERMS:
            a, b = float(metrics[k]), float(ref_metrics[k])
            terms[k] = dict(kernels=a, plain=b, rel_err=abs(a - b) / abs(b))
        agree = float((ids == ref_ids).float().mean())
        diff = (img - ref_img).abs()
        top = ref_img.abs().max()
        share = float((diff <= IMG_MAX_TOL * top).float().mean())
        mean_err = float(diff.mean() / ref_img.abs().mean())
        print(f"train CLI (c): warm start {len(rep['loaded'])} of 182 loaded;"
              f" validation through the kernels "
              f"{json.dumps({k: val_c[k] for k in ('loss', 'miou', 'pixel_acc')})}"
              f", plain {json.dumps({k: val_p[k] for k in ('loss', 'miou', 'pixel_acc')})}"
              f"; terms {json.dumps(terms)}; layout agreement {agree:.5f}; "
              f"image mean error {mean_err:.5f}, share within "
              f"{IMG_MAX_TOL:.0e} {share:.6f}", flush=True)
        for k, v in terms.items():
            check(v["rel_err"] <= LOSS_TERM_RTOL,
                  f"warm start: {k} {v['kernels']} vs plain {v['plain']}")
        check(agree >= 0.99, f"warm start: layout agreement {agree:.4f}")
        check(mean_err <= EDGE_IMG_MEAN_TOL and share >= EDGE_IMG_SHARE,
              f"warm start: image mean error {mean_err:.3e}, share {share}")
        check(abs(val_c["pixel_acc"] - val_p["pixel_acc"]) <= 0.01,
              f"warm start: pixel accuracy {val_c['pixel_acc']} vs plain "
              f"{val_p['pixel_acc']}")
        del trainer, plain
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    # the profiler's kernel tracing slows the host-bound loop, so the idle
    # share of the unprofiled epoch is estimated from the busy time a step
    # in the trace over the epoch's wall time a step
    idle_loop = 1 - prof["busy_ms"] / 2 / (epoch2["wall_s"] * 1e3
                                           / epoch2["steps"])
    stats = dict(samples_per_s=sps, epoch_wall_s=epoch2["wall_s"],
                 idle_epoch=idle_loop,
                 load_s=epoch2["load_s"], comp_s=epoch2["comp_s"],
                 val_samples_per_s=val_sps, save_s=save_s,
                 restore_s=restore_s, profile=prof,
                 warm_start=dict(terms=terms, agreement=agree))
    print(f"train CLI timing, card {card_line()}: fit loop train samples/s "
          f"at b{BATCH} over epoch {CLI_EPOCHS} {sps:.1f} (wall "
          f"{epoch2['wall_s']:.3f} s, loader wait {epoch2['load_s']:.3f} s, "
          f"compute {epoch2['comp_s']:.3f} s); validation samples/s "
          f"{val_sps:.1f}; idle share of epoch {CLI_EPOCHS} (busy a step "
          f"from the trace over its wall a step) {idle_loop:.3f}; two "
          f"profiled loop steps: wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms, "
          f"idle share {prof['idle']:.3f}, copies to the card from pinned "
          f"memory {json.dumps(prof['pinned'])}, from pageable memory "
          f"{json.dumps(prof['pageable'])}, device ms by group "
          f"{json.dumps(prof['groups'])}, loader wait a step "
          f"{prof['loader_wait_ms']:.2f} ms; checkpoint save {save_s:.3f} s, "
          f"restore {restore_s:.3f} s", flush=True)
    return launches, stats


# ---- phase 12: rollout-fidelity training -----------------------------------
#
# The JAX package's finetune recipe (README "rollout-fidelity training"):
# the flagship GridNet from its epoch-96 snapshot trained on K=4 autoregressive
# steps with feedback noise 0.1 at lr 5e-5, through ``main.py`` at full
# width, with the phase-11 data (synthetic 4+2-frame windows, 64 train and 16
# validation samples, b16, bf16); then the same step against the plain
# versions, scheduled sampling on the default CoordGridNet, and the recipe
# on windows rendered on the card (``--device_data``).

RECIPE_K = 4
RECIPE_NOISE = 0.1
RECIPE_ARGS = ("--arch", "GridNet", "--ckpt", FLAGSHIP, "--multistep_k",
               str(RECIPE_K), "--multistep_feedback_noise", str(RECIPE_NOISE),
               "--lr", "5e-5")
REMAT_GRAD_TOL = 1e-2    # L2, remat against no remat through the kernels
# the card's rendered windows against the host's: the share of layout pixels
# that differ (rectangle edges in f32 on the card, f64 on the host), and the
# colours where the layouts agree, up to the host's rounding to 1/255
RENDER_MISMATCH = 1e-4
RENDER_COLOUR_TOL = 0.5 / 255 + 1e-6


def launches_per_rollout_step(k: int, remat_steps: bool = True) -> dict:
    """Launches of one K-step train step with edges (``train/multistep.py``):
    HNED on the two seed frames and on each fed-back frame but the last
    (13 (K+1) A); each step's GridNet (31 A + 15 B), VGG19 on its output and
    target (24 A) and VGG19's data gradient (12 A); with ``remat_steps``
    each step's forward and losses once more in the backward (31 + 24 A,
    15 B: the recomputation stops at the last tensor the backward saved,
    the cross entropy's, after both VGG19 forwards). K=4: 333 A and 60 B
    without remat, 553 A and 120 B with."""
    a, b = 13 * (k + 1) + k * (31 + 24 + 12), 15 * k
    if remat_steps and k > 1:
        a, b = a + k * (31 + 24), b + 15 * k
    return dict(NO_LAUNCHES, prelu_conv3x3=a, fused_lateral=b)


LAUNCHES_PER_ROLLOUT_STEP = launches_per_rollout_step(RECIPE_K)
# scheduled sampling: HNED on f0, f1 and the mixed f2 (39 A), GridNet twice
# (the teacher without grad, 62 A and 30 B), VGG19 forwards and data
# gradient (36 A)
LAUNCHES_PER_SCHEDULED_STEP = dict(
    NO_LAUNCHES, prelu_conv3x3=3 * 13 + 2 * 31 + 2 * 12 + 12,
    fused_lateral=2 * 15)


def watch_rollout_steps(kern, trainer, calls: dict, per_step: dict,
                        history: list):
    """Wrap the trainer's train and eval steps (``watch_steps``) with
    ``per_step`` as a train step's launches, keeping each step's metrics."""
    watch_steps(kern, trainer, calls, per_step)
    counted = trainer._train_step

    def step(state, batch):
        state, metrics = counted(state, batch)
        history.append(metrics)
        return state, metrics

    trainer._train_step = step


def traced_epoch(torch, trainer, epoch: int, per_step: dict, label: str):
    """A CUDA-only torch.profiler trace of one train epoch: the copies to
    the card, device busy ms a step and the epoch's wall time. A trace
    without every step's launches of A and B is taken again with the next
    epoch. The device's copy records are not all returned (two pinned
    copies of 50 MB, one after the other, came back as one record or as
    none on the H100), so the copies to the card are also counted from
    the runtime's ``cudaMemcpyAsync`` calls, less the copies on the card
    and to the host that came back: ``h2d`` (a missing record of those
    can only raise it)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    steps = len(trainer.train_loader)
    for attempt in range(TRACE_TRIES):
        retry_pause(attempt)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.set_epoch(epoch + attempt)
            trainer.train()
            torch.cuda.synchronize()
        rows = [ev for ev in prof.key_averages() if on_device(torch, ev)]
        a = sum(ev.count for ev in rows if "conv3x3_mma_kernel" in ev.key)
        b = sum(ev.count for ev in rows
                if "fused_lateral_mma_kernel" in ev.key)
        if (a, b) == (steps * per_step["prelu_conv3x3"],
                      steps * per_step["fused_lateral"]):
            break
        print(f"{label} profile: incomplete trace (A {a}, B {b}), taking it "
              f"again", flush=True)
    else:
        raise SmokeFailure(f"{label} profile: no complete trace")

    def copies(key):
        hit = [ev for ev in rows if ev.key == key]
        return dict(n=sum(ev.count for ev in hit),
                    ms=sum(ev.self_device_time_total for ev in hit) / 1e3)

    api = sum(ev.count for ev in prof.key_averages()
              if ev.key == "cudaMemcpyAsync")
    other = sum(ev.count for ev in rows
                if ev.key.startswith(("Memcpy DtoD", "Memcpy DtoH")))
    for ev in rows:
        if ev.key.startswith("Memcpy"):
            print(f"{label} profile: {ev.count}x {ev.key}, "
                  f"{ev.self_device_time_total / 1e3:.3f} ms", flush=True)
    busy = sum(ev.self_device_time_total for ev in rows) / 1e3
    return dict(h2d=api - other, memcpy_calls=api,
                pinned=copies(MEMCPY_PINNED),
                pageable=copies(MEMCPY_PAGEABLE), busy_ms_step=busy / steps,
                epoch_wall_s=trainer.epoch_stats["wall_s"])


def timed_epoch(torch, trainer, epoch: int) -> dict:
    """One more train epoch, unprofiled: samples/s, wall and peak GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.set_epoch(epoch)
    trainer.train()
    torch.cuda.synchronize()
    st = trainer.epoch_stats
    return dict(samples_per_s=st["samples"] / st["wall_s"],
                wall_s=st["wall_s"], load_s=st["load_s"],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def rollout_window(torch, n: int, seed: int):
    """(imgs, segs) of an n-sample K+2-frame synthetic window batch on the
    card, rendered on the host as the CLI's dataset renders it."""
    from video_layout_generation_tpu_torch.data.synthetic import \
        SyntheticTriplets
    from video_layout_generation_tpu_torch.train.multistep import \
        decode_window_batch
    ds = SyntheticTriplets(n, HW, N_CLASSES, seed=seed, emit_uint8=True,
                           n_frames=RECIPE_K + 2)
    packed = np.stack([np.concatenate(
        [s["imgs"], s["segs"][..., None]], -1)
        for s in (ds[i] for i in range(n))])
    return decode_window_batch(
        {"packedseq": torch.from_numpy(packed).to(DEVICE)})


def rendered_window_mismatch(torch, trainer) -> dict:
    """The first batch of epoch 0 that the device loader renders on the
    card against the host dataset's windows of the same scenes (the
    dataset the CLI builds without ``--device_data``): the share of layout
    pixels that differ and the largest colour difference where the
    layouts agree."""
    from video_layout_generation_tpu_torch.data import get_dataset
    from video_layout_generation_tpu_torch.train.multistep import \
        decode_window_batch
    loader = trainer.train_loader
    loader.set_epoch(0)
    idx = loader.epoch_indices()[0]
    imgs, segs = decode_window_batch(
        loader.render(torch.from_numpy(idx).to(DEVICE)))
    host = get_dataset(trainer.cfg)[0]
    packed = np.stack([np.concatenate(
        [s["imgs"], s["segs"][..., None]], -1)
        for s in (host[int(i)] for i in idx)])
    h_imgs, h_segs = decode_window_batch(
        {"packedseq": torch.from_numpy(packed).to(DEVICE)})
    check(imgs.shape == h_imgs.shape, f"rollout (d): rendered windows "
          f"{tuple(imgs.shape)}, host {tuple(h_imgs.shape)}")
    same = segs == h_segs
    out = dict(layout_mismatch=float((~same).float().mean()),
               colour_err=float((imgs - h_imgs).abs()[same].max()),
               pixels=int(same.numel()))
    check(out["layout_mismatch"] < RENDER_MISMATCH
          and out["colour_err"] <= RENDER_COLOUR_TOL,
          f"rollout (d): windows rendered on the card against the host's "
          f"{out}, limits {RENDER_MISMATCH} and {RENDER_COLOUR_TOL:.3e}")
    return out


def rollout_step_grads(torch, net, loss_fn, imgs, segs, noise, plain):
    """(metrics, gradients) of one step, forward and backward (with remat,
    the recomputation) under ``kernels.plain(plain)``."""
    from video_layout_generation_tpu_torch.ops import kernels
    names = [k for k, _ in net.named_parameters()]
    with kernels.plain(plain):
        total, metrics = loss_fn(imgs, segs, True, noise)
        grads = torch.autograd.grad(total, list(net.parameters()))
    return ({k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


def run_rollout_step_agreement(torch, hned, combined, seed: int):
    """Part (b): step 1 of the K=4 recipe step (flagship weights, a fixed
    coin that flips, fixed feedback noise) through the kernels against the
    plain versions, and through the kernels with and without remat."""
    from video_layout_generation_tpu_torch.train.multistep import (
        draw_rollout_noise, make_multistep_loss_fn)
    net = build_gridnet(torch, "GridNet", flagship_flat()).to(DEVICE)
    imgs, segs = rollout_window(torch, BATCH, seed + 170)
    noise = draw_rollout_noise(
        RECIPE_K, BATCH, HW, N_CLASSES, RECIPE_NOISE, 0.0,
        torch.Generator(device=DEVICE).manual_seed(seed + 171), DEVICE)
    out = {}
    for name, remat, plain in (("kernels", True, False),
                               ("plain", True, True),
                               ("kernels, no remat", False, False)):
        loss_fn = make_multistep_loss_fn(net, hned, combined, RECIPE_K,
                                         remat_steps=remat,
                                         feedback_noise=RECIPE_NOISE)
        out[name] = rollout_step_grads(torch, net, loss_fn, imgs, segs,
                                       noise, plain)
        torch.cuda.synchronize()
    (m, g), (pm, pg), (nm, ng) = (out["kernels"], out["plain"],
                                  out["kernels, no remat"])
    terms = compare_terms("rollout step 1", m, pm, TRAIN_TERMS)
    per = m["loss_per_step"].float().cpu().numpy()
    per_plain = pm["loss_per_step"].float().cpu().numpy()
    per_err = float(np.max(np.abs(per - per_plain) / np.abs(per_plain)))
    check(per_err <= LOSS_TERM_RTOL, f"rollout step 1: loss per step "
          f"{per.tolist()} vs plain {per_plain.tolist()}")
    e2e = grad_errors(torch, "rollout step 1", slopes_as_one(torch, g),
                      slopes_as_one(torch, pg), set())
    check(e2e["l2"] <= GRAD_E2E_TOL, f"rollout step 1: gradient of "
          f"{e2e['l2_at']} differs from the plain step by {e2e['l2']:.3e} "
          f"> {GRAD_E2E_TOL} in the L2 norm")
    for k in TRAIN_TERMS + ("loss_per_step",):
        check(torch.equal(m[k], nm[k]), f"rollout step 1: {k} with remat "
              f"{m[k].tolist()} != without {nm[k].tolist()}")
    remat = grad_errors(torch, "rollout step 1, remat",
                        slopes_as_one(torch, g), slopes_as_one(torch, ng),
                        set())
    check(remat["l2"] <= REMAT_GRAD_TOL, f"rollout step 1: gradient of "
          f"{remat['l2_at']} with remat differs from without by "
          f"{remat['l2']:.3e} > {REMAT_GRAD_TOL} in the L2 norm")
    print(f"rollout (b): step 1 of the K={RECIPE_K} step (flagship, flipped,"
          f" noise {RECIPE_NOISE}) vs plain: " + json.dumps(terms)
          + f"; loss per step {per.tolist()}, plain {per_plain.tolist()}, "
          f"max relative error {per_err:.3e}; gradients end to end (the "
          f"PReLU slopes as one) " + json.dumps(e2e) + "; remat vs no remat "
          f"through the kernels: losses equal, gradients "
          + json.dumps(remat), flush=True)
    del out, g, pg, ng, net
    torch.cuda.empty_cache()
    return dict(terms=terms, per_step_err=per_err, grad_err=e2e,
                remat_grad_err=remat)


def run_rollout_training(torch, kern, seed: int):
    """Parts (a) to (d) of phase 12; returns the launches of (a) and the
    numbers of every part."""
    import shutil
    import tempfile
    from video_layout_generation_tpu_torch import main as cli
    from video_layout_generation_tpu_torch.config import config_from_args

    root = tempfile.mkdtemp(prefix="vlg_rollout_")
    stats = {}
    steps = CLI_TRAIN // BATCH
    try:
        def build(name, *extra):
            return cli.build_trainer(config_from_args(cli_argv(
                os.path.join(root, name), "-e", "1", "--seed",
                str(1024 + seed), *extra)))

        # -- (a) the recipe through main.py ---------------------------------
        trainer = build("recipe", *RECIPE_ARGS)
        calls, history = {}, []
        watch_rollout_steps(kern, trainer, calls, LAUNCHES_PER_ROLLOUT_STEP,
                            history)
        kern.reset_launch_counts()
        t0 = time.perf_counter()
        fit_a = cli.run_trainer(trainer)
        fit_s = time.perf_counter() - t0
        launches = kern.launch_counts()
        n_val = CLI_VAL // BATCH + (1 if trainer.writer.active else 0)
        check(calls == {"train step": steps, "validation batch": n_val},
              f"rollout (a): calls {calls}")
        losses_a = [float(m["loss"]) for m in history]
        per_step = [m["loss_per_step"].float().cpu().tolist()
                    for m in history]
        check(all(len(p) == RECIPE_K and np.all(np.isfinite(p))
                  for p in per_step) and np.all(np.isfinite(losses_a)),
              f"rollout (a): losses {losses_a}, per step {per_step}")
        check(trainer.global_step == steps and np.isfinite(fit_a["loss"]),
              f"rollout (a): step {trainer.global_step}, validation {fit_a}")
        check(trainer.train_loader.loader.ds.n_frames == RECIPE_K + 2,
              "rollout (a): the train windows are not K+2 frames")
        log = open(os.path.join(root, "recipe", "experiment.log")).read()
        check("loss per rollout step [" in log and "Loading from ckpt" in log,
              "rollout (a): no per-step losses or warm start in the log")
        check(len(trainer.warm_start_report["generator"]["loaded"]) == 182,
              "rollout (a): the flagship did not load whole")
        prof = profile_call(
            f"K={RECIPE_K} train step b{BATCH}",
            lambda: float(trainer._train_step(
                trainer.state, next(iter(trainer.train_loader)))[1]["loss"]))
        host = timed_epoch(torch, trainer, 1)
        # the traced call's host is slowed by the tracing: the unprofiled
        # epoch's idle share is the traced busy time over its wall a step
        host["idle_epoch"] = 1 - prof["busy_ms"] / (host["wall_s"] * 1e3
                                                    / steps)
        stats["recipe"] = dict(host, fit_s=fit_s, busy_ms=prof["busy_ms"],
                               wall_ms=prof["wall_ms"], idle=prof["idle"],
                               groups=prof["groups"], losses=losses_a,
                               loss_per_step=per_step,
                               validation={k: fit_a[k] for k in (
                                   "loss", "miou", "pixel_acc")})
        print(f"rollout (a): the recipe ({' '.join(RECIPE_ARGS[2:])}) "
              f"through main.py, {steps} steps of b{BATCH} in {fit_s:.2f} s "
              f"with validation; launches per train step "
              f"{LAUNCHES_PER_ROLLOUT_STEP}, total {launches}; losses "
              f"{losses_a}; loss per rollout step {per_step}; validation "
              + json.dumps(stats["recipe"]["validation"]) + "; epoch 2 "
              + json.dumps(host), flush=True)

        # -- (b) step 1 against the plain versions, remat against none ----
        stats["agreement"] = run_rollout_step_agreement(
            torch, trainer.hned, trainer.combined, seed)
        hned_c, combined_c = trainer.hned, trainer.combined
        del trainer, hned_c, combined_c
        torch.cuda.empty_cache()

        # -- (c) one scheduled-sampling step on the CoordGridNet ----------
        trainer = build("scheduled", "--scheduled_sampling", "0.5",
                        "--synthetic_train_size", str(2 * BATCH))
        calls_c, hist_c = {}, []
        watch_rollout_steps(kern, trainer, calls_c,
                            LAUNCHES_PER_SCHEDULED_STEP, hist_c)
        trainer.set_epoch(0)
        trainer.train()
        check(calls_c["train step"] == 2 and all(
            np.isfinite(float(m["loss"])) and m["ss_p"] == 0.5
            for m in hist_c), f"rollout (c): calls {calls_c}")
        stats["scheduled"] = timed_epoch(torch, trainer, 1)
        print(f"rollout (c): scheduled sampling p 0.5 on the CoordGridNet, "
              f"launches per step {LAUNCHES_PER_SCHEDULED_STEP}; losses "
              f"{[float(m['loss']) for m in hist_c[:2]]}; "
              + json.dumps(stats["scheduled"]), flush=True)
        del trainer

        # -- (d) the recipe on windows rendered on the card ---------------
        trainer = build("device", *RECIPE_ARGS, "--device_data")
        render = rendered_window_mismatch(torch, trainer)
        calls_d, hist_d = {}, []
        watch_rollout_steps(kern, trainer, calls_d,
                            LAUNCHES_PER_ROLLOUT_STEP, hist_d)
        for attempt in range(TRACE_TRIES):
            retry_pause(attempt)
            dev_prof = traced_epoch(torch, trainer, 10 * attempt,
                                    LAUNCHES_PER_ROLLOUT_STEP, "rollout (d)")
            if dev_prof["h2d"] == 1:
                break
            # the same 19 cudaMemcpyAsync calls came back once with one
            # device-to-host record fewer: a dropped record raises h2d
            print(f"rollout (d): {dev_prof['h2d']} copies to the card "
                  f"counted from {dev_prof['memcpy_calls']} copy calls; the "
                  f"trace may have dropped a copy record, taking it again",
                  flush=True)
        check(dev_prof["h2d"] == 1 and dev_prof["pinned"]["n"] <= 1
              and dev_prof["pageable"]["n"] == 0,
              f"rollout (d): copies to the card {dev_prof}, expected the "
              f"epoch's indices once, from pinned memory")
        check(all(np.isfinite(float(m["loss"])) for m in hist_d)
              and len(hist_d) >= steps, f"rollout (d): {len(hist_d)} steps")
        stats["device_data"] = dict(timed_epoch(torch, trainer, 5),
                                    render=render, profile=dev_prof)
        print(f"rollout (d): --device_data: the first batch rendered on the "
              f"card against the host's windows {json.dumps(render)}; "
              f"losses {[float(m['loss']) for m in hist_d[:steps]]}; copies "
              f"to the card in the epoch {json.dumps(dev_prof)}; "
              + json.dumps({k: v for k, v in stats["device_data"].items()
                            if k not in ("profile", "render")}), flush=True)
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    rec = stats["recipe"]
    print(f"rollout timing, card {card_line()}: K={RECIPE_K} recipe train "
          f"samples/s at b{BATCH} {rec['samples_per_s']:.1f} (host-fed "
          f"loop, epoch 2), busy {rec['busy_ms']:.1f} ms a step, idle share "
          f"{rec['idle_epoch']:.3f} over epoch 2 ({rec['idle']:.3f} in the "
          f"traced step), peak {rec['peak_gib']:.2f} GiB; scheduled "
          f"sampling {stats['scheduled']['samples_per_s']:.1f}; rendered "
          f"on the card {stats['device_data']['samples_per_s']:.1f}; device "
          f"ms by group " + json.dumps(rec["groups"]), flush=True)
    return launches, stats


# ---- phase 13: the layout families -------------------------------------------
#
# BASELINE.json's configs 1-3 through the port's LayoutTrainer, layout_cli
# and evaluate_layout_rollout at full width, data cut in scale only: the
# CVAE of config 3 from the committed trained snapshot (256x256, latent 64,
# b16), its CLI training, the K=3 exposure leg (BENCH_NOTES round 5 "E"),
# the ConvLSTM of config 2 (128x128, hidden 64) and the VAE of config 1
# (64x64, b4). The nets' convs are the library's (cuDNN), as the JAX
# package's are XLA's: no hand-written kernel runs on this path.

CVAE_NPZ = os.path.join(os.path.dirname(FLAGSHIP), "cvae256_036.npz")
LAYOUT_HW, LAYOUT_LATENT, LAYOUT_FRAMES = 256, 64, 16
LAYOUT_VAL, LAYOUT_TRAIN, LAYOUT_CLI_VAL = 64, 64, 16
LAYOUT_SCENES = 16            # rollout scenes, as tools/layout_convergence.py
LSTM_HW, LSTM_HIDDEN, LSTM_FRAMES = 128, 64, 4
VAE_HW, VAE_BATCH = 64, 4
EXPOSURE_K, EXPOSURE_LR, EXPOSURE_BETA = 3, 5e-5, 0.05
CARD_CPU_BATCH = 2            # the K=3 step held against the CPU's
# the JAX package on this snapshot and data (BENCH_NOTES.md, round 4):
# next-layout validation mIoU / pixel accuracy, and the 16-frame
# prior-sample rollout's per-step mIoU
JAX_CVAE_MIOU, JAX_CVAE_PIXACC = 0.7834, 0.9761
JAX_CVAE_CURVE = (0.778, 0.592, 0.440, 0.323, 0.234, 0.169, 0.127, 0.097,
                  0.078, 0.066, 0.057, 0.052, 0.050, 0.049, 0.048, 0.048)
CVAE_MIOU_TOL = 0.03        # |port - JAX| validation mIoU (other noise draws)
CVAE_DTYPE_MIOU_TOL = 0.01  # bf16 against f32 validation mIoU, on the card
CVAE_DTYPE_AGREEMENT = 0.98   # bf16 against f32 layouts of one batch
CARD_CPU_LOSS_RTOL = 1e-3   # K=3 step, f32 card (TF32 off) vs f32 CPU:
CARD_CPU_GRAD_L2 = 1e-2     # loss and recon relative, gradients in L2,
# and the KL, a sum over the latent's 32*32*64 elements a sample of terms of
# order 1 that cancel to about 0.2, per element: one f32 ulp at 1
CARD_CPU_KL_PER_ELEMENT = 2.0 ** -23


def layout_cfg(**kw):
    from video_layout_generation_tpu_torch.config import Config
    base = dict(dataset="synthetic", image_size=(LAYOUT_HW, LAYOUT_HW),
                n_classes=N_CLASSES, batch_size=BATCH, workers=4,
                rollout_frames=LAYOUT_FRAMES, edge=False, device=DEVICE,
                path=None)
    base.update(kw)
    return Config(**base)


def check_no_launches(kern, label: str) -> dict:
    counts = kern.launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"layout families, {label}: hand-written kernels launched "
          f"{counts}, expected none")
    return counts


def wall_of(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def layout_rollout_rates(torch, trainer, seed: int) -> dict:
    """Frames/s of a b16 16-frame CVAE rollout (upload to fetch, best of
    3), b1 latency (median of 5), and a profile and peak memory of one b16
    rollout."""
    from video_layout_generation_tpu_torch.models.vae import (
        make_cvae_rollout)
    rollout = make_cvae_rollout(trainer.model, LAYOUT_FRAMES, N_CLASSES)
    dev = trainer.device
    rng = np.random.default_rng(seed)
    s1, s2 = (rng.integers(0, N_CLASSES, (BATCH, LAYOUT_HW, LAYOUT_HW))
              .astype(np.uint8) for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def request(n):
        out = rollout(torch.from_numpy(s1[:n]).to(dev),
                      torch.from_numpy(s2[:n]).to(dev), gen)
        return out.to(torch.uint8).cpu()

    request(BATCH)
    walls = [wall_of(torch, lambda: request(BATCH)) for _ in range(3)]
    request(1)
    b1 = sorted(wall_of(torch, lambda: request(1)) for _ in range(5))[2]
    torch.cuda.reset_peak_memory_stats()
    prof = profile_call(f"CVAE rollout b{BATCH}, {LAYOUT_FRAMES} frames",
                        lambda: request(BATCH))
    return dict(fps=BATCH * LAYOUT_FRAMES / min(walls),
                b1_latency_ms=b1 * 1e3, busy_ms=prof["busy_ms"],
                wall_ms=prof["wall_ms"], idle=prof["idle"],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                groups=prof["groups"])


def first_val_prediction(torch, trainer):
    from video_layout_generation_tpu_torch.train.steps import decode_batch
    batch = decode_batch(next(iter(trainer.val_loader)))
    trainer._seed_noise(trainer.cfg.seed + 1, 0)
    return trainer.predict(batch)


def run_cvae_validation(torch, kern, seed: int) -> dict:
    """Part (a): the snapshot validated in bf16 and f32 with the same noise,
    the 16-frame rollout fidelity and the rollout's rates."""
    from video_layout_generation_tpu_torch.data.synthetic import (
        SyntheticTriplets)
    from video_layout_generation_tpu_torch.evaluation import (
        evaluate_layout_rollout)
    from video_layout_generation_tpu_torch.train.layout_trainer import (
        LayoutTrainer)
    cfg = layout_cfg(ckpt=CVAE_NPZ, synthetic_val_size=LAYOUT_VAL,
                     synthetic_train_size=BATCH)
    out = {}
    preds = {}
    for dtype in ("bfloat16", "float32"):
        t = LayoutTrainer(cfg.replace(compute_dtype=dtype), family="cvae",
                          latent_dim=LAYOUT_LATENT)
        check(len(t.warm_start_report["loaded"]) == 42
              and not t.warm_start_report["missing"],
              f"layout (a): the snapshot did not load whole "
              f"({len(t.warm_start_report['loaded'])} of 42)")
        t0 = time.perf_counter()
        val = t.validate()
        wall = time.perf_counter() - t0
        out[dtype] = dict(miou=val["miou"], pixel_acc=val["pixel_acc"],
                          val_samples_per_s=LAYOUT_VAL / wall)
        preds[dtype] = first_val_prediction(torch, t)
        if dtype == "bfloat16":
            ds = SyntheticTriplets(size=LAYOUT_SCENES,
                                   image_hw=cfg.image_size,
                                   seed=cfg.seed + 7)
            fid = evaluate_layout_rollout(t, ds, range(LAYOUT_SCENES),
                                          n_frames=LAYOUT_FRAMES)
            out["rollout_per_step_miou"] = [
                float(v) for v in fid["per_step_miou"]]
            out["rollout_mean_miou"] = fid["mean_miou"]
            out["rates"] = layout_rollout_rates(torch, t, seed)
        del t
    bf, f32 = out["bfloat16"], out["float32"]
    agree = float((preds["bfloat16"] == preds["float32"]).float().mean())
    out["bf16_f32_agreement"] = agree
    print(f"layout (a): CVAE config 3 (cvae256_036.npz, {LAYOUT_HW}^2, "
          f"latent {LAYOUT_LATENT}, b{BATCH}), validation over "
          f"{LAYOUT_VAL}: bf16 mIoU {bf['miou']:.4f} pixel accuracy "
          f"{bf['pixel_acc']:.4f}, f32 mIoU {f32['miou']:.4f} pixel accuracy "
          f"{f32['pixel_acc']:.4f}; the reference's figure (the JAX "
          f"package, BENCH_NOTES round 4) {JAX_CVAE_MIOU} / "
          f"{JAX_CVAE_PIXACC}; bf16 vs f32 layouts of the first batch "
          f"{agree:.5f} equal (TF32 off)", flush=True)
    print(f"layout (a): {LAYOUT_FRAMES}-frame rollout of {LAYOUT_SCENES} "
          f"scenes, per-step mIoU "
          + " ".join(f"{v:.4f}" for v in out["rollout_per_step_miou"])
          + f" (mean {out['rollout_mean_miou']:.4f}); the reference's "
          f"(round 4) " + " ".join(f"{v:.3f}" for v in JAX_CVAE_CURVE)
          + "; rates " + json.dumps(out["rates"]), flush=True)
    check(abs(bf["miou"] - f32["miou"]) <= CVAE_DTYPE_MIOU_TOL
          and agree >= CVAE_DTYPE_AGREEMENT,
          f"layout (a): bf16 vs f32 mIoU {bf['miou']} / {f32['miou']}, "
          f"layouts {agree} equal")
    check(abs(f32["miou"] - JAX_CVAE_MIOU) <= CVAE_MIOU_TOL,
          f"layout (a): f32 mIoU {f32['miou']} vs the JAX package's "
          f"{JAX_CVAE_MIOU}")
    check(len(out["rollout_per_step_miou"]) == LAYOUT_FRAMES
          and all(0.0 <= v <= 1.0 for v in out["rollout_per_step_miou"]),
          "layout (a): rollout fidelity")
    return out


class _RecordingState:
    """Wraps a TrainState's ``apply_gradients`` to keep the gradients."""

    def __init__(self, state):
        self.state, self.grads = state, None
        self.params, self.opt_state = state.params, state.opt_state

    def apply_gradients(self, grads):
        self.grads = {k: g.detach().float().cpu() for k, g in grads.items()}
        self.state.apply_gradients(grads)
        return self


def run_card_cpu_step(torch, seed: int) -> dict:
    """Step 1 of the K=3 exposure step from the snapshot, f32, on the card
    and on the CPU with the same window batch and noise."""
    from video_layout_generation_tpu_torch.data.synthetic import (
        SyntheticTriplets)
    from video_layout_generation_tpu_torch.io.checkpoint import (
        CheckpointManager)
    from video_layout_generation_tpu_torch.models.vae import (LayoutCVAE,
                                                              latent_hw)
    from video_layout_generation_tpu_torch.train.state import (
        TrainState, make_optimizer)
    from video_layout_generation_tpu_torch.train.vae_steps import (
        draw_cvae_noise, make_cvae_multistep_train_step)
    weights = CheckpointManager.restore_path(CVAE_NPZ)["params"]
    ds = SyntheticTriplets(CARD_CPU_BATCH, (LAYOUT_HW, LAYOUT_HW),
                           N_CLASSES, seed=seed + 31,
                           n_frames=EXPOSURE_K + 2)
    segs = torch.from_numpy(np.stack([ds[i]["segs"]
                                      for i in range(CARD_CPU_BATCH)]))
    noise = draw_cvae_noise(EXPOSURE_K, CARD_CPU_BATCH,
                            (LAYOUT_HW, LAYOUT_HW), LAYOUT_LATENT, N_CLASSES,
                            "prior", 0.0, torch.Generator().manual_seed(seed),
                            "cpu")
    runs = {}
    for where in (DEVICE, "cpu"):
        model = LayoutCVAE(N_CLASSES, LAYOUT_LATENT)
        model.load_state_dict(weights, strict=True)
        model.to(where)
        state = _RecordingState(TrainState.create(
            model, make_optimizer("adam", EXPOSURE_LR, 0.9)))
        step = make_cvae_multistep_train_step(model, N_CLASSES,
                                              k=EXPOSURE_K, device=where)
        moved = {k: ([t.to(where) for t in v] if isinstance(v, list)
                     else v.to(where)) for k, v in noise.items()}
        _, metrics = step(state, segs, EXPOSURE_BETA, noise=moved)
        runs[where] = ({k: float(v) for k, v in metrics.items()},
                       state.grads)
    (card_m, card_g), (cpu_m, cpu_g) = runs[DEVICE], runs["cpu"]
    loss_rel = max(abs(card_m[k] - cpu_m[k]) / abs(cpu_m[k])
                   for k in ("loss", "recon"))
    lat_h, lat_w = latent_hw(LAYOUT_HW, LAYOUT_HW)
    kl_per_element = abs(card_m["kl"] - cpu_m["kl"]) / (
        lat_h * lat_w * LAYOUT_LATENT)
    num = sum(float(((card_g[k] - cpu_g[k]) ** 2).sum()) for k in cpu_g)
    den = sum(float((cpu_g[k] ** 2).sum()) for k in cpu_g)
    grad_l2 = (num / den) ** 0.5
    # the snapshot's encoder trunks are dead (ReLU 0 everywhere: a
    # collapsed posterior and prior), so their gradients are exactly 0
    zero = sorted(k for k in cpu_g if float(cpu_g[k].norm()) == 0.0)
    worst = max(float((card_g[k] - cpu_g[k]).norm() / cpu_g[k].norm())
                for k in cpu_g if k not in zero)
    out = dict(metrics_card=card_m, metrics_cpu=cpu_m, loss_rel=loss_rel,
               kl_err_per_element=kl_per_element, grad_l2=grad_l2,
               worst_tensor_l2=worst, zero_gradients_cpu=len(zero),
               zero_gradients_card=sum(
                   float(card_g[k].norm()) == 0.0 for k in card_g),
               tf32=bool(torch.backends.cudnn.allow_tf32))
    print(f"layout (b): K={EXPOSURE_K} step 1 from the snapshot, f32, card "
          f"vs CPU at b{CARD_CPU_BATCH} with the same batch and noise "
          f"(cuDNN TF32 {'on' if out['tf32'] else 'off'}): "
          + json.dumps(out), flush=True)
    check(loss_rel <= CARD_CPU_LOSS_RTOL and grad_l2 <= CARD_CPU_GRAD_L2
          and kl_per_element <= CARD_CPU_KL_PER_ELEMENT,
          f"layout (b): card vs CPU loss {loss_rel}, KL {kl_per_element} "
          f"an element, gradients {grad_l2} in L2")
    return out


def layout_cli_argv(path: str, family: str, size: int, batch: int,
                    epochs: int, *extra) -> list:
    return ["--family", family, "--size", str(size), "-bs", str(batch),
            "-e", str(epochs), "--synthetic_train_size", str(LAYOUT_TRAIN),
            "--synthetic_val_size", str(LAYOUT_CLI_VAL), "-p", path,
            "--device", DEVICE, *extra]


def epoch_rate(trainer) -> dict:
    st = trainer.epoch_stats
    return dict(samples_per_s=st["samples"] / st["wall_s"],
                wall_s=st["wall_s"], steps=st["steps"])


def run_layout_families(torch, kern, seed: int):
    """Parts (a) to (d) of phase 13; returns its launches (none) and its
    numbers."""
    import shutil
    import tempfile
    from video_layout_generation_tpu_torch import layout_cli
    from video_layout_generation_tpu_torch.data.synthetic import (
        SyntheticTriplets)
    from video_layout_generation_tpu_torch.evaluation import (
        evaluate_layout_rollout)
    from video_layout_generation_tpu_torch.train.layout_trainer import (
        LayoutTrainer)

    kern.reset_launch_counts()
    t_phase = time.perf_counter()
    stats = {"cvae": run_cvae_validation(torch, kern, seed)}
    check_no_launches(kern, "(a)")
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="vlg_layout_")
    try:
        # -- (b) CVAE training through layout_cli, the K=3 leg ------------
        cli_path = os.path.join(root, "cvae")
        trainer = layout_cli.build_trainer(layout_cli_argv(
            cli_path, "cvae", LAYOUT_HW, BATCH, 2, "--latent_dim",
            str(LAYOUT_LATENT), "--seed", str(1024 + seed)))
        fit_b = layout_cli.run(trainer)
        stats["cvae_cli"] = dict(epoch_rate(trainer), miou=fit_b["miou"],
                                 pixel_acc=fit_b["pixel_acc"])
        check(trainer.global_step == 2 * LAYOUT_TRAIN // BATCH
              and os.path.isdir(os.path.join(cli_path, "checkpoint", "002")),
              f"layout (b): CLI run ended at step {trainer.global_step}")
        saved_b = dict(val=fit_b, cfg=trainer.cfg)
        del trainer
        leg = LayoutTrainer(layout_cfg(
            ckpt=CVAE_NPZ, lr=EXPOSURE_LR, multistep_k=EXPOSURE_K,
            synthetic_train_size=LAYOUT_TRAIN,
            synthetic_val_size=LAYOUT_CLI_VAL, epochs=1,
            seed=1024 + seed), family="cvae", latent_dim=LAYOUT_LATENT,
            beta_max=EXPOSURE_BETA)
        check(leg.train_loader.loader.ds.n_frames == EXPOSURE_K + 2,
              "layout (b): the K=3 leg's windows are not K+2 frames")
        first = leg.train_epoch()
        stats["exposure"] = dict(epoch_rate(leg), loss=first["loss"])
        check(np.isfinite(first["loss"]), f"layout (b): K=3 loss {first}")
        del leg
        stats["card_cpu"] = run_card_cpu_step(torch, seed)
        print(f"layout (b): CVAE through layout_cli ({LAYOUT_HW}^2, b{BATCH},"
              f" 2 epochs of {LAYOUT_TRAIN}) " + json.dumps(
                  stats["cvae_cli"]) + f"; the K={EXPOSURE_K} exposure leg "
              f"(snapshot, lr {EXPOSURE_LR}, {EXPOSURE_K + 2}-frame windows)"
              f" one epoch " + json.dumps(stats["exposure"]), flush=True)
        check_no_launches(kern, "(b)")

        # -- (c) ConvLSTM config 2 and VAE config 1 -----------------------
        # two epochs each: the second's rate is the steady one (the first
        # renders the synthetic samples and meets cuDNN's shapes first)
        lstm = layout_cli.build_trainer(layout_cli_argv(
            os.path.join(root, "convlstm"), "convlstm", LSTM_HW, BATCH, 2,
            "--hidden", str(LSTM_HIDDEN), "--rollout_frames",
            str(LSTM_FRAMES), "--seed", str(1024 + seed)))
        fit_c = layout_cli.run(lstm)
        fid = evaluate_layout_rollout(
            lstm, SyntheticTriplets(size=LAYOUT_SCENES,
                                    image_hw=(LSTM_HW, LSTM_HW),
                                    seed=lstm.cfg.seed + 7),
            range(LAYOUT_SCENES), n_frames=LSTM_FRAMES)
        stats["convlstm"] = dict(epoch_rate(lstm), miou=fit_c["miou"],
                                 rollout_per_step_miou=[
                                     float(v) for v in fid["per_step_miou"]])
        del lstm
        vae = layout_cli.build_trainer(layout_cli_argv(
            os.path.join(root, "vae"), "vae", VAE_HW, VAE_BATCH, 2,
            "--seed", str(1024 + seed)))
        fit_v = layout_cli.run(vae)
        stats["vae"] = dict(epoch_rate(vae), miou=fit_v["miou"])
        del vae
        print(f"layout (c): ConvLSTM config 2 ({LSTM_HW}^2, hidden "
              f"{LSTM_HIDDEN}, b{BATCH}), epoch 2 "
              + json.dumps(stats["convlstm"])
              + f"; VAE config 1 ({VAE_HW}^2, b{VAE_BATCH}), epoch 2 "
              + json.dumps(stats["vae"]), flush=True)
        check_no_launches(kern, "(c)")

        # -- (d) resume (b) -----------------------------------------------
        from video_layout_generation_tpu_torch.io.checkpoint import (
            CheckpointManager)
        saved = CheckpointManager.restore_path(
            os.path.join(cli_path, "checkpoint", "latest"))
        resumed = LayoutTrainer(saved_b["cfg"].replace(resume="latest",
                                                       epochs=3),
                                family="cvae", latent_dim=LAYOUT_LATENT)
        for name, t in resumed.model.state_dict().items():
            check(torch.equal(t.cpu(), saved["params"][name]),
                  f"layout (d): parameter {name} differs")
        for key in ("mu", "nu"):
            for name, t in resumed.state.opt_state[key].items():
                check(torch.equal(t.cpu(), saved["opt_state"][key][name]),
                      f"layout (d): moment {key} {name} differs")
        check(resumed.global_step == resumed.state.step == saved["step"]
              and resumed.epoch == 2
              and resumed.state.opt_state["count"]
              == saved["opt_state"]["count"],
              "layout (d): step / epoch / count differ from the checkpoint")
        val_d = resumed.validate()
        check(val_d["miou"] == saved_b["val"]["miou"]
              and val_d["pixel_acc"] == saved_b["val"]["pixel_acc"],
              f"layout (d): validation {val_d['miou']} after the resume, "
              f"{saved_b['val']['miou']} before")
        resumed.fit()
        check(resumed.epoch == 3, "layout (d): epoch 3 did not train")
        print(f"layout (d): resumed at epoch 2 step {saved['step']}: "
              f"parameters, moments, step and the first validation (mIoU "
              f"{val_d['miou']:.6f}) equal to the checkpoint's bits; epoch 3 "
              f"trained", flush=True)
        del resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = check_no_launches(kern, "(d)")
    torch.cuda.empty_cache()
    stats["phase_s"] = time.perf_counter() - t_phase
    r = stats["cvae"]["rates"]
    print(f"layout timing, card {card_line()}: CVAE rollout frames/s at "
          f"b{BATCH} {r['fps']:.1f} ({LAYOUT_FRAMES} frames), b1 latency "
          f"{r['b1_latency_ms']:.1f} ms, busy {r['busy_ms']:.1f} ms of "
          f"{r['wall_ms']:.1f} (idle share {r['idle']:.3f}), peak "
          f"{r['peak_gib']:.2f} GiB; train samples/s: CVAE CLI "
          f"{stats['cvae_cli']['samples_per_s']:.1f}, K={EXPOSURE_K} leg "
          f"{stats['exposure']['samples_per_s']:.1f}, ConvLSTM "
          f"{stats['convlstm']['samples_per_s']:.1f}, VAE "
          f"{stats['vae']['samples_per_s']:.1f}; phase 13 took "
          f"{stats['phase_s']:.1f} s; device ms by group "
          + json.dumps(r["groups"]), flush=True)
    return launches, stats


# ---- phase 14: data parallelism, the feeder thread, the native decoder ------
#
# (a) ``--put_thread`` on phase 11's fit loop; (b) the train loop inside an
# NCCL group of one rank against the same loop outside a group; (c) two
# ranks on the one card over Gloo with CUDA tensors against one process on
# the concatenated batches; (d) ``LayoutPredictor`` on a mesh of one device;
# (e) the native PNG decoder against cv2 / PIL and a Cityscapes epoch
# through it. (b) and (c) run in processes of their own, started here with
# the ``torchrun`` variables and waited for.

DP_TRAIN_STEPS = 2
DP_LOSS_RTOL = 1e-5      # loss terms, two ranks vs one process (bf16 nets)
# each gradient in L2 (GridNet's slopes as one tensor): bf16 nets, and the
# layout families' f32 nets, whose cuDNN convolutions take other algorithms
# at b8 than at b16 (seen: 2.3e-3 and 1.1e-3)
DP_GRAD_L2 = 1e-2
DP_TIMEOUT_S = 400
NCCL_TRAIN = 48          # (b): three train steps of b16, one validation
NATIVE_FRAMES = 15       # (e): one snippet of 15 frames holds 8 triplets
NATIVE_HW = (256, 512)   # Cityscapes' frames as the repo's tree holds them
RGB_ROUNDING = 2.5 / 255   # tests/test_native_loader.py: bilinear RGB


def batch_hashes(loader, epoch: int) -> list:
    """sha256 of every batch of one epoch of ``loader``, in order."""
    import hashlib
    loader.set_epoch(epoch)
    out = []
    for batch in loader:
        h = hashlib.sha256()
        for k in sorted(batch):
            h.update(k.encode())
            h.update(batch[k].cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


def traced_copies(torch, trainer, epoch: int, steps: int,
                  label: str) -> dict:
    """``traced_epoch`` of a loader that must copy each of its ``steps``
    batches to the card once, from pinned memory, and never from pageable
    memory. The runtime's ``cudaMemcpyAsync`` calls count the copies
    (``h2d``); every source buffer is checked to be pinned as the loader
    fills it; and no trace may hold a pageable copy record. The trace's
    pinned copy records are not all returned on the H100: over 48 traced
    epochs of 4 batches, 2, 3 or 4 records came back while the runtime saw
    4 copy calls every time and every source was pinned. So traces are
    taken until one holds every record; after ``COPY_TRACE_TRIES`` the one
    with the most records is kept (``records_complete`` False). The drops
    come in runs (six traces in a row once), so more tries buy little and
    cost phase 14 seconds."""
    from video_layout_generation_tpu_torch.data import pipeline
    fill = pipeline._Slot.fill
    sources = []

    def checked_fill(slot, host_batch):
        fill(slot, host_batch)
        sources.append(all(b.is_pinned() for b in slot.pinned.values()))

    pipeline._Slot.fill = checked_fill
    kept = None
    try:
        for attempt in range(COPY_TRACE_TRIES):
            retry_pause(attempt)
            sources.clear()
            tr = traced_epoch(torch, trainer, epoch + attempt,
                              LAUNCHES_PER_GRIDNET_TRAIN_STEP, label)
            check(tr["pageable"]["n"] == 0 and tr["pinned"]["n"] <= steps
                  and sources == [True] * steps,
                  f"{label}: records of copies to the card from pinned "
                  f"memory {tr['pinned']}, from pageable memory "
                  f"{tr['pageable']}, sources pinned {sources}; expected "
                  f"{steps} batches, all from pinned memory")
            # a dropped device-to-host record raises h2d: take it again
            if tr["h2d"] == steps and (kept is None or tr["pinned"]["n"]
                                       > kept["pinned"]["n"]):
                kept = tr
            if kept is not None and kept["pinned"]["n"] == steps:
                break
            print(f"{label}: {tr['h2d']} copies to the card from the "
                  f"runtime's calls, {tr['pinned']['n']} of {steps} pinned "
                  f"copy records came back; taking the trace again",
                  flush=True)
    finally:
        pipeline._Slot.fill = fill
    check(kept is not None and kept["pinned"]["n"] > 0,
          f"{label}: no trace counted {steps} copies to the card in "
          f"{COPY_TRACE_TRIES} tries (last {tr})")
    tr = kept
    tr["records_complete"] = tr["pinned"]["n"] == steps
    return tr


def run_put_thread(torch, kern, seed: int) -> dict:
    """(a): the same batches with and without the feeder thread, one pinned
    copy a batch, and the fit loop's rate in the order off, on, on, off."""
    import shutil
    import tempfile
    from video_layout_generation_tpu_torch import main as cli
    from video_layout_generation_tpu_torch.config import config_from_args
    root = tempfile.mkdtemp(prefix="vlg_put_thread_")
    try:
        trainer = cli.build_trainer(config_from_args(cli_argv(
            os.path.join(root, "exp"), "-e", "1", "--put_thread",
            "--seed", str(1024 + seed))))
        loader = trainer.train_loader
        steps = len(loader)
        check(loader.put_thread and trainer.val_loader.put_thread,
              "put_thread: the loaders do not run the feeder thread")
        hashes = {}
        for flag in (False, True):
            loader.put_thread = flag
            hashes[flag] = batch_hashes(loader, 7)
        check(len(hashes[True]) == steps and hashes[True] == hashes[False],
              f"put_thread: the batches differ from the thread-less "
              f"loader's ({hashes})")
        watch_steps(kern, trainer, {}, LAUNCHES_PER_GRIDNET_TRAIN_STEP)
        trainer.set_epoch(0)            # warm-up: cuDNN's shapes, the data
        trainer.train()
        legs = []
        for i, flag in enumerate((False, True, True, False)):
            loader.put_thread = flag
            leg = timed_epoch(torch, trainer, 1 + i)
            leg.update(put_thread=flag, comp_s=trainer.epoch_stats["comp_s"],
                       loader_wait_ms=leg["load_s"] / steps * 1e3)
            legs.append(leg)
        copies = {}
        for flag in (False, True):
            loader.put_thread = flag
            copies[flag] = traced_copies(torch, trainer, 20 + 10 * flag,
                                         steps, f"put_thread {flag}")
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rate = {flag: np.mean([leg["samples_per_s"] for leg in legs
                           if leg["put_thread"] == flag])
            for flag in (False, True)}
    for leg in legs:
        print(f"put_thread (a): leg put_thread={leg['put_thread']}: "
              f"{leg['samples_per_s']:.1f} samples/s at b{BATCH}, epoch "
              f"wall {leg['wall_s']:.3f} s, loader wait "
              f"{leg['loader_wait_ms']:.2f} ms a step, compute "
              f"{leg['comp_s']:.3f} s", flush=True)
    print(f"put_thread (a): {steps} batches of one epoch equal by sha256 "
          f"with and without the thread; copies to the card a traced epoch "
          f"without / with the thread: runtime h2d calls "
          f"{copies[False]['h2d']} / {copies[True]['h2d']}, every source "
          f"pinned, pinned records {copies[False]['pinned']} / "
          f"{copies[True]['pinned']} (complete "
          f"{copies[False]['records_complete']} / "
          f"{copies[True]['records_complete']}), pageable "
          f"{copies[False]['pageable']} / {copies[True]['pageable']}; mean "
          f"samples/s "
          f"off {rate[False]:.1f}, on {rate[True]:.1f}", flush=True)
    return dict(legs=legs, samples_per_s_off=rate[False],
                samples_per_s_on=rate[True],
                busy_ms_step={str(f): copies[f]["busy_ms_step"]
                              for f in copies})


def launch_env(rank: int, world: int, port: int) -> dict:
    """The variables ``torchrun`` sets, for a process on this one card."""
    return dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                PYTHONUNBUFFERED="1")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, call: str, label: str) -> list:
    """Start ``world`` processes that run ``chip_smoke.<call>`` with the
    launch variables, wait for every one (killing them all on a failure or
    at ``DP_TIMEOUT_S``), print their output and return each one's result
    (a ``torch.save`` file)."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = tempfile.mkdtemp(prefix="vlg_ranks_")
    port = free_port()
    procs = []
    try:
        for r in range(world):
            code = (f"import sys, chip_smoke; "
                    f"sys.exit(chip_smoke.{call}({out_dir!r}))")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=here,
                env=launch_env(r, world, port), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + DP_TIMEOUT_S
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith(("rank", "Traceback", "  ", "SmokeFailure",
                                "RuntimeError", "AssertionError")) \
                    or "Error" in line:
                print(f"{label} rank {r}: {line}", flush=True)
        check(p.returncode == 0, f"{label}: rank {r} exited "
              f"{p.returncode}:\n{out[-4000:]}")
    import torch
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _deterministic(torch):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def nccl_fit_leg(torch, path: str, seed: int) -> dict:
    """Three train steps and one validation of the CLI's Trainer (phase
    11's configuration) from a fixed seed: parameters and validation."""
    from video_layout_generation_tpu_torch.config import config_from_args
    from video_layout_generation_tpu_torch.train.trainer import Trainer
    trainer = Trainer(config_from_args(cli_argv(
        path, "-e", "1", "--synthetic_train_size", str(NCCL_TRAIN),
        "--seed", str(1024 + seed))))
    val = trainer.fit()
    out = dict(params={k: v.detach().cpu().clone()
                       for k, v in trainer.model.state_dict().items()},
               loss=val["loss"], iou=np.asarray(val["per_class_iou"]),
               steps=trainer.global_step)
    out["trainer"] = trainer
    return out


def nccl_world1_worker(out_dir: str, seed: int = 0) -> int:
    """(b), in a process of its own: the fit leg outside a group, then
    inside an NCCL group of one rank, and one more step in the group under
    the profiler (the all-reduce's device time and bytes)."""
    import shutil
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from video_layout_generation_tpu_torch.parallel import (
        in_group, maybe_initialize_distributed)
    _deterministic(torch)
    legs = {}
    try:
        legs["outside"] = nccl_fit_leg(torch, os.path.join(out_dir, "a"),
                                       seed)
        legs["outside"].pop("trainer")
        check(maybe_initialize_distributed("cuda") and in_group()
              and torch.distributed.get_backend() == "nccl",
              "NCCL: no group")
        legs["inside"] = nccl_fit_leg(torch, os.path.join(out_dir, "b"),
                                      seed)
        trainer = legs["inside"].pop("trainer")
        batch = next(iter(trainer.train_loader))
        n_params = sum(p.numel() for p in trainer.model_state.params.values())
        for attempt in range(TRACE_TRIES):
            retry_pause(attempt)
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                trainer._train_step(trainer.state, batch)
                torch.cuda.synchronize()
            rows = [ev for ev in prof.key_averages() if on_device(torch, ev)]
            a = sum(ev.count for ev in rows if "conv3x3_mma_kernel" in ev.key)
            if a == LAUNCHES_PER_GRIDNET_TRAIN_STEP["prelu_conv3x3"]:
                break
        else:
            raise SmokeFailure("NCCL: no complete trace of a step")
        # NCCL may run a one-rank all-reduce as a copy, or not at all
        nccl = [ev for ev in rows if "nccl" in ev.key.lower()]
        legs["allreduce"] = dict(
            ms=sum(ev.self_device_time_total for ev in nccl) / 1e3,
            count=sum(ev.count for ev in nccl),
            bytes=4 * (n_params + 4), kernels=[ev.key for ev in nccl])
        torch.distributed.destroy_process_group()
        torch.save(legs, os.path.join(out_dir, "rank0.pt"))
    finally:
        for d in ("a", "b"):
            shutil.rmtree(os.path.join(out_dir, d), ignore_errors=True)
    return 0


def run_nccl_world1(torch) -> dict:
    """(b): the group's collectives at world size 1 change no bit."""
    legs = run_ranks(1, "nccl_world1_worker", "NCCL world 1")[0]
    a, b = legs["outside"], legs["inside"]
    check(a["steps"] == b["steps"] == NCCL_TRAIN // BATCH,
          f"NCCL: steps {a['steps']}, {b['steps']}")
    differ = [k for k in a["params"]
              if not torch.equal(a["params"][k], b["params"][k])]
    check(not differ, f"NCCL world 1: {len(differ)} parameters differ from "
          f"the run outside a group, first {differ[:3]}")
    check(a["loss"] == b["loss"]
          and np.array_equal(a["iou"], b["iou"], equal_nan=True),
          f"NCCL world 1: validation {b['loss']!r} vs {a['loss']!r}")
    ar = legs["allreduce"]
    print(f"NCCL world 1 (b): {a['steps']} train steps and one validation "
          f"inside an NCCL group of one rank equal the run outside a group "
          f"bit for bit ({len(a['params'])} parameters, validation loss "
          f"{a['loss']!r}, per-class IoU); the gradient all-reduce "
          f"{ar['ms']:.3f} device ms a step ({ar['count']} kernels "
          f"{sorted(set(ar['kernels']))}), {ar['bytes']} bytes", flush=True)
    return dict(allreduce_ms=ar["ms"], allreduce_bytes=ar["bytes"])


# --- (c): two ranks on one card ----------------------------------------------

def rows_of(x):
    """This rank's rows of a global batch (all of it outside a group)."""
    from video_layout_generation_tpu_torch.parallel.mesh import (
        local_rows, process_count, process_index)
    return local_rows(x, process_index(), process_count())


def dp_coord_train(torch, kern, seed: int) -> dict:
    """``DP_TRAIN_STEPS`` CoordGridNet train steps at the global b16 (HNED,
    VGG19, a per-example flip): each step's terms and launches, step 1's
    gradients."""
    from video_layout_generation_tpu_torch.train.steps import make_train_step
    weights = edge_mode_weights(seed)
    net = build_gridnet(torch, "CoordGridNet",
                        gridnet_train_weights(seed)["CoordGridNet"])
    hned, combined = frozen_nets(torch, weights)
    step = make_train_step(net, hned, combined, flip_mode="per_example",
                           device=DEVICE,
                           generator=torch.Generator().manual_seed(seed + 7))
    state = recording_state(net, adam())
    out = dict(metrics=[], launches=[])
    for s in range(DP_TRAIN_STEPS):
        kern.reset_launch_counts()
        state, m = step(state, {"packed6": rows_of(
            make_packed_batch(BATCH, seed + s)["packed6"])})
        torch.cuda.synchronize()
        out["launches"].append(kern.launch_counts())
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if s == 0:
            out["grads"] = {k: g.float().cpu()
                            for k, g in slopes_as_one(
                                torch, state.last_grads).items()}
    return out


def dp_layout_steps(torch, seed: int) -> dict:
    """One VAE step (64x64, class weights, free bits, capacity) and one
    CVAE step (256x256, latent 64), f32 on the card: terms and gradients."""
    from video_layout_generation_tpu_torch.models.vae import (LayoutCVAE,
                                                              LayoutVAE)
    from video_layout_generation_tpu_torch.train.vae_steps import (
        make_cvae_train_step, make_vae_train_step)
    rng = np.random.default_rng(seed + 40)
    out = {}
    vae = LayoutVAE(N_CLASSES, 32, generator=torch.Generator().manual_seed(
        seed + 41)).to(DEVICE)
    ids = torch.from_numpy(rng.integers(0, N_CLASSES, (BATCH, 8, 8)).repeat(
        8, 1).repeat(8, 2))
    ids[BATCH // 2:] = 0                 # rank 1's rows all background
    step = make_vae_train_step(
        vae, N_CLASSES, free_bits=0.05, use_capacity=True,
        class_weights=[0.25] + [1.0] * (N_CLASSES - 1), device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(seed + 42))
    state = recording_state(vae, adam())
    _, m = step(state, rows_of(ids), 0.5, 2.0)
    out["vae"] = dict(metrics={k: float(v) for k, v in m.items()},
                      grads={k: g.cpu() for k, g in state.last_grads.items()})
    cvae = LayoutCVAE(N_CLASSES, 64, generator=torch.Generator().manual_seed(
        seed + 43)).to(DEVICE)
    win = torch.from_numpy(rng.integers(0, N_CLASSES, (BATCH, 3, 32, 32))
                           .repeat(8, 2).repeat(8, 3))
    step = make_cvae_train_step(
        cvae, N_CLASSES, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(seed + 44))
    state = recording_state(cvae, adam())
    _, m = step(state, rows_of(win[:, :2]), rows_of(win[:, 2]), 0.7)
    out["cvae"] = dict(metrics={k: float(v) for k, v in m.items()},
                       grads={k: g.cpu() for k, g in state.last_grads.items()})
    return out


def dp_validation(torch, kern, seed: int) -> dict:
    """``validate`` of the edge-mode eval step over one global batch."""
    from video_layout_generation_tpu_torch.io.weights import params_from_flax
    from video_layout_generation_tpu_torch.models import GridNet
    from video_layout_generation_tpu_torch.train.steps import make_eval_step
    from video_layout_generation_tpu_torch.train.trainer import validate
    weights = edge_mode_weights(seed)
    net = GridNet(n_channels=10, filters_level=FILTERS, dtype=torch.bfloat16)
    net.load_state_dict(params_from_flax(weights["gridnet"]), strict=True)
    hned, combined = frozen_nets(torch, weights)
    step = make_eval_step(net, hned, combined, n_classes=N_CLASSES,
                          device=DEVICE)
    kern.reset_launch_counts()
    val = validate(step, [{"packed6": rows_of(
        make_packed_batch(BATCH, seed + 50)["packed6"])}], N_CLASSES)
    return dict(loss=val["loss"], iou=np.asarray(val["per_class_iou"]),
                miou=val["miou"], launches=kern.launch_counts())


def dp_scenarios(torch, kern, seed: int) -> dict:
    return dict(train=dp_coord_train(torch, kern, seed),
                layout=dp_layout_steps(torch, seed),
                validation=dp_validation(torch, kern, seed))


def dp_rank_worker(out_dir: str, seed: int = 0) -> int:
    """(c), in a process of its own: one rank of a Gloo group on the card."""
    import torch
    from video_layout_generation_tpu_torch.ops import kernels as kern
    from video_layout_generation_tpu_torch.parallel import (
        maybe_initialize_distributed, process_index)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    check(maybe_initialize_distributed("cuda", backend="gloo"),
          "Gloo: no group")
    out = dp_scenarios(torch, kern, seed)
    print(f"rank {process_index()}: launches a train step "
          f"{out['train']['launches']}, a validation batch "
          f"{out['validation']['launches']}", flush=True)
    torch.save(out, os.path.join(out_dir, f"rank{process_index()}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def run_two_ranks(torch, kern, seed: int) -> dict:
    """(c): two Gloo ranks with CUDA tensors on the card against this
    process on the concatenated batches."""
    import threading
    ranks = {}

    def start():
        ranks["out"] = run_ranks(2, "dp_rank_worker", "two ranks")

    t = threading.Thread(target=start)
    t.start()
    ref = dp_scenarios(torch, kern, seed)       # meanwhile, one process
    t.join()
    check("out" in ranks, "two ranks: the rank processes failed")
    worst = dict(loss_rel=0.0, grad_l2=0.0, f32_grad_l2=0.0)
    for r, got in enumerate(ranks["out"]):
        for s, launches in enumerate(got["train"]["launches"]):
            want = LAUNCHES_PER_GRIDNET_TRAIN_STEP
            check(launches == want, f"two ranks: rank {r} step {s + 1} "
                  f"launches {launches}, expected {want}")
        check(got["validation"]["launches"] == LAUNCHES_PER_EVAL_STEP,
              f"two ranks: rank {r} validation launches "
              f"{got['validation']['launches']}")
        pairs = list(zip(got["train"]["metrics"], ref["train"]["metrics"]))
        pairs += [(got["layout"][f]["metrics"], ref["layout"][f]["metrics"])
                  for f in ("vae", "cvae")]
        for m_got, m_ref in pairs:
            for k in m_ref:
                worst["loss_rel"] = max(worst["loss_rel"],
                                        _rel(m_got[k], m_ref[k]))
        l2 = per_tensor_l2(torch, got["train"]["grads"],
                           ref["train"]["grads"])
        worst["grad_l2"] = max(worst["grad_l2"], max(l2.values()))
        for f in ("vae", "cvae"):
            l2 = per_tensor_l2(torch, got["layout"][f]["grads"],
                               ref["layout"][f]["grads"])
            worst["f32_grad_l2"] = max(worst["f32_grad_l2"],
                                       max(l2.values()))
        v_got, v_ref = got["validation"], ref["validation"]
        check(np.array_equal(v_got["iou"], v_ref["iou"], equal_nan=True),
              f"two ranks: rank {r} per-class IoU {v_got['iou']} vs "
              f"{v_ref['iou']}")
        worst["loss_rel"] = max(worst["loss_rel"],
                                _rel(v_got["loss"], v_ref["loss"]))
    print(f"two ranks (c): Gloo with CUDA tensors on one card, global b"
          f"{BATCH}, {BATCH // 2} a rank: {DP_TRAIN_STEPS} CoordGridNet "
          f"train steps ({LAUNCHES_PER_GRIDNET_TRAIN_STEP['prelu_conv3x3']} "
          f"A and {LAUNCHES_PER_GRIDNET_TRAIN_STEP['fused_lateral']} B a "
          f"step a rank), a VAE step (class weights, free bits, capacity), "
          f"a CVAE step and a validation against one process on the "
          f"concatenated batches: worst loss term relative error "
          f"{worst['loss_rel']:.3e} (limit {DP_LOSS_RTOL}), worst bf16 "
          f"gradient L2 {worst['grad_l2']:.3e} (limit {DP_GRAD_L2}), worst "
          f"f32 layout gradient L2 {worst['f32_grad_l2']:.3e} (limit "
          f"{DP_GRAD_L2}), per-class IoU equal; train terms "
          + json.dumps(ref["train"]["metrics"]), flush=True)
    check(worst["loss_rel"] <= DP_LOSS_RTOL and worst["grad_l2"]
          <= DP_GRAD_L2 and worst["f32_grad_l2"] <= DP_GRAD_L2,
          f"two ranks: {worst}")
    return worst


def run_serving_mesh(torch, kern, seed: int) -> dict:
    """(d): ``LayoutPredictor(mesh=make_mesh())`` on this card equals the
    predictor without a mesh, bit for bit; its overhead a b16 request."""
    from video_layout_generation_tpu_torch.parallel import make_mesh
    from video_layout_generation_tpu_torch.serving import LayoutPredictor
    flat = random_flat_params(seed)
    kw = dict(n_frames=FRAMES, batch=BATCH, image_hw=HW,
              filters_level=FILTERS, use_bf16=True, device=DEVICE)
    mesh = make_mesh()
    check(mesh.size == 1 and mesh.devices[0].type == DEVICE,
          f"serving mesh: {mesh}")
    preds = {"no mesh": LayoutPredictor("GridNet", flat, **kw),
             "mesh": LayoutPredictor("GridNet", flat, mesh=mesh, **kw)}
    req = make_request(BATCH, seed + 60)
    outs = {name: p.predict(*req) for name, p in preds.items()}
    check(all(a.tobytes() == b.tobytes() for a, b in
              zip(outs["mesh"], outs["no mesh"])),
          "serving mesh: the one-device mesh differs from no mesh")
    ms = {}
    for name in ("no mesh", "mesh", "mesh", "no mesh"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            preds[name].predict(*req)
        ms.setdefault(name, []).append((time.perf_counter() - t0) / 3 * 1e3)
    ms = {k: float(np.mean(v)) for k, v in ms.items()}
    print(f"serving mesh (d): make_mesh() {mesh.shape} on "
          f"{mesh.devices[0]}: frames and layouts equal to no mesh bit for "
          f"bit; a b{BATCH} request of {FRAMES} frames {ms['mesh']:.2f} ms "
          f"with the mesh, {ms['no mesh']:.2f} ms without (overhead "
          f"{ms['mesh'] - ms['no mesh']:+.2f} ms)", flush=True)
    return dict(ms_mesh=ms["mesh"], ms_no_mesh=ms["no mesh"])


def write_png(path: str, pixels: np.ndarray) -> None:
    """(H, W, 3) RGB or (H, W) gray uint8 as a PNG: the native writer where
    it is built, else cv2, else PIL."""
    from video_layout_generation_tpu_torch.evaluation.export import (
        png_writer)
    writer = png_writer()
    if writer:
        writer.save_png(path, pixels)
        return
    try:
        import cv2
        cv2.imwrite(path, pixels[..., ::-1] if pixels.ndim == 3 else pixels)
    except ImportError:
        from PIL import Image
        Image.fromarray(pixels).save(path)


def write_native_tree(root: str, seed: int) -> None:
    """A Cityscapes tree of one 15-frame snippet at 256x512 (8 triplets),
    frames and layouts from the synthetic dataset, written as PNGs."""
    from video_layout_generation_tpu_torch.data.synthetic import (
        SyntheticTriplets)
    ds = SyntheticTriplets(NATIVE_FRAMES // 3, NATIVE_HW, N_CLASSES,
                           seed=seed + 70, emit_uint8=True)
    for sub in ("leftImg256", "deeplab256_label"):
        os.makedirs(os.path.join(root, sub, "synth"), exist_ok=True)
    for f in range(NATIVE_FRAMES):
        s = ds[f // 3]
        stem = f"synth_000001_{f:06d}"
        write_png(os.path.join(root, "leftImg256", "synth",
                               f"{stem}_leftImg8bit.png"),
                  np.ascontiguousarray(s[f"img{f % 3 + 1}"]))
        write_png(os.path.join(root, "deeplab256_label", "synth",
                               f"{stem}_gtFine_myseg_id.png"),
                  s[f"seg{f % 3 + 1}"].reshape(NATIVE_HW).astype(np.uint8))


def decode_ms(ds) -> float:
    """Host ms to read one triplet of ``ds``, over all of them."""
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    return (time.perf_counter() - t0) / len(ds) * 1e3


def run_native_decoder(torch, kern, seed: int) -> dict:
    """(e): the native decoder, built here, against cv2 / PIL on the
    Cityscapes shape (where it builds); then one epoch of the CLI over that
    tree with the decoder the dataset chose."""
    import shutil
    import tempfile
    from video_layout_generation_tpu_torch import main as cli
    from video_layout_generation_tpu_torch.config import config_from_args
    from video_layout_generation_tpu_torch.data import cityscapes
    from video_layout_generation_tpu_torch.io import native_loader
    t0 = time.perf_counter()
    try:
        native_loader.build()
        built = f"built in {time.perf_counter() - t0:.1f} s"
    except OSError as e:
        built = f"did not build: {e}"
    root = tempfile.mkdtemp(prefix="vlg_native_")
    try:
        write_native_tree(root, seed)
        ds = cityscapes.CityscapesTriplets(root, HW)
        plain = cityscapes.CityscapesTriplets(root, HW, use_native=False)
        check(len(ds) == 8, f"native: {len(ds)} triplets")
        print(f"native (e): the native decoder {built}; the dataset "
              f"decodes with '{ds.decoder}', without the native decoder "
              f"with '{plain.decoder}'", flush=True)
        out = dict(decoder=ds.decoder, fallback=plain.decoder,
                   rgb_err=None, decode_ms_native=None)
        if ds.decoder == "native":
            worst = 0.0
            for i in range(len(ds)):
                a, b = ds[i], plain[i]
                for k in ("seg1", "seg2", "seg3"):
                    check(a[k].tobytes() == b[k].tobytes(),
                          f"native: triplet {i} {k} ids differ from "
                          f"{plain.decoder}'s")
                for k in ("img1", "img2", "img3"):
                    worst = max(worst, float(np.abs(a[k] - b[k]).max()))
            check(worst <= RGB_ROUNDING, f"native: RGB {worst} from "
                  f"{plain.decoder}'s (limit {RGB_ROUNDING})")
            out["rgb_err"] = worst
            ms = [decode_ms(d) for d in (ds, plain, plain, ds)]
            out["decode_ms_native"] = (ms[0] + ms[3]) / 2
            out["decode_ms_fallback"] = (ms[1] + ms[2]) / 2
        else:
            out["decode_ms_fallback"] = (decode_ms(plain)
                                         + decode_ms(plain)) / 2
        trainer = cli.build_trainer(config_from_args([
            "--dataset", "cityscape", "--train_dir", root, "--val_dir", root,
            "-bs", "4", "-e", "1", "--put_thread", "--image_size",
            *map(str, HW), "--filters_level", *map(str, FILTERS),
            "--hed_weights", HNED_NPZ, "--vgg_weights", VGG_NPZ, "-p",
            os.path.join(root, "exp"), "--device", DEVICE,
            "--seed", str(1024 + seed)]))
        check(trainer.train_loader.loader.ds.decoder == ds.decoder,
              "native: the CLI's dataset chose another decoder")
        val = cli.run_trainer(trainer)
        check(trainer.global_step == 2 and np.isfinite(val["loss"]),
              f"native: the epoch ran {trainer.global_step} steps, "
              f"validation {val}")
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    compared = ("not compared: the native decoder is not built here"
                if out["rgb_err"] is None else
                f"native against {plain.decoder}: layout ids equal bit for "
                f"bit, RGB within {out['rgb_err']:.5f} (limit "
                f"{RGB_ROUNDING:.5f}), decode ms a triplet native "
                f"{out['decode_ms_native']:.2f}")
    print(f"native (e): 8 triplets of {NATIVE_HW} PNGs decoded to {HW}: "
          f"{compared}; {plain.decoder} {out['decode_ms_fallback']:.2f} ms "
          f"a triplet; one --put_thread CLI epoch over them with "
          f"'{ds.decoder}' (2 steps of b4, validation loss "
          f"{val['loss']:.4f})", flush=True)
    return out


def run_data_parallel(torch, kern, seed: int):
    """Phase 14, parts (a) to (e); returns the phase's launches in this
    process and its numbers."""
    kern.reset_launch_counts()
    t_phase = time.perf_counter()
    stats = dict(put_thread=run_put_thread(torch, kern, seed))
    torch.cuda.empty_cache()
    stats["nccl_world1"] = run_nccl_world1(torch)
    stats["two_ranks"] = run_two_ranks(torch, kern, seed)
    torch.cuda.empty_cache()
    stats["serving_mesh"] = run_serving_mesh(torch, kern, seed)
    kern.reset_launch_counts()      # (c)'s reference launched in between
    stats["native"] = run_native_decoder(torch, kern, seed)
    launches = kern.launch_counts()
    stats["phase_s"] = time.perf_counter() - t_phase
    a = stats["put_thread"]
    print(f"data parallel timing, card {card_line()}: fit loop samples/s at "
          f"b{BATCH} without / with --put_thread {a['samples_per_s_off']:.1f}"
          f" / {a['samples_per_s_on']:.1f}; NCCL all-reduce "
          f"{stats['nccl_world1']['allreduce_ms']:.3f} device ms a step "
          f"({stats['nccl_world1']['allreduce_bytes']} bytes); serving mesh "
          f"overhead {stats['serving_mesh']['ms_mesh'] - stats['serving_mesh']['ms_no_mesh']:+.2f}"
          f" ms a request; Cityscapes decode with "
          f"'{stats['native']['decoder']}', {stats['native']['fallback']} "
          f"{stats['native']['decode_ms_fallback']:.2f} ms a triplet; "
          f"phase 14 took "
          f"{stats['phase_s']:.1f} s", flush=True)
    return launches, stats


# ---- phase 15: legacy layout completion (UNet, EncoderDecoder, val) --------
#
# (a) Simple in both modes on the card against the CPU, f32 with TF32 off;
# (b) the val CLI end to end at the reference's eval contract, 1024x2048, in
# the precision the CLI runs in (PyTorch's default: cuDNN convolutions in
# TF32); (c) --data_parallel on the mesh of the one card; (d) mask2box and
# resize_nearest on the card against the CPU; (e) utils.profiling's trace on
# the card. The convs are the library's, as the JAX package's are XLA's: no
# kernel of the port runs and every launch counter must stay 0.

LEGACY_MODELS = ("u_net", "encoder_decoder")
LEGACY_CLASSES, LEGACY_EMBED = 29, 15
LEGACY_CARD_CPU_HW = (256, 512)
LEGACY_CARD_CPU_BATCH = 2
LEGACY_HW = (1024, 2048)     # the reference's eval contract (src/val.py:176)
LEGACY_BATCH = 2
LEGACY_SAMPLES = 8
LEGACY_PNG_THREADS = 4
# (a), f32 card (TF32 off) against f32 CPU, stated before the first run:
# the logits' largest difference over their largest value, the share of
# equal argmax ids, and each running statistic after one train=True
# forward, of max(1, |CPU value|)
LEGACY_LOGIT_RTOL = 1e-4
LEGACY_ARGMAX_AGREEMENT = 0.9999
LEGACY_STATS_TOL = 1e-5
LEGACY_ANNOTATION = "vlg_legacy_completion"


def legacy_check_no_launches(kern, label: str) -> dict:
    counts = kern.launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"legacy {label}: hand-written kernels launched {counts}, "
          f"expected none")
    return counts


def legacy_model(torch, name: str, seed: int):
    """``Simple`` with random weights from ``seed``, its conv kernels
    scaled by sqrt(2) (He instead of LeCun: activations keep their size
    through the ReLUs), and EncoderDecoder's last conv by 4 more: its
    composite adds the one-hot ground truth inside the crop, and at LeCun
    scale the random logits (std about 0.25 there) never outweigh it, so
    every id would be the ground truth's. Scaled, the logits decide most
    of the crop's ids."""
    from video_layout_generation_tpu_torch.models.layers import Conv
    from video_layout_generation_tpu_torch.models.legacy import Simple
    model = Simple(LEGACY_CLASSES, LEGACY_EMBED, name,
                   generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                m.kernel.mul_(2 ** 0.5)
        if name == "encoder_decoder":
            model.layer.Conv_16.kernel.mul_(4.0)
    return model


def run_legacy_card_cpu(torch, seed: int) -> dict:
    """(a): Simple in both modes, f32, the same seeded weights and inputs on
    the card and on the CPU; eval logits and argmax, then the running
    statistics after one train=True forward."""
    from video_layout_generation_tpu_torch.val import _synthetic_arrays
    imgs, segs, masks = _synthetic_arrays(
        LEGACY_CARD_CPU_BATCH, LEGACY_CARD_CPU_HW, LEGACY_CLASSES,
        seed=seed + 150)
    out = {"tf32": bool(torch.backends.cudnn.allow_tf32)}
    for name in LEGACY_MODELS:
        state = legacy_model(torch, name, seed + 151).state_dict()
        runs = {}
        for where in (DEVICE, "cpu"):
            model = legacy_model(torch, name, seed + 151)
            model.load_state_dict(state, strict=True)
            model.to(where)
            args = [torch.from_numpy(a).to(where)
                    for a in (masks, segs, imgs)]
            with torch.inference_mode():
                logits = model(*args).float().cpu()
                model(*args, train=True)
            runs[where] = (logits, {k: v.float().cpu() for k, v in
                                    model.named_buffers()})
        (card, card_stats), (cpu, cpu_stats) = runs[DEVICE], runs["cpu"]
        rel = float((card - cpu).abs().max() / cpu.abs().max())
        agree = float((card.argmax(-1) == cpu.argmax(-1)).float().mean())
        stats_err = max((float(((card_stats[k] - v).abs()
                                / v.abs().clamp_min(1.0)).max())
                         for k, v in cpu_stats.items()), default=0.0)
        out[name] = dict(logit_rel=rel, argmax_agreement=agree,
                         stats_err=stats_err, n_stats=len(cpu_stats))
        check(torch.isfinite(card).all() and rel <= LEGACY_LOGIT_RTOL
              and agree >= LEGACY_ARGMAX_AGREEMENT
              and stats_err <= LEGACY_STATS_TOL,
              f"legacy (a) {name}: card vs CPU logits {rel} (limit "
              f"{LEGACY_LOGIT_RTOL}), argmax {agree} equal (limit "
              f"{LEGACY_ARGMAX_AGREEMENT}), statistics {stats_err} (limit "
              f"{LEGACY_STATS_TOL})")
    check(out["u_net"]["n_stats"] == 36,
          f"legacy (a): u_net has {out['u_net']['n_stats']} BatchNorm "
          f"buffers, expected 36")
    print(f"legacy (a): Simple at b{LEGACY_CARD_CPU_BATCH}, "
          f"{LEGACY_CARD_CPU_HW}, f32 card vs CPU with the same weights "
          f"(cuDNN TF32 {'on' if out['tf32'] else 'off'}): "
          + json.dumps(out), flush=True)
    return out


def png_size(path: str) -> tuple:
    """(height, width) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    return (int.from_bytes(head[20:24], "big"),
            int.from_bytes(head[16:20], "big"))


def conv_flops(torch, model, args) -> int:
    """Multiply-adds x 2 of every conv of one forward of ``model``."""
    from video_layout_generation_tpu_torch.models.layers import Conv
    total = []

    def hook(mod, _inp, y):
        k, _, cin, cout = mod.kernel.shape
        total.append(2 * y.numel() // cout * k * k * cin * cout)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, Conv)]
    try:
        with torch.inference_mode():
            model(*args)
    finally:
        for h in hooks:
            h.remove()
    return sum(total)


def in_memory_ids(torch, ckpt: str, name: str, seed: int) -> dict:
    """The ids the CLI should give: the checkpoint's weights on the card
    over the CLI's synthetic arrays, batch by batch, hashed as the CLI
    hashes them; and the conv FLOPs of one image."""
    import hashlib
    from video_layout_generation_tpu_torch.val import (
        _synthetic_arrays, load_completion_weights)
    imgs, segs, masks = _synthetic_arrays(LEGACY_SAMPLES, LEGACY_HW,
                                          LEGACY_CLASSES)
    model = legacy_model(torch, name, seed + 999)
    load_completion_weights(model, ckpt)
    model.to(DEVICE).eval()
    ids = hashlib.sha256()
    for i in range(0, LEGACY_SAMPLES, LEGACY_BATCH):
        args = [torch.from_numpy(a[i:i + LEGACY_BATCH]).to(DEVICE)
                for a in (masks, segs, imgs)]
        with torch.inference_mode():
            pred = model(*args).argmax(-1).to(torch.int32)
        ids.update(pred.cpu().numpy().tobytes())
    flops = conv_flops(torch, model, [a[:1] for a in args])
    return dict(ids_sha256=ids.hexdigest(), flops_per_image=flops)


def run_legacy_cli(torch, seed: int, root: str) -> dict:
    """(b) and (c): the val CLI at 1024x2048 for both models from a
    checkpoint this phase writes, in the CLI's precision."""
    from video_layout_generation_tpu_torch import val
    from video_layout_generation_tpu_torch.io.checkpoint import (
        CheckpointManager)
    out = {"tf32": bool(torch.backends.cudnn.allow_tf32)}
    for name in LEGACY_MODELS:
        model = legacy_model(torch, name, seed + 152)
        ckpt = CheckpointManager(os.path.join(root, name)).save(
            0, model.state_dict(), {}, 0, f"simple29_{name}")
        del model
        ref = in_memory_ids(torch, ckpt, name, seed)
        save_dir = os.path.join(root, "results")
        argv = ["--model", name, "--size", str(LEGACY_HW[0]),
                str(LEGACY_HW[1]), "--bs", str(LEGACY_BATCH), "--n_samples",
                str(LEGACY_SAMPLES), "--ckpt", ckpt, "--save_dir", save_dir,
                "--nw", str(LEGACY_PNG_THREADS), "--device", DEVICE]
        first = val.main(argv)                       # meets cuDNN's shapes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        timed = val.main(argv)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_call(f"val {name} {LEGACY_HW} b{LEGACY_BATCH}",
                            lambda: val.main(argv))
        folder = os.path.join(save_dir, f"{name}_eval_{LEGACY_HW[0]}x"
                                        f"{LEGACY_HW[1]}")
        pngs = sorted(os.listdir(folder))
        check(len(pngs) == LEGACY_SAMPLES
              and all(png_size(os.path.join(folder, p)) == LEGACY_HW
                      for p in pngs),
              f"legacy (b) {name}: PNGs {pngs} in {folder}")
        check(first["ids_sha256"] == ref["ids_sha256"],
              f"legacy (b) {name}: the CLI's ids differ from the in-memory "
              f"run of the same weights")
        check(timed["ids_sha256"] == first["ids_sha256"],
              f"legacy (b) {name}: a second run gave other ids")
        check(np.isfinite(first["miou"]) and 0.0 <= first["miou"] <= 1.0,
              f"legacy (b) {name}: mIoU {first['miou']}")
        dp = val.main(argv + ["--data_parallel"])
        check(dp["ids_sha256"] == first["ids_sha256"]
              and dp["miou"] == first["miou"]
              and dp["pixel_acc"] == first["pixel_acc"],
              f"legacy (c) {name}: --data_parallel differs from the run "
              f"without it")
        loop_s = sum(timed["eval_s"]) + sum(timed["draw_s"]) + sum(
            timed["save_s"])
        steps = LEGACY_SAMPLES // LEGACY_BATCH
        eval_ms = 1e3 * float(np.mean(timed["eval_s"]))
        out[name] = dict(
            miou=first["miou"], pixel_acc=first["pixel_acc"],
            eval_ms=eval_ms,
            draw_ms=1e3 * float(np.mean(timed["draw_s"])),
            save_ms=1e3 * float(np.mean(timed["save_s"])),
            images_per_s=LEGACY_SAMPLES / loop_s, main_wall_s=wall,
            busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
            idle=prof["idle"], peak_gib=peak,
            tflop_per_image=ref["flops_per_image"] / 1e12,
            eval_tflop_per_s=(ref["flops_per_image"] * LEGACY_BATCH
                              / (eval_ms / 1e3) / 1e12),
            groups=prof["groups"])
        print(f"legacy (b): val --model {name} at {LEGACY_HW} "
              f"b{LEGACY_BATCH}, {LEGACY_SAMPLES} samples: {len(pngs)} PNGs"
              f" of {LEGACY_HW}, ids equal to the in-memory run and on a "
              f"second run; (c) --data_parallel on the one-card mesh equal; "
              + json.dumps({k: v for k, v in out[name].items()
                            if k != "groups"}), flush=True)
    return out


def run_legacy_ops(torch, seed: int) -> dict:
    """(d): mask2box and resize_nearest on the card equal the CPU's."""
    from video_layout_generation_tpu_torch.ops import (mask2box,
                                                       resize_nearest)
    from video_layout_generation_tpu_torch.val import _synthetic_arrays
    imgs, segs, masks = _synthetic_arrays(LEGACY_BATCH, LEGACY_HW,
                                          LEGACY_CLASSES, seed=seed + 153)
    # outer region 1; one mask with no inner region (the empty box)
    outer = np.concatenate([1.0 - masks, np.ones_like(masks[:1])])
    cases = {"mask2box": (mask2box, (torch.from_numpy(outer),)),
             "resize_nearest ids down": (resize_nearest, (
                 torch.from_numpy(segs[..., None]), (LEGACY_HW[0] // 4,
                                                     LEGACY_HW[1] // 4))),
             "resize_nearest ids up": (resize_nearest, (
                 torch.from_numpy(segs[:1, ..., None]), (
                     LEGACY_HW[0] * 2 - 1, LEGACY_HW[1] + 3))),
             "resize_nearest rgb": (resize_nearest, (
                 torch.from_numpy(imgs), (300, 700)))}
    out = {}
    for label, (fn, (x, *rest)) in cases.items():
        card = fn(x.to(DEVICE), *rest).cpu()
        cpu = fn(x, *rest)
        check(card.dtype == cpu.dtype and torch.equal(card, cpu),
              f"legacy (d) {label}: the card's result differs from the CPU's")
        out[label] = list(card.shape)
    boxes = mask2box(torch.from_numpy(outer).to(DEVICE)).cpu()
    check(boxes[-1].tolist() == [LEGACY_HW[0], LEGACY_HW[1], -1, -1],
          f"legacy (d): empty box {boxes[-1].tolist()}")
    print(f"legacy (d): on the card equal to the CPU bit for bit: "
          + json.dumps(out), flush=True)
    return out


def run_legacy_trace(torch, seed: int, root: str) -> dict:
    """(e): utils.profiling.trace around an annotated forward on the card
    writes a trace holding a CUDA kernel record and the annotation."""
    import glob
    from video_layout_generation_tpu_torch.utils import annotate, trace
    model = legacy_model(torch, "encoder_decoder", seed + 154).to(
        DEVICE).eval()
    mask = torch.zeros(1, 64, 128, device=DEVICE)
    seg = torch.zeros(1, 64, 128, dtype=torch.int32, device=DEVICE)
    for attempt in range(TRACE_TRIES):
        retry_pause(attempt)
        logdir = os.path.join(root, f"trace_{attempt}")
        with trace(logdir):
            with annotate(LEGACY_ANNOTATION), torch.inference_mode():
                model(mask, seg)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        check(len(files) == 1, f"legacy (e): trace files {files}")
        events = json.load(open(files[0])).get("traceEvents", [])
        kernels = sum(ev.get("cat") == "kernel" for ev in events)
        named = sum(ev.get("name") == LEGACY_ANNOTATION for ev in events)
        if kernels and named:
            break
        print(f"legacy (e): trace with {kernels} kernel records and "
              f"{named} annotations, taking it again", flush=True)
    else:
        raise SmokeFailure(f"legacy (e): no trace with a kernel record and "
                           f"the annotation in {TRACE_TRIES} tries")
    out = dict(kernel_records=kernels, annotations=named,
               bytes=os.path.getsize(files[0]))
    print(f"legacy (e): trace() on the card wrote {os.path.basename(files[0])}"
          f": " + json.dumps(out), flush=True)
    return out


def run_legacy_completion(torch, kern, seed: int):
    """Phase 15, parts (a) to (e); returns its launches (none) and its
    numbers."""
    import shutil
    import tempfile
    kern.reset_launch_counts()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    stats = {"card_cpu": run_legacy_card_cpu(torch, seed)}
    root = tempfile.mkdtemp(prefix="vlg_legacy_")
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        # the CLI leaves cuDNN's TF32 at PyTorch's default, which this
        # script turns off at its start
        torch.backends.cudnn.allow_tf32 = True
        stats["cli"] = run_legacy_cli(torch, seed, root)
        torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.empty_cache()
        stats["ops"] = run_legacy_ops(torch, seed)
        stats["trace"] = run_legacy_trace(torch, seed, root)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        shutil.rmtree(root, ignore_errors=True)
    launches = legacy_check_no_launches(kern, "completion")
    torch.cuda.empty_cache()
    stats["phase_s"] = time.perf_counter() - t_phase
    cli = stats["cli"]
    print(f"legacy timing, card {card_line()}: val at {LEGACY_HW} "
          f"b{LEGACY_BATCH} (cuDNN TF32 on) "
          + "; ".join(
              f"{name}: eval {cli[name]['eval_ms']:.1f} ms, draw "
              f"{cli[name]['draw_ms']:.2f} ms, save {cli[name]['save_ms']:.1f}"
              f" ms a batch, {cli[name]['images_per_s']:.2f} images/s, "
              f"device busy {cli[name]['busy_ms']:.1f} ms of "
              f"{cli[name]['wall_ms']:.1f} (idle share "
              f"{cli[name]['idle']:.3f}), peak {cli[name]['peak_gib']:.2f} "
              f"GiB, {cli[name]['tflop_per_image']:.3f} TFLOP an image, "
              f"eval {cli[name]['eval_tflop_per_s']:.1f} TFLOP/s"
              for name in LEGACY_MODELS)
          + f"; phase 15 took {stats['phase_s']:.1f} s", flush=True)
    return launches, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from video_layout_generation_tpu_torch.ops import kernels as kern
        from video_layout_generation_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    check_no_spills(logs)
    count_tensor_core_instructions(_build)

    def tag_timing(run):
        """Run one case; tag its records with how their times were taken."""
        mark = len(EVENT_TIMED)
        recs = run()
        for rec in recs if isinstance(recs, list) else [recs]:
            rec["timed_by"] = timing_method(len(EVENT_TIMED) - mark)
        return recs

    cases = [tag_timing(lambda: run_kernel_case(torch, F, kern, c,
                                                args.seed + i))
             for i, c in enumerate(kernel_cases())]
    cases += [tag_timing(lambda: run_ssim_case(torch, kern, c,
                                               args.seed + 100 + i))
              for i, c in enumerate(ssim_cases())]
    for i, c in enumerate(instance_norm_cases()):
        cases += tag_timing(lambda: run_instance_norm_case(
            torch, F, kern, c, args.seed + 200 + i))
    cases += [tag_timing(lambda: run_dgrad_case(torch, kern, c,
                                                args.seed + 300 + i))
              for i, c in enumerate(kernel_cases()) if c[7]]   # relu_out
    cases += [tag_timing(lambda: run_backward_case(torch, kern, c,
                                                   args.seed + 400 + i))
              for i, c in enumerate(backward_cases())]
    if EVENT_TIMED:
        print(f"timing: {len(EVENT_TIMED)} timings taken with CUDA events "
              f"(incomplete profiler traces)", flush=True)
    # each path: counts set to 0 just before it, read just after it (the
    # rollouts: after their eager request; replays are counted from the
    # trace, in replayed_launches)
    by_path = {}
    by_path["no-edge rollout"], slice_stats = run_slice(torch, kern,
                                                        args.seed)
    weights = edge_mode_weights(args.seed)
    by_path["validation"], val_stats = run_validation(torch, kern, weights,
                                                      args.seed)
    by_path["edge rollout"], edge_stats = run_edge_rollout(
        torch, kern, weights, args.seed)
    weights.update(pix2pix_weights(args.seed))
    by_path["train"], train_stats = run_train(torch, kern, weights, args.seed)
    by_path["GAN train"], gan_stats = run_gan(torch, kern, weights, args.seed)
    by_path["ResnetGenerator validation"], _ = run_resnet_validation(
        torch, kern, weights, args.seed)
    train_flats = gridnet_train_weights(args.seed)
    by_path["GridNet train"], grid_stats = run_gridnet_train(
        torch, kern, weights, train_flats, args.seed)
    by_path["GridNet GAN train"], grid_gan_stats = run_gridnet_gan(
        torch, kern, weights, train_flats, args.seed)
    by_path["train CLI"], cli_stats = run_train_cli(torch, kern, args.seed)
    by_path["rollout-fidelity training"], rollout_stats = \
        run_rollout_training(torch, kern, args.seed)
    by_path["layout families"], layout_stats = run_layout_families(
        torch, kern, args.seed)
    by_path["data parallel"], dp_stats = run_data_parallel(torch, kern,
                                                           args.seed)
    by_path["legacy layout completion"], legacy_stats = \
        run_legacy_completion(torch, kern, args.seed)
    expected = {"no-edge rollout": LAUNCHES_PER_ROLLOUT,
                "validation": LAUNCHES_PER_EVAL_STEP,
                "edge rollout": LAUNCHES_PER_EDGE_ROLLOUT,
                "train": LAUNCHES_PER_TRAIN_STEP,
                "GAN train": LAUNCHES_PER_GAN_STEP,
                "ResnetGenerator validation": LAUNCHES_PER_RESNET_EVAL_STEP,
                "GridNet train": LAUNCHES_PER_GRIDNET_TRAIN_STEP,
                "GridNet GAN train": LAUNCHES_PER_GRIDNET_GAN_STEP,
                "train CLI": LAUNCHES_PER_CLI_RUN,
                "rollout-fidelity training": LAUNCHES_PER_ROLLOUT_STEP,
                "layout families": NO_LAUNCHES,
                "data parallel": LAUNCHES_PER_EVAL_STEP,
                "legacy layout completion": NO_LAUNCHES}
    for path, counts in by_path.items():
        for name, per_call in expected[path].items():
            check(per_call == 0 or counts[name] > 0,
                  f"{name} was not launched on the {path} path")

    by_case = {c["case"]: c for c in cases}
    backward_case = {"prelu_conv3x3": "A bwd prelu+res row0 32->32",
                     "fused_lateral": "B bwd row0 +res"}
    entries = []
    for name, route in ROUTES.items():
        main = by_case[route["main_case"]]
        launches = {path: counts[name] for path, counts in by_path.items()}
        entries.append(dict(
            name=name, route="cuda", source=route["source"],
            replaces=route["replaces"], launches=sum(launches.values()),
            launches_by_path=launches,
            # the constant plane's backward is 316 x dy (rstd = eps^-1/2):
            # its absolute error says nothing beside the others'
            # the backward cases are the library's VJP, not the kernel
            max_abs_err=max(c["max_abs_err"] for c in cases
                            if c["kernel"] == name
                            and c.get("kind") != "constant"
                            and "backward" not in c),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["case"],
            timed_by=main["timed_by"]))
        if name in backward_case:   # the library's VJP, GridNet training
            entries[-1]["backward_library_ms"] = by_case[
                backward_case[name]]["ms"]
    print(f"card: {card}; rollout frames/s at b{BATCH}: "
          f"{slice_stats['fps']:.1f}; b1 latency "
          f"{slice_stats['b1_latency_s'] * 1e3:.1f} ms; validation samples/s "
          f"at b{BATCH}: {val_stats['samples_per_s']:.1f}; edge rollout "
          f"frames/s at b{BATCH}: {edge_stats['fps']:.1f}; edge b1 latency "
          f"{edge_stats['b1_latency_s'] * 1e3:.1f} ms; ResnetGenerator train "
          f"samples/s at b{BATCH}: {train_stats['samples_per_s']:.1f}; GAN "
          f"train samples/s at b{BATCH}: {gan_stats['samples_per_s']:.1f}",
          flush=True)
    resnet = dict(samples_per_s=train_stats["samples_per_s"],
                  wall_ms=train_stats["wall_ms"],
                  busy_ms=train_stats["busy_ms"], idle=train_stats["idle"],
                  peak_gib=train_stats["peak_gib"])
    keep = ("samples_per_s", "wall_ms", "busy_ms", "idle", "peak_gib",
            "b32_samples_per_s", "b32_peak_gib")
    print(f"training at b{BATCH}, card {card}: " + json.dumps(dict(
        ResnetGenerator=resnet,
        **{arch: {k: v for k, v in st.items() if k in keep}
           for arch, st in grid_stats.items()},
        GridNet_GAN={k: v for k, v in grid_gan_stats.items() if k in keep},
        train_CLI={k: v for k, v in cli_stats.items() if k != "warm_start"},
        rollout_training={k: {n: x for n, x in v.items()
                              if n not in ("profile", "groups")}
                          for k, v in rollout_stats.items()},
        device_ms_by_group={arch: st["groups"]
                            for arch, st in grid_stats.items()})),
        flush=True)
    print(f"layout families at b{BATCH}, card {card}: " + json.dumps(
        {k: v for k, v in layout_stats.items() if k != "cvae"}
        | {"cvae_validation": {k: v for k, v in layout_stats["cvae"].items()
                               if k != "rates"},
           "cvae_rollout": {k: v for k, v in layout_stats["cvae"][
               "rates"].items() if k != "groups"}}), flush=True)
    print(f"data parallel at b{BATCH}, card {card}: " + json.dumps(dp_stats),
          flush=True)
    print(f"legacy layout completion at {LEGACY_HW}, card {card}: "
          + json.dumps(legacy_stats), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
