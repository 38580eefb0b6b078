"""PyTorch/CUDA port of video_layout_generation_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
neither JAX nor anything of it. Activations are NHWC at every public
function, as in the JAX package. Every 3x3 conv of GridNet, HNED and VGG19,
the SSIM term of the validation step and every InstanceNorm of the pix2pix
nets run through the hand-written CUDA kernels of ``ops/kernels`` on a CUDA
tensor and through their plain PyTorch versions on a CPU tensor.

Entry points take ``device=`` and default to ``"cuda"``; with no CUDA device
they raise instead of running on the CPU.
"""
