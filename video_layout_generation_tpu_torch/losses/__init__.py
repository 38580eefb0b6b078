"""Loss stack of the port: pixel, SSIM, VGG19 perceptual, combined and
cross-entropy losses and the GAN objectives (the JAX package's ``losses``)."""

from .ce import class_weighted_ce, cross_entropy_loss, weighted_masked_ce
from .combined import CombinedLoss
from .gan import gan_loss, gradient_penalty
from .pixel import gradient_loss, l1_loss
from .ssim import ssim_loss
from .vae import (cvae_loss, kl_gaussians, kl_standard_normal,
                  kl_standard_normal_free_bits, vae_loss)
from .vgg import (VGG19Features, load_vgg_params, make_vgg_loss,
                  vgg_feature_loss)

__all__ = ["CombinedLoss", "VGG19Features", "class_weighted_ce",
           "cross_entropy_loss", "cvae_loss", "gan_loss", "gradient_loss",
           "gradient_penalty", "kl_gaussians", "kl_standard_normal",
           "kl_standard_normal_free_bits", "l1_loss",
           "load_vgg_params", "make_vgg_loss", "ssim_loss",
           "vae_loss", "vgg_feature_loss", "weighted_masked_ce"]
