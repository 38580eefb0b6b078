"""The port's train step (``train/steps.py``) on a CoordGridNet, on the CPU
in f32 against the JAX package's train step.

A CoordGridNet at filters (4, 6, 8) with weights made with numpy from a
seed, the committed ``hned_synth`` and ``vgg_synth`` snapshots, one numpy
batch of 2 at 32x32 and ``flip_mode="none"`` on both sides. The JAX step
is jitted and runs in float64: a PReLU slope's gradient is a sum over the
whole activation with much cancellation, and on such a random narrow net
the JAX package's own f32 step is up to 1e-2 off its float64 step there,
where the port's f32 step stays within 2e-3. Tolerances as in
``test_torch_gridnet_train.py``.
"""

import numpy as np
import pytest

from test_torch_gridnet_train import (NARROW, assert_step_matches,
                                      numpy_flax_params, run_train_pair)
from test_torch_gridnet_train import frozen  # noqa: F401  (fixture)
from video_layout_generation_tpu_torch.models import get_model_cls

COORD_CONVS = ("CoordConv_0", "CoordConv_1", "CoordConv_2")


@pytest.fixture(scope="module")
def coord_pair(frozen):  # noqa: F811
    variables = numpy_flax_params(get_model_cls("CoordGridNet")(
        n_channels=10, filters_level=NARROW), seed=22)
    return run_train_pair(frozen, "CoordGridNet", variables, NARROW, seed=23,
                          f64=True)


def test_coord_gridnet_train_step_matches_jax(coord_pair):
    assert_step_matches(coord_pair)
    # the coordinate stem carries gradients: its three convs see the two
    # coordinate channels appended to their input, and its stand-alone
    # PReLU sits between two of them
    g = coord_pair["tgrads"]
    assert abs(float(g["lateral_in.PReLU_0.alpha"])) > 0
    for conv in COORD_CONVS:
        kernel = g[f"lateral_in.{conv}.Conv_0.kernel"]
        bias = g[f"lateral_in.{conv}.Conv_0.bias"]
        assert np.abs(bias).max() > 0, conv
        # every input row, the two coordinate rows (the last two) included
        assert (np.abs(kernel).max(axis=(0, 1, 3)) > 0).all(), conv

