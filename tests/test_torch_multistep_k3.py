"""K=3 training of the port (``train/multistep.py``) without edges on the
CPU in f32 against the JAX package's jitted ``make_multistep_train_step``:
the setting and the tolerances of ``test_torch_multistep.py`` (loss terms
and ``loss_per_step`` within 1e-5 relative, parameters after one Adam step
within 3e-5; measured about 1e-7 and 7e-7), an 8-channel GridNet, a
5-frame window, one key whose coin flips it and one whose coin does not.
"""

import numpy as np
import pytest

from test_torch_gridnet_train import frozen  # noqa: F401  (fixture)
from test_torch_multistep import assert_pair_matches, key_with_coin, \
    run_pairs
from test_torch_multistep import one_torch_thread  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def k3_no_edges(frozen):  # noqa: F811
    return run_pairs(frozen, 3, False, [key_with_coin(False),
                                        key_with_coin(True)], seed=33)


@pytest.mark.parametrize("flipped", [False, True])
def test_k3_without_edges_matches_jax(k3_no_edges, flipped):
    pair = k3_no_edges[int(flipped)]
    assert pair["coin"] == flipped
    assert_pair_matches(pair, 3)


def test_feedback_carries_gradient_into_the_first_layer(k3_no_edges):
    """Steps 2..3 read the model's own frame and layout: three distinct
    per-step losses, and a gradient at the first layer's kernels (the
    data gradient of the fed-back frame reaches them through steps 2..3
    as well as step 1's)."""
    pair = k3_no_edges[0]
    per = pair["tm"]["loss_per_step"].numpy()
    assert np.all(np.isfinite(per)) and len(set(per.tolist())) == 3
    for conv in ("Conv_0", "Conv_2"):
        assert np.abs(pair["tgrads"][f"lateral_in.{conv}.kernel"]).max() > 0
