"""The K-step loss's levers in the port, on the CPU in f32 against the JAX
package: K=3 with edges and every lever away from its default
(``discount`` 0.5, ``feedback_noise`` 0.1, ``layout_noise`` 0.2,
``image_weight`` 2.0, ``image_discount`` 0.7), the port's step handed the
JAX step's coin (one that flips the window) and its noise and layout draws
(``jax_draws``); the tolerances of ``test_torch_multistep.py`` but one. The JAX step runs in float64 here:
with edges at K=3 on this net the gradients of f32 steps are ill
conditioned (conv biases, sums with much cancellation): without levers
the JAX package's own f32 step is 2.4e-3 of a tensor's largest off its
float64 step (the port's 6.7e-3; global L2 5.4e-6 and 1.7e-5), and a
first Adam step, which moves an element by about lr whatever its
gradient's size, turns 3 elements of the JAX f32 step the other way, whose
gradients are 3.4e-4 to 8.6e-4 of their tensor's largest (the port's: 3
elements, 1.9e-4 to 3.4e-4). So the parameters are held within 3e-5 where
the gradient is at least 1e-3 of its tensor's largest (the rest within 2
lr + 3e-5), and the gradients within 1e-4 in L2 over all tensors.
"""

import numpy as np
import pytest

from test_torch_gridnet_train import frozen  # noqa: F401  (fixture)
from test_torch_multistep import (assert_pair_matches, key_with_coin,
                                  run_pairs)
from test_torch_multistep import one_torch_thread  # noqa: F401  (fixture)

LEVERS = dict(discount=0.5, feedback_noise=0.1, layout_noise=0.2,
              image_weight=2.0, image_discount=0.7)


@pytest.fixture(scope="module")
def lever_pairs(frozen):  # noqa: F811
    return run_pairs(frozen, 3, True, [key_with_coin(True, f64=True)],
                     seed=41, f64=True, **LEVERS)


def test_every_lever_matches_jax(lever_pairs):
    pair = lever_pairs[0]
    assert pair["coin"]
    assert_pair_matches(pair, 3, sure_at=1e-3)
    got, want = pair["tgrads"], pair["jgrads"]
    l2 = np.sqrt(sum(((got[n] - w) ** 2).sum() for n, w in want.items())
                 / sum((w ** 2).sum() for w in want.values()))
    assert l2 <= 1e-4, l2
    # the levers reweigh the terms: the total is not the plain mean
    per = pair["tm"]["loss_per_step"].numpy()
    assert abs(float(pair["tm"]["loss"]) - per.mean()) > 1e-2 * per.mean()
