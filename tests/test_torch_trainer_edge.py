"""One epoch of the port's ``Trainer.fit`` in edge mode (HNED edge channels,
10-channel CoordGridNet) against the JAX package's ``Trainer``, on the CPU.
Configuration, flip rule and tolerances as in ``test_torch_trainer.py``
(measured with edges: every parameter within 6.9e-7 after the epoch, the
validation loss, mIoU and pixel accuracy equal).
"""

import pytest

from test_torch_trainer import assert_fit_matches, fit_pair


@pytest.fixture(scope="module")
def edge_pair(tmp_path_factory):
    return fit_pair(tmp_path_factory.mktemp("fit_edge"), edge=True)


def test_fit_one_epoch_with_edges_matches_jax(edge_pair):
    assert_fit_matches(edge_pair)
    assert edge_pair["tt"].hned is not None
    assert edge_pair["tt"].model.lateral_in.CoordConv_0.Conv_0.kernel.shape[2] \
        == 12   # 10 channels and the two coordinate channels
