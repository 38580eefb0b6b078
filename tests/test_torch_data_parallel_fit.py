"""The trainers over two ranks of a Gloo group on the CPU
(``tests/test_torch_dp_worker.py``) against one process fed the concatenated
rank batches (``ConcatRanks``: global batch i is rank 0's batch i
followed by rank 1's), one epoch each at 16x16 on the plain versions,
one global batch of 4 to train on and one to validate:

- ``Trainer.fit`` with ``--put_thread`` (CoordGridNet, filters (4, 6, 8),
  no edges, f32, SGD), both ranks in one experiment directory: rank 0
  alone writes the checkpoints and the ``predict/`` dump, which holds both
  ranks' rows of the validation batch in order (the one-process run's
  dump, inputs bit for bit, predictions within 1e-5);
- ``LayoutTrainer.fit`` of the VAE with its collapse remedies (class
  weight 0.25 on background, free bits, a capacity ramp), its latent noise
  drawn at the global batch's shape in training and validation.

Tolerances: parameters after the epoch's one update within 1e-6 (both
ranks' bit for bit equal), the validation loss within 1e-6 relative, the
confusion matrices (per-class IoU, mIoU, pixel accuracy) exactly equal.
(A second update starts from parameters that differ in their last bits,
and moves a few of them by up to 1.4e-6 on this net.)
"""

import numpy as np
import pytest
import torch

import test_torch_dp_worker as w

PARAM_TOL = 1e-6
LOSS_RTOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_fit")
    with w.torch_threads(1):
        return w.run_ranks(w.both_fits, root, args=(str(root / "ranks"),),
                           meanwhile=lambda: w.both_fits(str(root / "one"),
                                                         concat=True))


@pytest.mark.parametrize("name", ["trainer", "layout_trainer"])
def test_two_ranks_fit_epoch_equals_one_process(runs, name):
    (r0, r1), ref = [r[name] for r in runs[0]], runs[1][name]
    assert r0["step"] == r1["step"] == ref["step"] == 1
    for k, v in ref["params"].items():
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        np.testing.assert_allclose(r0["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=PARAM_TOL, err_msg=k)
    for r in (r0, r1):
        np.testing.assert_array_equal(r["cm_iou"], ref["cm_iou"])
        for k, v in ref["val"].items():
            if k == "loss":
                np.testing.assert_allclose(r["val"][k], v, rtol=LOSS_RTOL)
            else:
                assert r["val"][k] == v, k


def test_rank_zero_writes_the_checkpoint_and_the_gathered_dump(runs):
    (r0, r1), ref = [r["trainer"] for r in runs[0]], runs[1]["trainer"]
    assert "tags" not in r1 and r0["tags"] == ref["tags"] == ["001",
                                                              "latest"]
    assert len(r0["dumps"]) == len(ref["dumps"]) == 1
    got, want = r0["dumps"][0], ref["dumps"][0]
    assert got.shape == want.shape == (w.GLOBAL_BATCH,) + w.HW + (16,)
    # inputs (frames 1-3, seg1-3) bit for bit, the prediction within 1e-5
    inputs = list(range(9)) + [12, 13, 14]
    assert got[..., inputs].tobytes() == want[..., inputs].tobytes()
    np.testing.assert_allclose(got[..., 9:12], want[..., 9:12], atol=1e-5)
    np.testing.assert_array_equal(got[..., 15], want[..., 15])
