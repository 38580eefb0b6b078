"""Data parallelism of the port on the CPU: two ranks of a Gloo group
(``torch.multiprocessing.spawn``, ``tests/test_torch_dp_worker.py``), each on
its rows of the global batch, against one process on the concatenated
batch, at 16x16 with filters (4, 6, 8) on the plain versions:

- two GridNet train steps with a per-example flip (drawn at the global
  batch's shape, each rank taking its rows);
- one WGAN-GP step (the penalty's mixing weights drawn likewise);
- one K=2 step with feedback noise and layout corruption;
- one VAE step with class weights, free bits and capacity (rank 1's rows
  all background, so a local class-weight sum would differ);
- one CVAE step (its latent noise drawn in the model);
- ``validate`` over two global batches.

All ranks run in one spawn (about 3 s of start-up) while this process
computes the reference, and report their metrics, gradients (as each
update applied them) and parameters.
Tolerances: every loss term and metric within 1e-6 relative; each
update's summed gradients within 1e-6 in L2, as one vector (seen: under
2e-7; a single PReLU slope's gradient, one sum over a whole activation
with much cancellation, differs by up to 4e-5 of itself, so the tensors
are not held one by one); parameters after one SGD update within 1e-6
(both ranks' bit for bit equal); the validation's confusion matrix (its
per-class IoU) exactly equal and its loss within 1e-6 relative. The
differences come only from f32 summation order: a rank sums over half the
batch before the all-reduce adds.
"""

import numpy as np
import pytest
import torch

import test_torch_dp_worker as w

LOSS_RTOL = 1e-6
GRAD_L2_TOL = 1e-6
PARAM_TOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's scenarios, the one-process reference's), the
    reference on one torch thread beside the ranks' one each."""
    with w.torch_threads(1):
        return w.run_ranks(w.all_step_scenarios,
                           tmp_path_factory.mktemp("dp_steps"),
                           meanwhile=lambda: w.all_step_scenarios(w.whole))


def assert_report_close(got: dict, ref: dict):
    for m_got, m_ref in zip(got["metrics"], ref["metrics"], strict=True):
        assert set(m_got) == set(m_ref)
        for k in m_ref:
            np.testing.assert_allclose(m_got[k].numpy(), m_ref[k].numpy(),
                                       rtol=LOSS_RTOL, err_msg=k)
    for g_got, g_ref in zip(got["grads"], ref["grads"], strict=True):
        assert set(g_got) == set(g_ref)
        err = sum(float((g_got[k] - g_ref[k]).pow(2).sum()) for k in g_ref)
        size = sum(float(g_ref[k].pow(2).sum()) for k in g_ref)
        assert err ** 0.5 <= GRAD_L2_TOL * size ** 0.5, (err, size)
    assert set(got["params"]) == set(ref["params"])
    for k in ref["params"]:
        np.testing.assert_allclose(got["params"][k].numpy(),
                                   ref["params"][k].numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("name", [s for s in w.STEP_SCENARIOS
                                  if s != "validation"])
def test_two_ranks_step_equals_one_process_on_the_global_batch(runs, name):
    ranks, ref = runs[0], runs[1][name]
    r0, r1 = ranks[0][name], ranks[1][name]
    for k in r0["params"]:      # the same update on every rank
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    for m0, m1 in zip(r0["metrics"], r1["metrics"]):
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k
    assert_report_close(r0, ref)


def test_two_ranks_validate_equals_one_process(runs):
    ranks, ref = runs[0], runs[1]["validation"]
    for r in ranks:
        got = r["validation"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got["cm_iou"], ref["cm_iou"])
        assert got["miou"] == ref["miou"]


def test_vae_scenario_exercises_every_remedy():
    """The VAE scenario's free-bits floor holds some latent dimensions and
    not others, and the capacity lies between the ranks' own KL, on the
    other side of the global KL than rank 0's: a step that took the mask
    or the sign from its own rows would differ."""
    from video_layout_generation_tpu_torch.losses.vae import _kl_terms
    from video_layout_generation_tpu_torch.models.vae import LayoutVAE
    from video_layout_generation_tpu_torch.ops.one_hot import seg_one_hot
    model = LayoutVAE(w.N_CLASSES, 4, widths=(4, 8, 8),
                      generator=torch.Generator().manual_seed(10))
    ids = w.seg_batch(w.GLOBAL_BATCH, 12)
    ids[w.GLOBAL_BATCH // 2:] = 0
    with torch.no_grad():
        _, mu, logvar = model(seg_one_hot(ids, w.N_CLASSES),
                              generator=torch.Generator().manual_seed(11))
    kl = _kl_terms(mu, logvar).detach()
    floored = kl.mean(0) < w.VAE_FREE_BITS
    assert floored.any() and not floored.all()
    used = [float(part.mean(0).clamp_min(w.VAE_FREE_BITS).sum())
            for part in (kl, kl[:2], kl[2:])]
    assert used[2] < used[0] < w.VAE_CAPACITY < used[1]
