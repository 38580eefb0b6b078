"""The edge-mode path of the port as a whole, on the CPU in f32 against the
JAX package: the edge-mode validation step, ``validate``'s accumulation,
the edge-mode rollout and ``LayoutPredictor(use_edges=True)``, and the
confusion-matrix helpers.

Both packages run the committed trained snapshots (``flagship_096``, the
10-channel GridNet at full width; ``hned_synth``; ``vgg_synth``) on 32x32
batches made with numpy from a seed. The JAX side runs without ``jit``.
Loss terms are held at rtol 1e-3, layouts must agree on at least 99.9% of
the pixels, frames at atol 1e-3 (the snapshot's activations are large, as
in the GridNet test).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_layout_generation_tpu.evaluation import metrics as jmetrics
from video_layout_generation_tpu.io import weights as jweights
from video_layout_generation_tpu.losses.combined import \
    CombinedLoss as JaxCombinedLoss
from video_layout_generation_tpu.models import gridnet as jgrid
from video_layout_generation_tpu.models import hned as jhned
from video_layout_generation_tpu.serving import \
    LayoutPredictor as JaxPredictor
from video_layout_generation_tpu.train import rollout as jrollout
from video_layout_generation_tpu.train import steps as jsteps
from video_layout_generation_tpu_torch.evaluation import metrics as tmetrics
from video_layout_generation_tpu_torch.io.weights import (load_hned_params,
                                                          params_from_flax)
from video_layout_generation_tpu_torch.losses import CombinedLoss
from video_layout_generation_tpu_torch.models import HNED, GridNet
from video_layout_generation_tpu_torch.ops import kernels
from video_layout_generation_tpu_torch.serving import LayoutPredictor
from video_layout_generation_tpu_torch.train import steps as tsteps
from video_layout_generation_tpu_torch.train.assemble import normalize_image
from video_layout_generation_tpu_torch.train.rollout import make_rollout_fn
from video_layout_generation_tpu_torch.train.trainer import validate

STORE = Path(__file__).resolve().parents[1] / "artifacts_store"
HNED_NPZ = str(STORE / "hned_synth.npz")
VGG_NPZ = str(STORE / "vgg_synth.npz")
HW = (32, 32)
N_CLASSES = 20


def _unflatten(flat):
    tree = {}
    for key in flat.files:
        if key.startswith("__"):
            continue
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(flat[key])
    return tree


@pytest.fixture(scope="module")
def flagship():
    return np.load(STORE / "flagship_096.npz")


@pytest.fixture(scope="module")
def jax_side(flagship):
    model = jgrid.GridNet(n_channels=10)
    hned = jhned.HNED()
    return dict(model=model, params=_unflatten(flagship), hned=hned,
                hned_params=jweights.load_hned_params(HNED_NPZ),
                combined=JaxCombinedLoss.create(VGG_NPZ))


@pytest.fixture(scope="module")
def port_side(flagship):
    model = GridNet(n_channels=10)
    model.load_state_dict(params_from_flax(flagship), strict=True)
    hned = HNED()
    hned.load_state_dict(load_hned_params(HNED_NPZ), strict=True)
    return dict(model=model.eval(), hned=hned.eval(),
                combined=CombinedLoss.create(VGG_NPZ, device="cpu"))


def _packed_batch(n, seed):
    """uint8 (N, H, W, 12): three smooth-ish frames and three layouts."""
    rng = np.random.default_rng(seed)
    cells = (n, HW[0] // 4, HW[1] // 4)

    def up(a):
        return a.repeat(4, axis=1).repeat(4, axis=2)

    f1 = up(rng.random(cells + (3,)))
    frames = [np.clip(f1 + 0.05 * k * up(rng.standard_normal(cells + (3,))),
                      0, 1) for k in range(3)]
    segs = [up(rng.integers(0, N_CLASSES, cells))[..., None]
            for _ in range(3)]
    return np.concatenate([(f * 255 + 0.5).astype(np.uint8) for f in frames]
                          + [s.astype(np.uint8) for s in segs], axis=-1)


def _float_batch(packed):
    p = packed
    return {"img1": (p[..., 0:3] / 255.0).astype(np.float32),
            "img2": (p[..., 3:6] / 255.0).astype(np.float32),
            "img3": (p[..., 6:9] / 255.0).astype(np.float32),
            "seg1": p[..., 9:10].astype(np.float32),
            "seg2": p[..., 10:11].astype(np.float32),
            "seg3": p[..., 11].astype(np.int32)}


def test_decode_batch_matches_jax_for_packed_and_dict_forms():
    packed = _packed_batch(2, seed=1)
    ref = jsteps.decode_batch({"packed6": jnp.asarray(packed)})
    got = tsteps.decode_batch({"packed6": torch.from_numpy(packed)})
    assert set(got) == set(ref) == {"img1", "img2", "img3", "seg1", "seg2",
                                    "seg3"}
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-7)
    assert got["img1"].dtype == torch.float32
    assert got["seg1"].dtype == torch.float32 and got["seg1"].shape[-1] == 1
    assert got["seg3"].dtype == torch.int64 and got["seg3"].ndim == 3
    # uint8 dict form decodes like packed6; f32 passes through untouched
    u8 = {"img1": torch.from_numpy(packed[..., 0:3]),
          "seg1": torch.from_numpy(packed[..., 9:10]),
          "seg3": torch.from_numpy(packed[..., 11])}
    dec = tsteps.decode_batch(u8)
    assert torch.equal(dec["img1"], got["img1"])
    assert torch.equal(dec["seg1"], got["seg1"])
    assert torch.equal(dec["seg3"], got["seg3"])
    f32 = {k: torch.from_numpy(v)
           for k, v in _float_batch(packed).items() if k != "seg3"}
    for k, v in tsteps.decode_batch(f32).items():
        assert v is f32[k]


@pytest.mark.parametrize("with_edges", [True, False])
def test_prepare_inputs_matches_jax(jax_side, port_side, with_edges):
    batch = _float_batch(_packed_batch(2, seed=2))
    jh = jax_side["hned"].apply if with_edges else None
    x_ref, f3_ref = jsteps.prepare_inputs(
        jh, jax_side["hned_params"], {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    x, f3 = tsteps.prepare_inputs(
        port_side["hned"] if with_edges else None,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert x.shape == (2,) + HW + (10 if with_edges else 8,)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4)
    np.testing.assert_allclose(f3.numpy(), np.asarray(f3_ref), atol=1e-6)
    assert not x.requires_grad


@pytest.fixture(scope="module")
def eval_pair(jax_side, port_side):
    """Both packages' eval step on the same two packed batches."""
    j = jax_side
    jstep = jsteps.make_eval_step(j["model"].apply, j["hned"].apply,
                                  j["combined"].eval_variant(),
                                  n_classes=N_CLASSES)
    p = port_side
    tstep = tsteps.make_eval_step(p["model"], p["hned"], p["combined"],
                                  n_classes=N_CLASSES, device="cpu")
    batches = [{"packed6": _packed_batch(2, seed=3)},
               {"packed6": _packed_batch(1, seed=4)}]
    with jax.disable_jit():
        ref = [jstep(j["params"], j["hned_params"],
                     {"packed6": jnp.asarray(b["packed6"])})
               for b in batches]
    got = [tstep(b) for b in batches]
    return batches, ref, got, tstep


def test_eval_step_loss_terms_match_jax(eval_pair):
    _, ref, got, _ = eval_pair
    for (mr, _, _), (mg, _, _) in zip(ref, got):
        for k in ("loss", "loss_l1", "loss_style", "loss_seg"):
            np.testing.assert_allclose(float(mg[k]), float(mr[k]), rtol=1e-3)
        assert float(mg["loss"]) == pytest.approx(
            float(mg["loss_l1"] + mg["loss_style"] + mg["loss_seg"]),
            rel=1e-6)


def test_eval_step_layouts_frames_and_confusion_match_jax(eval_pair):
    batches, ref, got, _ = eval_pair
    for b, (mr, seg_r, img_r), (mg, seg_g, img_g) in zip(batches, ref, got):
        n = b["packed6"].shape[0]
        assert seg_g.shape == (n,) + HW and img_g.shape == (n,) + HW + (3,)
        agree = float((seg_g.numpy() == np.asarray(seg_r)).mean())
        assert agree >= 0.999
        np.testing.assert_allclose(img_g.numpy(), np.asarray(img_r),
                                   atol=1e-3)
        cm = mg["cm"].numpy()
        assert cm.shape == (N_CLASSES, N_CLASSES) and cm.dtype == np.float32
        assert cm.sum() == n * HW[0] * HW[1]
        assert np.abs(cm - np.asarray(mr["cm"])).sum() <= \
            2 * (1 - agree) * cm.sum() + 1e-6


def test_eval_step_plain_flag_and_weights(port_side, eval_pair):
    batches, _, got, _ = eval_pair
    p = port_side
    with kernels.plain():
        plain = tsteps.make_eval_step(p["model"], p["hned"], p["combined"],
                                      n_classes=None, device="cpu")(batches[0])
    assert "cm" not in plain[0]
    for k in ("loss", "loss_l1", "loss_style", "loss_seg"):
        np.testing.assert_allclose(float(plain[0][k]), float(got[0][0][k]),
                                   rtol=1e-6)
    scaled = tsteps.make_eval_step(p["model"], p["hned"], p["combined"],
                                   w_l1=4.0, w_style=2.0, w_seg=1.0,
                                   device="cpu")(batches[0])[0]
    np.testing.assert_allclose(float(scaled["loss"]) * 10.0,
                               float(got[0][0]["loss"]), rtol=1e-5)
    # the train step takes the same GridNet
    assert callable(tsteps.make_train_step(p["model"], p["hned"],
                                           p["combined"], device="cpu"))


def test_eval_entry_points_default_to_the_card_and_raise_without_one(
        port_side, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = port_side
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.make_eval_step(p["model"], p["hned"], p["combined"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CombinedLoss.create(VGG_NPZ)
    # nothing was moved or changed by the refused calls
    assert next(p["model"].parameters()).device.type == "cpu"


def test_a_net_not_built_for_bf16_is_refused_by_name_for_the_card():
    from video_layout_generation_tpu_torch.device import require_bf16
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    nets = {"GridNet": GridNet(n_channels=10, dtype=torch.bfloat16),
            "HNED": HNED(), "none": None}
    with pytest.raises(ValueError, match="HNED was built with dtype=None"):
        require_bf16(cuda, nets)
    require_bf16(cpu, nets)
    require_bf16(cuda, dict(nets, HNED=HNED(dtype=torch.bfloat16)))


def test_validate_accumulates_like_the_jax_trainer(eval_pair):
    batches, ref, got, tstep = eval_pair
    out = validate(tstep, batches, N_CLASSES)
    # the accumulation of Trainer.validate, by hand, on the JAX results
    sizes = [b["packed6"].shape[0] for b in batches]
    loss = sum(float(m["loss"]) * n for (m, _, _), n in zip(ref, sizes)) \
        / sum(sizes)
    cm = sum(np.asarray(m["cm"]) for m, _, _ in ref)
    iou, miou, acc = jmetrics.summarize_confusion(cm, N_CLASSES)
    assert set(out) == {"loss", "miou", "pixel_acc", "per_class_iou"}
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-3)
    np.testing.assert_allclose(out["miou"], miou, atol=2e-3)
    np.testing.assert_allclose(out["pixel_acc"], acc, atol=1e-3)
    assert out["per_class_iou"].shape == (N_CLASSES,)
    # and exactly the port's own per-batch results, size-weighted
    own = sum(float(m["loss"]) * n for (m, _, _), n in zip(got, sizes)) \
        / sum(sizes)
    assert out["loss"] == pytest.approx(own, rel=1e-6)


def test_validate_with_no_batches():
    out = validate(lambda b: pytest.fail("no batch to step on"), [],
                   N_CLASSES)
    assert np.isnan(out["loss"])
    assert out["miou"] == 0.0 and out["pixel_acc"] == 0.0
    assert out["per_class_iou"].shape == (N_CLASSES,)
    assert np.isnan(out["per_class_iou"]).all()


def _seeds(n, seed):
    b = _float_batch(_packed_batch(n, seed))
    return b["img1"], b["img2"], b["seg1"], b["seg2"]


@pytest.mark.parametrize("edge_scale,n_frames", [(1, 3), (2, 2)])
def test_edge_rollout_matches_jax_rollout(jax_side, port_side, edge_scale,
                                          n_frames):
    j, p = jax_side, port_side
    img1, img2, seg1, seg2 = _seeds(2, seed=5)
    n1 = normalize_image(torch.from_numpy(img1))
    n2 = normalize_image(torch.from_numpy(img2))
    ro = jrollout.make_rollout_fn(j["model"].apply, j["hned"].apply,
                                  n_frames=n_frames, use_edges=True,
                                  jit=False, edge_scale=edge_scale)
    with jax.disable_jit():
        imgs_r, segs_r = ro(j["params"], j["hned_params"],
                            jnp.asarray(n1.numpy()), jnp.asarray(n2.numpy()),
                            jnp.asarray(seg1), jnp.asarray(seg2))
    with torch.no_grad():
        imgs, segs = make_rollout_fn(
            p["model"], p["hned"], n_frames=n_frames, use_edges=True,
            edge_scale=edge_scale)(n1, n2, torch.from_numpy(seg1),
                                   torch.from_numpy(seg2))
    assert imgs.shape == (2, n_frames) + HW + (3,)
    assert segs.shape == (2, n_frames) + HW + (1,)
    assert imgs.dtype == segs.dtype == torch.float32
    # step 1 sees identical inputs; later steps carry argmax flips forward
    assert float((segs[:, 0].numpy() == np.asarray(segs_r)[:, 0]).mean()) \
        >= 0.999
    np.testing.assert_allclose(imgs[:, 0].numpy(), np.asarray(imgs_r)[:, 0],
                               atol=1e-3)
    assert float((segs.numpy() == np.asarray(segs_r)).mean()) >= 0.99


def test_rollout_option_checks(port_side):
    p = port_side
    with pytest.raises(ValueError, match="requires an HNED"):
        make_rollout_fn(p["model"], use_edges=True)
    with pytest.raises(ValueError, match="edge_scale"):
        make_rollout_fn(p["model"], p["hned"], use_edges=True, edge_scale=0)
    ro = make_rollout_fn(p["model"], p["hned"], n_frames=1, use_edges=True,
                         edge_scale=4)
    z = torch.zeros((1,) + HW + (3,))
    s = torch.zeros((1,) + HW + (1,))
    with pytest.raises(ValueError, match="at least 16x16"):
        ro(z, z, s, s)


def test_edge_mode_predictor_matches_jax_predictor(flagship, jax_side,
                                                   port_side):
    j = jax_side
    kw = dict(n_frames=2, batch=2, image_hw=HW, use_bf16=False,
              use_edges=True)
    img1, img2, seg1, seg2 = _seeds(2, seed=6)
    req = (img1, img2, seg1[..., 0].astype(np.int64),
           seg2[..., 0].astype(np.int64))
    with jax.disable_jit():
        fj, lj = JaxPredictor("GridNet", j["params"], hned=j["hned"],
                              hned_params=j["hned_params"],
                              **kw).predict(*req)
    pred = LayoutPredictor("GridNet", flagship, hned=HNED(),
                           hned_params=load_hned_params(HNED_NPZ),
                           device="cpu", **kw)
    ft, lt = pred.predict(*req)
    assert ft.shape == (2, 2) + HW + (3,) and lt.shape == (2, 2) + HW
    np.testing.assert_allclose(ft[:, 0], np.asarray(fj)[:, 0], atol=1e-3)
    assert float((lt == np.asarray(lj)).mean()) >= 0.99
    assert float((lt[:, 0] == np.asarray(lj)[:, 0]).mean()) >= 0.999
    # a padded request equals the head of the full one
    f1, l1 = pred.predict(*(a[:1] for a in req))
    np.testing.assert_allclose(f1, ft[:1], atol=1e-5)
    np.testing.assert_array_equal(l1, lt[:1])


def test_edge_mode_predictor_argument_checks(flagship, port_side):
    kw = dict(n_frames=1, batch=1, image_hw=HW, use_bf16=False,
              device="cpu")
    with pytest.raises(ValueError, match="requires an HNED"):
        LayoutPredictor("GridNet", flagship, use_edges=True, **kw)
    # the 10-channel snapshot does not fit the 8-channel no-edge contract
    with pytest.raises(RuntimeError, match="size mismatch"):
        LayoutPredictor("GridNet", flagship, **kw)
    # an HNED already holding its weights needs no hned_params
    pred = LayoutPredictor("GridNet", flagship, hned=port_side["hned"],
                           use_edges=True, edge_scale=2, **kw)
    img1, img2, seg1, seg2 = _seeds(1, seed=7)
    f, l = pred.predict(img1, img2, seg1[..., 0], seg2[..., 0])
    assert f.shape == (1, 1) + HW + (3,) and np.isfinite(f).all()
    assert l.min() >= 0 and l.max() < N_CLASSES


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_matrix_and_scores_match_jax(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 7, (2, 6, 5))
    target = rng.integers(0, 5, (2, 6, 5))   # classes 5, 6 never targets
    ref = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred),
                                               jnp.asarray(target), 8))
    got = tmetrics.confusion_matrix(torch.from_numpy(pred),
                                    torch.from_numpy(target), 8)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[3, 2] == ((target == 3) & (pred == 2)).sum()
    iou_r, miou_r = jmetrics.iou_from_confusion(ref)
    iou_g, miou_g = tmetrics.iou_from_confusion(got)
    np.testing.assert_allclose(iou_g, iou_r, equal_nan=True)
    assert np.isnan(iou_g[7]) and miou_g == pytest.approx(miou_r)
    assert tmetrics.pixel_accuracy(got) == pytest.approx(
        jmetrics.pixel_accuracy(ref))
    assert tmetrics.pixel_accuracy(np.zeros((3, 3))) == 0.0
    s_g = tmetrics.summarize_confusion(got, 8)
    s_r = jmetrics.summarize_confusion(ref, 8)
    np.testing.assert_allclose(s_g[0], s_r[0], equal_nan=True)
    assert s_g[1:] == pytest.approx(s_r[1:])
