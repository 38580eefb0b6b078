"""The layout families' nets of the port (``models/vae.py``,
``models/convlstm.py``, the SAME transposed conv of ``models/layers.py``)
on the CPU in f32 against the JAX package's.

Weights are the JAX nets' own initial parameters (or the committed
``cvae256_036`` snapshot), carried across by ``params_from_flax``; inputs
are made with numpy from a seed; the latent noise is JAX's own draw
(``jax.random.normal`` of the key the JAX call consumes), handed to the
port as ``eps``. Tolerances: logits within 1e-5 abs (random nets) and
1e-4 (the trained snapshot, whose logits reach about 30), argmax layouts
>= 99.9% equal, rollouts equal.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from video_layout_generation_tpu.models import convlstm as jlstm
from video_layout_generation_tpu.models import vae as jvae
from video_layout_generation_tpu_torch.io.checkpoint import CheckpointManager
from video_layout_generation_tpu_torch.io.weights import params_from_flax
from video_layout_generation_tpu_torch.models import convlstm as tlstm
from video_layout_generation_tpu_torch.models import vae as tvae
from video_layout_generation_tpu_torch.models.layers import ConvTranspose

N_CLS = 8
LOGIT_ATOL = 1e-5
SNAPSHOT = "artifacts_store/cvae256_036.npz"


def seg_ids(shape, seed, n_cls=N_CLS):
    return np.random.default_rng(seed).integers(0, n_cls, shape).astype(
        np.int32)


def one_hot(ids, n_cls=N_CLS):
    return np.eye(n_cls, dtype=np.float32)[ids]


def t(x):
    return torch.from_numpy(np.array(x))


def loaded(module, variables):
    module.load_state_dict(params_from_flax(variables), strict=True)
    return module


def jax_normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


@pytest.mark.parametrize("hw", [(5, 7), (8, 6), (4, 4)])
def test_same_transposed_conv_matches_flax(hw):
    """flax ``ConvTranspose((3,3), strides=(2,2), padding="SAME")`` pads the
    dilated input (2, 1): torch's padding 0 cropped to 2H x 2W, odd and even
    H != W."""
    x = np.random.default_rng(hw[0]).standard_normal((2,) + hw + (3,)
                                                     ).astype(np.float32)
    m = fnn.ConvTranspose(5, (3, 3), strides=(2, 2), padding="SAME")
    v = m.init(jax.random.key(0), x)
    want = np.asarray(m.apply(v, x))
    ct = loaded(ConvTranspose(3, 5, 3, stride=2, padding=0, crop=1), v)
    with torch.no_grad():
        got = ct(t(x)).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_vae_matches_jax():
    x = one_hot(seg_ids((2, 16, 24), 0))
    jm = jvae.LayoutVAE(N_CLS, latent_dim=6)
    key = jax.random.key(3)
    v = jm.init(jax.random.key(0), x, jax.random.key(1))
    logits, mu, lv = (np.asarray(a) for a in jm.apply(v, x, key))
    tm = loaded(tvae.LayoutVAE(N_CLS, latent_dim=6), v)
    eps = jax_normal(key, mu.shape)
    with torch.no_grad():
        got = [a.numpy() for a in tm(t(x), eps=t(eps))]
        dec = tm.decode(t(mu)).numpy()
    assert mu.shape == (2, 2, 3, 6)
    for g, w in zip(got, (logits, mu, lv)):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(
        dec, np.asarray(jm.apply(v, jnp.asarray(mu), method=jm.decode)),
        rtol=0, atol=LOGIT_ATOL)
    # the state dict carries flax's names: the head of a skip-less decoder
    # is Conv_3
    assert "decoder.Conv_3.kernel" in tm.state_dict()
    assert "encoder.logvar.bias" in tm.state_dict()


def _cvae(n_cls=N_CLS, latent=8, hw=(16, 16), seed=0):
    jm = jvae.LayoutCVAE(n_cls, latent_dim=latent)
    v = jm.init(jax.random.key(seed), jnp.zeros((1,) + hw + (2 * n_cls,)),
                jnp.zeros((1,) + hw + (n_cls,)), jax.random.key(1))
    return jm, v, loaded(tvae.LayoutCVAE(n_cls, latent_dim=latent), v)


def test_cvae_call_and_generate_match_jax():
    jm, v, tm = _cvae()
    ctx = np.concatenate([one_hot(seg_ids((2, 16, 16), 1)),
                          one_hot(seg_ids((2, 16, 16), 2))], -1)
    tgt = one_hot(seg_ids((2, 16, 16), 3))
    key = jax.random.key(5)
    logits, (mq, lq), (mp, lp) = jm.apply(v, ctx, tgt, key)
    gen = np.asarray(jm.apply(v, ctx, key, method=jm.generate))
    eps = jax_normal(key, (2, 2, 2, 8))
    with torch.no_grad():
        got, q, p = tm(t(ctx), t(tgt), eps=t(eps))
        got_gen = tm.generate(t(ctx), eps=t(eps)).numpy()
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), rtol=0,
                               atol=LOGIT_ATOL)
    for g, w in zip((*q, *p), (mq, lq, mp, lp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOGIT_ATOL)
    np.testing.assert_allclose(got_gen, gen, rtol=0, atol=LOGIT_ATOL)


def test_cvae_from_seed_keeps_logvar_bias():
    """The port's own initial weights: logvar biases start at -5 (without
    it the posterior collapses), every other bias at 0."""
    tm = tvae.LayoutCVAE(N_CLS, latent_dim=4,
                         generator=torch.Generator().manual_seed(0))
    for name, p in tm.state_dict().items():
        if name.endswith("logvar.bias"):
            assert torch.all(p == -5.0), name
        elif name.endswith("bias"):
            assert torch.all(p == 0.0), name


def test_cvae_rollout_matches_jax():
    """``make_cvae_rollout`` over 4 frames with JAX's per-step draws (one
    key a frame, ``split(rng, n_frames)``)."""
    jm, v, tm = _cvae(seed=2)
    s1, s2 = seg_ids((2, 16, 16), 6), seg_ids((2, 16, 16), 7)
    rng = jax.random.key(11)
    want = np.asarray(jvae.make_cvae_rollout(jm, 4, N_CLS)(
        v, jnp.asarray(s1), jnp.asarray(s2), rng))
    eps = [t(jax_normal(k, (2, 2, 2, 8)))
           for k in jax.random.split(rng, 4)]
    got = tvae.make_cvae_rollout(tm, 4, N_CLS)(t(s1), t(s2), eps=eps)
    assert got.shape == want.shape == (2, 4, 16, 16)
    assert np.mean(got.numpy() == want) >= 0.999


def test_cvae_snapshot_matches_jax():
    """The trained config-3 snapshot (latent 64, 20 classes) at 64x64 with
    all 42 tensors loaded: logits within 1e-4, argmax >= 99.9% equal."""
    tree = CheckpointManager.restore_path(SNAPSHOT)
    assert len(tree["params"]) == 42 and tree["arch"] == "layout_cvae"
    tm = tvae.LayoutCVAE(20, latent_dim=64)
    tm.load_state_dict(tree["params"], strict=True)
    jm = jvae.LayoutCVAE(20, latent_dim=64)
    with np.load(SNAPSHOT) as z:
        params = {}
        for k in z.files:
            if k.startswith("params/"):
                node = params
                *path, leaf = k.split("/")[1:]
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(z[k])
    v = {"params": params}
    ctx = np.concatenate([one_hot(seg_ids((2, 64, 64), 8, 20), 20),
                          one_hot(seg_ids((2, 64, 64), 9, 20), 20)], -1)
    key = jax.random.key(13)
    want = np.asarray(jm.apply(v, ctx, key, method=jm.generate))
    with torch.no_grad():
        got = tm.generate(t(ctx), eps=t(jax_normal(key, (2, 8, 8, 64))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert np.mean(got.numpy().argmax(-1) == want.argmax(-1)) >= 0.999


def _convlstm(hidden=8, enc_width=4, t_ctx=3):
    jm = jlstm.ConvLSTMLayoutPredictor(N_CLS, hidden=hidden,
                                       enc_width=enc_width)
    v = jm.init(jax.random.key(0), jnp.zeros((1, t_ctx, 16, 16, N_CLS)))
    tm = loaded(tlstm.ConvLSTMLayoutPredictor(N_CLS, hidden, enc_width), v)
    return jm, v, tm


def test_convlstm_call_and_rollout_match_jax():
    jm, v, tm = _convlstm()
    ctx = one_hot(seg_ids((2, 3, 16, 16), 10))
    want = np.asarray(jm.apply(v, ctx))
    want_ro = np.asarray(jm.apply(v, ctx, 4, method=jm.rollout))
    with torch.no_grad():
        got = tm(t(ctx)).numpy()
        got_ro = tm.rollout(t(ctx), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    assert got_ro.shape == want_ro.shape == (2, 4, 16, 16)
    assert np.mean(got_ro == want_ro) >= 0.999
    assert set(tm.state_dict()) == {
        "enc.kernel", "enc.bias", "cell.gates.kernel", "cell.gates.bias",
        "dec.kernel", "dec.bias"}


def test_convlstm_carry_in_compute_dtype():
    """The carry is kept in the compute dtype, as the JAX package keeps
    it; logits come back f32."""
    tm = tlstm.ConvLSTMLayoutPredictor(N_CLS, 8, 4, dtype=torch.bfloat16,
                                       generator=torch.Generator()
                                       .manual_seed(0))
    ctx = t(one_hot(seg_ids((1, 2, 8, 8), 12)))
    carry = tm._run_context(ctx)
    assert carry[0].dtype == carry[1].dtype == torch.bfloat16
    assert tm(ctx).dtype == torch.float32
