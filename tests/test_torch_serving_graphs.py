"""CUDA graphs of the served rollout (``serving.py``) on the card, with
kernels A and B: the graphed predictor's frames and layouts bit for bit
against eager runs of a predictor built the same way, the launch counters
on every replay, and the paths that stay eager; and the plain mode
(``kernels.plain()``), under which no kernel of the port launches.

Every test here needs an NVIDIA card (and ``nvcc`` for the kernels): they
carry the ``cuda`` marker and skip without a card. The file imports no JAX,
so that it runs on a machine with the card and without JAX:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_serving_graphs.py
"""

import numpy as np
import pytest
import torch

from video_layout_generation_tpu_torch.models import (HNED, GridNet,
                                                      ResnetGenerator)
from video_layout_generation_tpu_torch.ops import kernels
from video_layout_generation_tpu_torch.ops.kernels import launch_counts
from video_layout_generation_tpu_torch.parallel import make_mesh
from video_layout_generation_tpu_torch.serving import LayoutPredictor

pytestmark = pytest.mark.cuda

FILTERS, FRAMES, N_CLASSES = (32, 64, 96), 3, 20


@pytest.fixture(scope="module")
def weights():
    """(GridNet state dicts by ``use_edges``, an HNED state dict), made from
    a seed on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.manual_seed(0)
    gen = {edges: GridNet(n_channels=10 if edges else 8,
                          filters_level=FILTERS).state_dict()
           for edges in (False, True)}
    return gen, HNED().state_dict()


def predictor(weights, edges, quantize, batch, hw, **kw):
    gen, hned = weights
    return LayoutPredictor(
        "GridNet", gen[edges], n_frames=FRAMES, batch=batch, image_hw=hw,
        filters_level=FILTERS, use_bf16=True,
        hned=HNED(dtype=torch.bfloat16) if edges else None,
        hned_params=hned if edges else None, use_edges=edges,
        quantize_transfer=quantize, n_classes=N_CLASSES, device="cuda", **kw)


def request(n, hw, seed):
    rng = np.random.default_rng(seed)
    img1, img2 = (rng.random((n,) + hw + (3,)).astype(np.float32)
                  for _ in range(2))
    seg1, seg2 = (rng.integers(0, N_CLASSES, (n,) + hw) for _ in range(2))
    return img1, img2, seg1, seg2


def moved_by(fn):
    """(fn(), the launch counters' moves over it)."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def assert_same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# (batch, sequences a request, use_edges, quantize_transfer, image_hw,
# GridNet's upsampling)
CASES = [(1, 1, True, False, (256, 256), "bilinear"),
         (1, 1, False, False, (256, 256), "bilinear"),
         (2, 1, True, True, (64, 64), "bilinear"),
         (2, 1, False, True, (64, 64), "bilinear"),
         (16, 16, True, False, (256, 256), "bilinear"),
         (16, 16, False, False, (256, 256), "bilinear"),
         (2, 2, True, False, (64, 64), "nearest")]


@pytest.mark.parametrize("batch,n,edges,quantize,hw,upsample", CASES)
def test_replays_equal_eager_runs_bit_for_bit(weights, batch, n, edges,
                                             quantize, hw, upsample):
    """Three distinct requests served by replay (the first of them by the
    capture) equal each one's eager run, a fresh predictor's first request;
    every request moves the launch counters by as much as an eager one."""
    reqs = [request(n, hw, seed) for seed in range(3)]
    want = []
    for req in reqs:
        fresh = predictor(weights, edges, quantize, batch, hw,
                          upsample=upsample)
        want.append(fresh.predict(*req))
        assert fresh.rollouts == {"replayed": 0, "eager": 1, "captured": 0}
    pred = predictor(weights, edges, quantize, batch, hw, upsample=upsample)
    first, eager_moved = moved_by(lambda: pred.predict(*reqs[0]))
    assert_same(first, want[0])
    assert eager_moved["prelu_conv3x3"] > 0 and eager_moved["fused_lateral"] > 0
    for req, w in zip(reqs + reqs[:1], want + want[:1]):
        got, moved = moved_by(lambda: pred.predict(*req))
        assert moved == eager_moved
        assert_same(got, w)
    assert pred.rollouts == {"replayed": 4, "eager": 1, "captured": 1}
    (rep,) = pred._replicas
    assert len(rep.graphs) == 1


def test_pipelined_replays_equal_predict(weights):
    """With two requests enqueued at once, request i+1's replay overwrites
    the graphs' static outputs before request i is fetched: the answers
    live outside the graphs' pool and still equal ``predict``'s."""
    hw = (64, 64)
    pred = predictor(weights, True, False, 1, hw)
    reqs = [request(1, hw, seed) for seed in (10, 11, 12)]
    singles = [pred.predict(*req) for req in reqs]
    piped = list(pred.predict_pipelined(iter(reqs), depth=2))
    assert len(piped) == 3
    for got, want in zip(piped, singles):
        assert_same(got, want)
    assert pred.rollouts == {"replayed": 5, "eager": 1, "captured": 1}


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "uint8"])
def test_staged_answers_are_fresh_and_reused_buffers_stay_one(weights,
                                                              quantize):
    """Requests of one shape, full and padded, served eagerly, by the
    capture and by replay through one set of pinned staging buffers: each
    answer equals a fresh predictor's eager run bit for bit, shares no
    memory with the buffers and is unchanged after the next two requests;
    ``predict_pipelined(depth=2)`` equals ``predict``."""
    hw = (64, 64)
    reqs = [request(n, hw, seed) for n, seed in ((2, 40), (1, 41), (2, 42))]
    want = [predictor(weights, True, quantize, 2, hw).predict(*r)
            for r in reqs]
    pred = predictor(weights, True, quantize, 2, hw)
    got = [pred.predict(*r) for r in reqs]
    kept = [a.copy() for a in got[0]]
    got += [pred.predict(*r) for r in reqs[1:]]
    assert_same(got[0], kept)
    (st,) = pred._staging.values()
    assert all(buf.is_pinned() for buf in (st.x, st.frames, st.layouts))
    for g, w in zip(got, want + want[1:]):
        assert_same(g, w)
        assert not any(np.shares_memory(a, buf.numpy()) for a in g
                       for buf in (st.x, st.frames, st.layouts))
    piped = list(pred.predict_pipelined(iter(reqs), depth=2))
    for g, w in zip(piped, want):
        assert_same(g, w)
    assert pred.staging == {"staged": 8, "buffers": 1}
    assert pred.rollouts == {"replayed": 7, "eager": 1, "captured": 1}


def test_mesh_replicas_graph_on_their_own(weights):
    """A mesh of two replicas (on the one card) captures a chain of graphs
    a replica and replays both; its answers equal its eager ones."""
    hw = (64, 64)
    mesh = lambda: make_mesh(["cuda:0", "cuda:0"])  # noqa: E731
    reqs = [request(2, hw, seed) for seed in (20, 21)]
    want = [predictor(weights, True, False, 2, hw, mesh=mesh()).predict(*r)
            for r in reqs]
    pred = predictor(weights, True, False, 2, hw, mesh=mesh())
    for req, w in zip(reqs[:1] + reqs, want[:1] + want):
        assert_same(pred.predict(*req), w)
    assert pred.rollouts == {"replayed": 2, "eager": 1, "captured": 2}
    assert [len(rep.graphs) for rep in pred._replicas] == [1, 1]


def test_plain_predictor_on_the_card_stays_eager(weights):
    """Requests under ``kernels.plain()`` (the on-card reference) never
    capture."""
    hw = (64, 64)
    req = request(1, hw, 30)
    with kernels.plain():
        pred = predictor(weights, False, False, 1, hw)
        outs = [pred.predict(*req) for _ in range(3)]
    assert pred.rollouts == {"replayed": 0, "eager": 3, "captured": 0}
    assert pred._replicas[0].stream is None
    assert_same(outs[2], outs[0])


def test_the_plain_mode_launches_no_kernel_on_the_card(weights):
    """Under ``kernels.plain()`` a forward of GridNet and of a
    ResnetGenerator and an SSIM loss on the card move no launch counter;
    outside it the same calls launch A, B, the InstanceNorm and SSIM
    kernels."""
    gen, _ = weights
    grid = GridNet(n_channels=8, filters_level=FILTERS, dtype=torch.bfloat16)
    grid.load_state_dict(gen[False])
    res = ResnetGenerator(input_nc=8, ngf=8, n_blocks=1,
                          dtype=torch.bfloat16)
    grid, res = grid.to("cuda").eval(), res.to("cuda").eval()
    torch.manual_seed(1)
    x = torch.randn(2, 64, 64, 8, device="cuda")
    y = torch.rand(2, 64, 64, 3, device="cuda", dtype=torch.bfloat16)

    def calls():
        return grid(x), res(x), kernels.ssim_loss(y, y.flip(1))

    with torch.no_grad():
        with kernels.plain():
            plain, moved_plain = moved_by(calls)
        kern, moved = moved_by(calls)
    assert set(moved_plain.values()) == {0}
    assert (moved["prelu_conv3x3"], moved["fused_lateral"],
            moved["instance_norm_fwd_only"], moved["ssim_loss"]) \
        == (31, 15, 7, 1)
    assert float(plain[2]) == pytest.approx(float(kern[2]), rel=1e-4)
