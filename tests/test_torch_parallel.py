"""The port's process group and mesh (``parallel/``) on the CPU.

In one process: ``make_mesh`` against the JAX package's (the same shapes,
the same ``ValueError`` for a shape that needs more devices than exist,
the port's adding how to launch one process a device), the one-process
identities of the helpers, and ``LayoutPredictor`` on a two-entry CPU mesh
against no mesh.

In two ranks of a Gloo group (``torch.multiprocessing.spawn`` with the
``torchrun`` variables, ``tests/test_torch_dp_worker.py``): joining the group
from the environment, rank, world size, ``is_primary``, the barriers, the
flat all-reduce (one bucket a dtype), the mesh over the ranks, sharding a
global batch, replicating rank 0's tensors, and the loader's ``ValueError``
for a batch the ranks cannot split; then the two traps of a step over
ranks, each with inputs where doing it locally gives another answer:

- (a) losses whose normaliser, mask or sign depends on the whole batch
  (``class_weighted_ce`` with rank 0's rows all background; ``vae_loss``
  with free bits open on one rank's dimensions and floored on the other's,
  and the capacity between the two ranks' own KL): the ranks' shares add
  up to the one-process value (1e-6 relative), the rows' gradients are the
  one-process gradients' rows (1e-6 of the largest), and the mean of the
  ranks' local losses is more than 1e-2 away;
- (b) per-sample draws (the per-example flip, the scheduled-sampling mask,
  the K-step noise, the CVAE noise, the latent noise, the WGAN-GP mixing
  weights): the ranks' draws are the one-process draw's rows, bit for bit,
  and differ between the ranks (a local draw would repeat rank 0's rows).
"""

import numpy as np
import pytest
import torch

import test_torch_dp_worker as w
from video_layout_generation_tpu.parallel import mesh as jmesh
from video_layout_generation_tpu_torch import parallel as par


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with w.torch_threads(1):
        return w.run_ranks(w.primitives, tmp_path_factory.mktemp("dp_prims"),
                           meanwhile=lambda: dict(
                               traps=w.trap_losses(w.whole),
                               draws=w.trap_draws(w.whole)))


def test_make_mesh_matches_jax_in_one_process(devices):
    for shape in (None, [8], [4, 2], [2, 2]):
        names = ("data",) if shape is None or len(shape) == 1 else \
            ("data", "model")
        j = jmesh.make_mesh(devices, shape, names)
        t = par.make_mesh(["cpu"] * len(devices), shape, names)
        assert tuple(j.devices.shape) == t.shape and j.size == t.size
        assert j.axis_names == t.axis_names
        assert len(t.devices) == t.size
    for shape in ([16], (3, 3)):
        with pytest.raises(ValueError) as je:
            jmesh.make_mesh(devices, shape)
        with pytest.raises(ValueError) as te:
            par.make_mesh(["cpu"] * len(devices), shape)
        assert str(te.value).startswith(str(je.value))
        assert "torchrun --nproc_per_node" in str(te.value)


def test_one_process_identities():
    assert not par.in_group() and par.is_primary()
    assert par.process_index() == 0 and par.process_count() == 1
    assert not par.maybe_initialize_distributed("cpu")  # no launcher env
    par.cross_process_barrier("nothing")
    x = torch.arange(6.0).reshape(3, 2)
    assert par.all_reduce_flat([x])[0] is x
    assert par.global_sum(x) is x and par.plain_share(x) is x
    g = torch.Generator().manual_seed(0)
    got = par.draw_rows(lambda m: torch.rand(m, 3, generator=g), 4, dim=0)
    assert torch.equal(got, torch.rand(4, 3, generator=g.manual_seed(0)))
    mesh = par.make_mesh()
    assert mesh.size == 1 and mesh.devices == (torch.device("cpu"),)
    assert par.training_mesh(None).size == par.training_mesh([1]).size == 1
    with pytest.raises(ValueError, match=r"mesh shape \[2\] needs 2 devices, "
                       r"have 1; .*torchrun --nproc_per_node 2"):
        par.training_mesh((2,))
    with pytest.raises(ValueError, match="2 devices but the run has 1"):
        _two_device_training_mesh()
    shards = par.shard_batch({"x": np.arange(8).reshape(4, 2)},
                             par.make_mesh(["cpu", "cpu"]))
    assert [s["x"].tolist() for s in shards] == [[[0, 1], [2, 3]],
                                                 [[4, 5], [6, 7]]]


def _two_device_training_mesh():
    """A one-process run handed a two-device mesh it could build."""
    real = par.mesh.make_mesh
    try:
        par.mesh.make_mesh = lambda shape: real(["cpu", "cpu"], shape)
        return par.training_mesh([2])
    finally:
        par.mesh.make_mesh = real


def test_two_ranks_group_primitives(runs):
    ranks = runs[0]
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["world"] == 2
        assert out["primary"] == (r == 0) and out["again"] is False
        f32, i64, f32x2 = out["reduced"]
        assert f32.tolist() == [3.0] * 3 and f32x2.tolist() == [6.0] * 3
        assert i64.dtype == torch.int64 and i64.tolist() == [[1, 10]]
        assert float(out["global_sum"]) == 3.0
        assert out["mesh"] == ((2,), 2, ["cpu"])
        assert out["training_mesh"] == 2
        assert "[4] needs 4 devices, have 2" in out["too_big"]
        assert out["shard"].tolist() == [[0, 1], [2, 3]] if r == 0 else \
            out["shard"].tolist() == [[4, 5], [6, 7]]
        assert out["replicated"].tolist() == [0.0, 0.0]
        assert out["indivisible"] == ("batch_size 3 not divisible by "
                                      "process count 2")


def test_trap_a_global_normalisers(runs):
    ranks, ref = runs[0], runs[1]["traps"]
    got = [r["traps"] for r in ranks]
    for key in ("total", "ce"):
        total = sum(float(g[key]) for g in got)
        np.testing.assert_allclose(total, float(ref[key]), rtol=1e-6)
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(sum(float(g["metrics"][k]) for g in got),
                                   float(v), rtol=1e-6, err_msg=k)
    for i, g_ref in enumerate(ref["grads"]):
        g_cat = torch.cat([g["grads"][i] for g in got])
        top = float(g_ref.abs().max())
        assert float((g_cat - g_ref).abs().max()) <= 1e-6 * top, i
    # the local alternative: each rank's loss over its own rows, averaged
    from video_layout_generation_tpu_torch.losses.ce import class_weighted_ce
    from video_layout_generation_tpu_torch.losses.vae import vae_loss
    logits, labels, mu, logvar = w.trap_inputs()
    halves = [slice(0, 2), slice(2, 4)]
    local_total = np.mean([float(vae_loss(
        logits[h], labels[h], mu[h], logvar[h], beta=0.5,
        free_bits=w.TRAP_FREE_BITS, capacity=w.TRAP_CAPACITY,
        class_weights=w.TRAP_CLASS_WEIGHTS)[0]) for h in halves])
    local_ce = np.mean([float(class_weighted_ce(
        logits[h], labels[h], w.TRAP_CLASS_WEIGHTS)) for h in halves])
    assert abs(local_total - float(ref["total"])) > 1e-2 * abs(
        float(ref["total"]))
    assert abs(local_ce - float(ref["ce"])) > 1e-2 * abs(float(ref["ce"]))


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            out.update({f"{prefix}{k}.{i}": t for i, t in enumerate(v)})
        else:
            out[prefix + k] = v
    return out


def test_trap_b_draws_are_rows_of_the_global_draw(runs):
    ranks, ref = runs[0], _flat(runs[1]["draws"])
    got = [_flat(r["draws"]) for r in ranks]
    assert set(got[0]) == set(ref)
    for k, v in ref.items():
        if k == "penalty":    # a mean over the rows: the ranks' average
            np.testing.assert_allclose(
                (float(got[0][k]) + float(got[1][k])) / 2, float(v),
                rtol=1e-6)
            assert float(got[0][k]) != float(got[1][k])
            continue
        # the batch axis: 1 for the K-step stacks, 0 elsewhere
        dim = 1 if (k.startswith("rollout") or k.startswith("cvae.gen_eps")
                    or k in ("cvae.corrupt", "cvae.cls")) else 0
        cat = torch.cat([got[0][k], got[1][k]], dim=dim)
        assert torch.equal(cat, v), k
        assert not torch.equal(got[0][k], got[1][k]), k


def test_layout_predictor_on_two_cpu_mesh_entries_equals_no_mesh():
    """Two replicas on the CPU, each half of a padded batch of 4: frames
    within 1e-6 and layouts equal (a convolution's summation order may
    differ with the batch it sees); a one-entry mesh is the path without a
    mesh, bit for bit."""
    from video_layout_generation_tpu_torch.models import GridNet
    from video_layout_generation_tpu_torch.serving import LayoutPredictor
    torch.manual_seed(30)
    params = GridNet(n_channels=8, filters_level=w.FILTERS).state_dict()
    kw = dict(n_frames=2, batch=4, image_hw=w.HW, filters_level=w.FILTERS,
              use_bf16=False, device="cpu")
    rng = np.random.default_rng(31)
    req = (rng.random((3,) + w.HW + (3,), np.float32),
           rng.random((3,) + w.HW + (3,), np.float32),
           rng.integers(0, 20, (3,) + w.HW), rng.integers(0, 20, (3,) + w.HW))
    base = LayoutPredictor("GridNet", params, **kw).predict(*req)
    two = LayoutPredictor("GridNet", params,
                          mesh=par.make_mesh(["cpu", "cpu"]), **kw)
    assert len(two._replicas) == 2
    frames, layouts = two.predict(*req)
    assert frames.shape == base[0].shape == (3, 2) + w.HW + (3,)
    np.testing.assert_allclose(frames, base[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(layouts, base[1])
    one = LayoutPredictor("GridNet", params, mesh=par.make_mesh(["cpu"]),
                          **kw).predict(*req)
    assert one[0].tobytes() == base[0].tobytes()
    assert one[1].tobytes() == base[1].tobytes()


def test_upsample_backward_is_the_adjoint_of_its_interpolation():
    """On the card the up blocks' upsample differentiates through two f32
    matmuls with its interpolation matrices (the library's backward adds
    atomically, in another order each run): the same forward bits, and a
    gradient within f32 rounding of autograd's (1e-6 of the largest),
    here on the CPU in f32 and bf16."""
    from video_layout_generation_tpu_torch.ops import resize
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        x = torch.randn(2, 5, 7, 3).to(dtype).requires_grad_(True)
        y = resize._upsample2x_align(x)
        dy = torch.randn_like(y)
        want, = torch.autograd.grad(y, x, dy)
        y2 = resize._DeterministicUpsample.apply(x)
        got, = torch.autograd.grad(y2, x, dy)
        assert torch.equal(y, y2) and got.dtype == dtype
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max()), (dtype, err)
    # the CPU path keeps the library's backward
    x = torch.randn(1, 4, 4, 2, requires_grad=True)
    assert resize.upsample2x_bilinear_align(x).grad_fn.name() != \
        "_DeterministicUpsampleBackward"
