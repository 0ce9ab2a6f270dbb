"""The port's data-parallel layer (`bevgen_torch/parallel/`) against the
JAX package's `bevgen_tpu/parallel/`, in one process on the CPU: the axis
each optimizer moment is sliced along (`moment_pspec`/`zero_pspec`) for
every leaf of the tiny and the full-width MUSE and AR trees at dp = 1, 2,
3, 4, 8 (shapes only, from `jax.eval_shape`) and on random shapes, the
ZeRO plan over the port's own parameters, `host_shard_indices`, the mesh
layouts and batch axes, the CLIs' `pop_mesh`, the inverse-CDF sampler,
and the global-batch draws: a batch split into rank rows, each with its
`BatchShard`, gives the losses, gradients and ids of the whole batch.
The cross-process checks are `tests/test_torch_distributed.py`.
"""
import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from scipy import stats

from bevgen_tpu.core import config as jcfg
from bevgen_tpu.parallel import distributed as jdist
from bevgen_tpu.parallel import sharding as jshd
from bevgen_torch.core.convert import flax_leaf
from bevgen_torch.models.stage2 import ar as tar
from bevgen_torch.models.stage2 import maskgit as tmg
from bevgen_torch.parallel import distributed as tdist
from bevgen_torch.parallel import sharding as tshd
from bevgen_torch.scripts import cli
from torch_parity import ar_tiny_pipelines, tiny_configs, tiny_pipelines

DPS = (1, 2, 3, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The maskgit or gpt parameter tree of a JAX pipeline, shapes only."""
    from bevgen_tpu.pipelines.ar_generate import ARPipeline
    from bevgen_tpu.pipelines.generate import BEVGenPipeline
    from torch_parity import _jax_ar_pipeline
    key = jax.random.PRNGKey(0)
    if name == "tiny_test":
        pipe = BEVGenPipeline.create(tiny_configs()[0], dtype=jnp.float32)
        return jax.eval_shape(pipe.init_params, key)["maskgit"]
    if name == "tiny_ar":
        return jax.eval_shape(_jax_ar_pipeline().init_params, key)["gpt"]
    if name == "argoverse_muse_7cam":
        pipe = BEVGenPipeline.create(jcfg.argoverse_muse_7cam_config())
        return jax.eval_shape(pipe.init_params, key)["maskgit"]
    pipe = ARPipeline.create(jcfg.nuscenes_ar_config(), use_pallas=False)
    return jax.eval_shape(pipe.init_params, key)["gpt"]


def _mesh(dp):
    """What the JAX rules read of a (dp, tp=1) mesh: its axis sizes."""
    return types.SimpleNamespace(shape={"dp": dp, "tp": 1})


def _path(path):
    """A flax key path as the port names it: "a/b/kernel" (no "params")."""
    keys = [str(getattr(k, "key", k)) for k in path]
    return "/".join(keys[1:] if keys[0] == "params" else keys)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("tree", ["tiny_test", "tiny_ar", "argoverse_muse_7cam",
                                  "nuscenes_ar"])
def test_moment_specs_match_jax_on_every_leaf(tree, dp):
    leaves = jax.tree_util.tree_leaves_with_path(_tree(tree))
    assert len(leaves) > 30
    sliced = 0
    for path, leaf in leaves:
        name = _path(path)
        want = tuple(jshd.moment_pspec(path, leaf, _mesh(dp)))
        got = tshd.moment_pspec(name, leaf.shape, dp)
        assert got == want, (name, leaf.shape)
        assert tshd.zero_pspec(leaf.shape, dp) == tuple(
            jshd.zero_pspec(leaf, dp)), name
        sliced += tshd.moment_axis(name, leaf.shape, dp) is not None
    if dp <= 2:  # most moments are sliced (the rest: tables, odd sizes)
        assert sliced > len(leaves) // 2


_PATHS = ("transformer/layers_0_attn/to_q/kernel", "x/to_kv/kernel_q",
          "a/proj_in/kernel", "b/to_out/kernel", "c/to_logits/kernel",
          "d/to_q/scale", "block_0/query/kernel", "block_1/mlp_proj/kernel",
          "head/scale", "transformer/token_emb/embedding",
          "transformer/cond_pos_emb/embedding", "layers_2_attn/null_kv",
          "ln/bias", "x_tok_emb/embedding", "camera_bias_emb")


@settings(max_examples=150, deadline=None)
@given(shape=st.lists(st.integers(1, 40), min_size=0, max_size=4),
       dp=st.sampled_from(DPS), path=st.sampled_from(_PATHS))
def test_moment_specs_match_jax_on_random_shapes(shape, dp, path):
    leaf = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    key = tuple(jax.tree_util.DictKey(p) for p in path.split("/"))
    assert tshd.moment_pspec(path, shape, dp) == tuple(
        jshd.moment_pspec(key, leaf, _mesh(dp)))
    assert tshd.zero_pspec(shape, dp) == tuple(jshd.zero_pspec(leaf, dp))


def _plan_mesh(dp, rank=0):
    return tshd.Mesh(dcn=1, dp=dp, rank=rank, group=None, dp_group=None,
                     device=torch.device("cpu"))


@pytest.mark.parametrize("dp", [2, 4])
def test_zero_plan_slices_the_port_parameters_where_jax_does(dp):
    """The plan over the port's MaskGit: each parameter's flax path is a
    leaf of the JAX tree, its slice axis the JAX one in the port's layout
    (a Dense kernel transposed), and the ranks' slices tile it."""
    _, _, tp = tiny_pipelines()
    model = tp.maskgit
    jleaves = {_path(p): leaf for p, leaf in
               jax.tree_util.tree_leaves_with_path(_tree("tiny_test"))}
    plans = [tshd.ZeroPlan(model, _plan_mesh(dp, r)) for r in range(dp)]
    for name, p in model.named_parameters():
        path, perm = flax_leaf(model, name)
        assert path in jleaves, name
        assert tuple(p.shape[a] for a in perm) == jleaves[path].shape, name
        spec = tuple(jshd.moment_pspec(path.split("/"), jleaves[path],
                                       _mesh(dp)))
        want = perm[spec.index("dp")] if "dp" in spec else None
        assert plans[0].axes[name] == want, name
        if want is not None:
            torch.testing.assert_close(
                torch.cat([pl.part(name, p) for pl in plans], dim=want), p,
                rtol=0, atol=0)
    assert all(a is None for a in tshd.ZeroPlan(model, _plan_mesh(1)).axes
               .values())


@pytest.mark.parametrize("count", range(1, 9))
def test_host_shard_indices_match_jax(count, monkeypatch):
    for index in range(count):
        monkeypatch.setattr(jax, "process_index", lambda: index)
        monkeypatch.setattr(jax, "process_count", lambda: count)
        for n in range(51):
            assert tdist.host_shard_indices(n, index, count) == \
                jdist.host_shard_indices(n), (n, index, count)


@pytest.mark.parametrize("n,dp,dcn", [(1, None, 1), (2, None, 1), (8, None, 1),
                                      (8, 8, 1), (8, None, 2), (8, 2, 4),
                                      (4, None, 4), (8, 4, 2)])
def test_mesh_layout_and_batch_axes_match_jax(n, dp, dcn):
    jmesh = jshd.make_mesh(dp=dp, dcn=dcn, devices=jax.devices()[:n])
    got_dcn, got_dp = tshd.mesh_layout(n, dp, 1, dcn)
    mesh = tshd.Mesh(got_dcn, got_dp, 0, None, None, torch.device("cpu"))
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.axis_names == jmesh.axis_names
    assert tshd.batch_axes(mesh) == jshd.batch_axes(jmesh)
    assert tshd.data_parallelism(mesh) == jshd.data_parallelism(jmesh)


@pytest.mark.parametrize("per", [8, 4, 2, 1])
def test_multislice_layout_matches_jax(per):
    devices = jax.devices()[:8]
    jmesh = jshd.make_multislice_mesh(devices=devices,
                                      slice_index_of=lambda d: d.id // per)
    dcn, dp = tshd.multislice_layout(8, lambda r: r // per)
    mesh = tshd.Mesh(dcn, dp, 0, None, None, torch.device("cpu"))
    assert mesh.shape == dict(jmesh.shape)
    assert tshd.batch_axes(mesh) == jshd.batch_axes(jmesh)


def test_mesh_layout_refuses_what_the_port_cannot_run():
    with pytest.raises(ValueError, match="tp=4 mesh needs 8 processes"):
        tshd.mesh_layout(4, 2, 4)
    with pytest.raises(ValueError, match="needs 4 processes"):
        tshd.mesh_layout(8, 2, 1, 2)
    with pytest.raises(ValueError, match="not contiguous"):
        tshd.multislice_layout(4, lambda r: r % 2)
    with pytest.raises(ValueError, match="unequal"):
        tshd.multislice_layout(3, lambda r: int(r > 0))
    one = tshd.make_mesh(dp=1)
    assert (one.size, one.group) == (1, None)
    t = torch.arange(3.0)
    assert torch.equal(one.sum(t), t) and one.any(True) and not one.any(False)
    assert one.batch_shard(3) == tshd.BatchShard(3, 0, one.sum)


@pytest.mark.parametrize("args,world,message", [
    ({"dp": "2"}, 1, "torchrun --nproc_per_node=2"),
    ({"dcn": "2"}, 1, "torchrun --nproc_per_node=2"),
    ({"tp": "4"}, 1, "tp=4: 4 ranks in one process; start one process per "
                     "rank with torchrun --nproc_per_node=4"),
    ({"tp": "2", "dp": "2"}, 2, "dcn x dp x tp must equal the 2 processes"),
    ({"dcn": "auto"}, 1, "has no ranks"),
    ({"dp": "3"}, 2, "must equal the 2 processes"),
    ({"dcn": "3"}, 2, "must equal the 2 processes"),
    ({"dp": "zero"}, 1, "positive count"),
])
def test_pop_mesh_exits(args, world, message, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.delenv("BEVGEN_NUM_PROCESSES", raising=False)
    with pytest.raises(SystemExit, match=message):
        cli.pop_mesh(dict(args), "cpu")


def test_pop_mesh_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("BEVGEN_NUM_PROCESSES", raising=False)
    args = {"dp": "1", "tp": "1", "dcn": "1", "other": "x"}
    assert cli.pop_mesh(args, "cpu") is None and args == {"other": "x"}
    assert cli.pop_mesh({}, "cpu") is None
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert cli.pop_device({"device": "cpu"}) == "cpu"


def test_categorical_follows_the_distribution():
    """Inverse-CDF draws of a fixed distribution (two categories of
    probability 0) pass a chi-square test, and are a function of the seed."""
    p = torch.tensor([0.05, 0.0, 0.4, 0.2, 0.15, 0.0, 0.2])
    n = 40000
    u = torch.rand(n, generator=torch.Generator().manual_seed(0))
    got = tar.categorical(p.expand(n, -1), u)
    counts = torch.bincount(got, minlength=p.numel()).numpy()
    assert counts[1] == counts[5] == 0
    keep = p.numpy() > 0
    assert stats.chisquare(counts[keep], n * p.numpy()[keep]).pvalue > 1e-3
    # the edges: u = 0 takes the likeliest category, u just below 1 the
    # least likely positive one (never a category of probability 0)
    edge = tar.categorical(p.expand(2, -1), torch.tensor([0.0, 1.0 - 2 ** -24]))
    assert edge.tolist() == [2, 0]


def test_sample_logits_is_deterministic_and_respects_top_k():
    logits = torch.randn(64, 50, generator=torch.Generator().manual_seed(1))
    runs = [tar.sample_logits(logits, torch.Generator().manual_seed(s), 1.0, 5)
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    top = torch.topk(logits, 5).indices
    assert (runs[0][:, None] == top).any(-1).all()
    # a row of a global draw: the rank's rows of the whole batch's tokens
    shard = tshd.BatchShard(64, 16)
    part = tar.sample_logits(logits[16:32], torch.Generator().manual_seed(3),
                             1.0, 5, shard=shard)
    assert torch.equal(part, runs[0][16:32])


def test_rand_rows_are_the_rows_of_the_global_draw():
    want = torch.rand(6, 3, 4, generator=torch.Generator().manual_seed(2))
    got = tshd.rand_rows((2, 3, 4), torch.Generator().manual_seed(2), "cpu",
                         tshd.BatchShard(6, 4))
    assert torch.equal(got, want[4:])
    assert torch.equal(tshd.rand_rows((), torch.Generator().manual_seed(2),
                                      "cpu", tshd.BatchShard(6, 4)),
                       torch.rand((), generator=torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError, match="rows 5"):
        tshd.rand_rows((2, 3), None, "cpu", tshd.BatchShard(6, 5))


def _two_rank_loss(model, batch, mask, seed):
    """The two ranks' MaskGit loss parts and gradients in one process: the
    masked count summed over both halves first, as the all_reduce does."""
    counts = []
    args = ("tokens", "cond_ids", "intrinsics_inv", "extrinsics_inv")
    half = batch["tokens"].shape[0] // 2

    def part(r, reduce):
        rows = slice(r * half, (r + 1) * half)
        return tmg.maskgit_loss(
            model, *(batch[k][rows] for k in args),
            generator=torch.Generator().manual_seed(seed),
            mask_override=mask[rows],
            gumbel_noise=torch.zeros(batch["tokens"][rows].shape
                                     + (model.cfg.vocab_size,)),
            shard=tshd.BatchShard(2 * half, r * half, reduce))

    for r in range(2):
        with torch.no_grad():
            part(r, lambda t: counts.append(t) or t)
    total = counts[0] + counts[1]
    return [part(r, lambda t: total) for r in range(2)], counts


def test_maskgit_loss_over_rank_rows_is_the_global_batch_loss():
    """Halves that mask 75% and 25% of their tokens: the parts sum to the
    whole batch's loss, CE and gradients, while the mean of the halves'
    own CEs is another number."""
    _, _, tp = tiny_pipelines()
    model = copy.deepcopy(tp.maskgit)
    tf = tiny_configs()[1].transformer
    rng = np.random.default_rng(3)
    B = 4
    from bevgen_torch.models.geometry import canonical_camera_rig
    intr, extr = canonical_camera_rig(tf)
    batch = {"tokens": torch.from_numpy(rng.integers(0, tf.vocab_size, (
                 B, tf.num_cams, tf.num_cam_tokens))),
             "cond_ids": torch.from_numpy(rng.integers(
                 0, tf.cond_vocab_size, (B, tf.num_cond_tokens))),
             "intrinsics_inv": torch.from_numpy(np.broadcast_to(
                 np.linalg.inv(intr), (B, tf.num_cams, 3, 3)).astype(np.float32)),
             "extrinsics_inv": torch.from_numpy(np.broadcast_to(
                 np.linalg.inv(extr), (B, tf.num_cams, 4, 4)).astype(np.float32))}
    prob = np.array([0.75, 0.75, 0.25, 0.25])[:, None, None]
    mask = torch.from_numpy(rng.uniform(size=batch["tokens"].shape) < prob)
    parts, counts = _two_rank_loss(model, batch, mask, seed=5)
    assert int(counts[0]) > 2 * int(counts[1])
    whole = tmg.maskgit_loss(
        model, batch["tokens"], batch["cond_ids"], batch["intrinsics_inv"],
        batch["extrinsics_inv"], generator=torch.Generator().manual_seed(5),
        mask_override=mask,
        gumbel_noise=torch.zeros(batch["tokens"].shape + (tf.vocab_size,)))
    for k in ("loss", "ce_loss", "critic_loss"):
        got = sum(float(getattr(p, k).detach()) for p in parts)
        assert got == pytest.approx(float(getattr(whole, k).detach()),
                                    rel=1e-5), k
    total = float(counts[0] + counts[1])
    mean_of_means = np.mean([float(p.ce_loss.detach()) * total / float(c)
                             for p, c in zip(parts, counts)])
    ce = float(whole.ce_loss.detach())
    assert abs(mean_of_means - ce) > 100 * 1e-5 * ce
    params = [p for _, p in model.named_parameters()]
    g_parts = [torch.autograd.grad(p.loss, params, allow_unused=True)
               for p in parts]
    g_whole = torch.autograd.grad(whole.loss, params, allow_unused=True)
    for a, b, w in zip(*g_parts, g_whole):
        if w is None:
            continue
        torch.testing.assert_close(a + b, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()) + 1e-7)


@pytest.mark.parametrize("kind", ["muse", "ar"])
def test_generate_over_rank_rows_is_the_whole_batch(kind):
    """Sampling on (gumbel and critic noise for MUSE; top-k 8 categorical
    draws for AR): the rows decoded one at a time, each with its
    BatchShard and an equally seeded generator, are the whole batch's."""
    from bevgen_torch.data.fake import fake_batch
    pipe = (ar_tiny_pipelines() if kind == "ar" else tiny_pipelines())[2]
    batch = fake_batch(pipe.config, 2, seed=7)
    arrays = [batch[k] for k in ("segmentation", "intrinsics_inv",
                                 "extrinsics_inv")]
    kw = {"top_k": 8} if kind == "ar" else {}
    _, want = pipe.generate_fn(*arrays, torch.Generator().manual_seed(4), **kw)
    for r in range(2):
        _, got = pipe.generate_fn(*(a[r:r + 1] for a in arrays),
                                  torch.Generator().manual_seed(4),
                                  shard=tshd.BatchShard(2, r), **kw)
        assert torch.equal(got, want[r:r + 1]), r
