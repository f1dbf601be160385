"""ray_tpu_torch's ResNet held against ray_tpu.models.resnet on the CPU,
and the port's trees with lists (``stage{i}`` is a list of bottleneck
dicts) held against JAX's pytrees.

Weights come from the JAX init of ``tiny`` (32×32 images, two stages),
its zero head redrawn from a seed so that every gradient is nonzero, and
cross by ``params_from_numpy``; images are made with numpy from a seed.
Both sides run in float32 unless a test says otherwise.  ``tiny``'s 32²
input has ResNet-50's 224² parity: every stride-2 conv and the max-pool
see even sizes, where XLA's "SAME" padding is asymmetric.

Tolerances, each with its reason (those of tests/test_torch_train.py):
float32 on both sides, with sums taken in other orders.  Logits to 1e-5
of their largest magnitude; the loss to 1e-5 relative; a gradient leaf
to 1e-4 of its largest element (gradients sum over every pixel of the
batch); train-program trajectories to 1e-4 relative on losses, 1e-3 on
grad norms and each leaf's update to 1e-3 of its L2 norm.  The bf16
forward: see ``test_bf16_forward_matches_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from ray_tpu.models import resnet as jres
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd
from ray_tpu_torch.models import resnet as tres
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.parallel import spmd as tspmd
from ray_tpu_torch.parallel import transforms as tx


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jres.tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tres.tiny(), dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tree():
    """The reference's tiny init as numpy, the zero head redrawn."""
    jcfg, _ = _cfgs()
    t = jax.tree.map(np.asarray, jax.jit(jres.init_params, static_argnums=1)(
        jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    for k in ("kernel", "bias"):
        t["head"][k] = (0.1 * rng.standard_normal(t["head"][k].shape)) \
            .astype(np.float32)
    return t


# the reference's functions compiled once (eager JAX compiles every op)
_jforward = jax.jit(jres.forward, static_argnums=2)
_jloss_grads = jax.jit(jax.value_and_grad(jres.loss_fn), static_argnums=(2, 3))


def _batch(B=2, hw=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((B, hw, hw, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, B).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_close_scaled(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * np.abs(ref).max())


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _assert_tree_close(got, ref, rel=1e-4):
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(got)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=rel * np.abs(r).max() + 1e-8,
                                   err_msg=jax.tree_util.keystr(path))


def _port_grads(tree, batch, cfg, **kw):
    tp = params_from_numpy(tree, cfg, "cpu")
    leaves = tx.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tres.loss_fn(tp, _t(batch), cfg, **kw)
    it = iter(torch.autograd.grad(loss, leaves))
    return loss, params_to_numpy(tx.tree_map(lambda _: next(it), tp))


# ------------------------------------------------------------- forward
def test_forward_matches_jax(tree):
    jcfg, tcfg = _cfgs()
    imgs = _batch()["images"]
    ref = _jforward(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs), jcfg)
    got = tres.forward(params_from_numpy(tree, tcfg, "cpu"),
                       torch.from_numpy(imgs), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10)
    _assert_close_scaled(got.numpy(), ref)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_loss_and_grads_match_jax(tree, label_smoothing):
    jcfg, tcfg = _cfgs()
    batch = _batch(seed=1)
    jloss, jgrads = _jloss_grads(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        label_smoothing)
    tloss, tgrads = _port_grads(tree, batch, tcfg,
                                label_smoothing=label_smoothing)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close(tgrads, jax.tree.map(np.asarray, jgrads))


def test_accuracy_matches_jax(tree):
    jcfg, tcfg = _cfgs()
    batch = _batch(B=8, seed=2)
    ref = jax.jit(jres.accuracy, static_argnums=2)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    got = tres.accuracy(params_from_numpy(tree, tcfg, "cpu"), _t(batch),
                        tcfg)
    assert got.item() == float(ref)


def test_zero_head_gives_ln_classes_and_only_head_gradients():
    """At the reference's init the head is zero: the loss is exactly
    ln(num_classes) and every gradient but the head's is zero (why the
    other tests redraw the head)."""
    _, tcfg = _cfgs()
    tp = tres.init_params(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    leaves = tx.tree_leaves_with_path(tp)
    for _, p in leaves:
        p.requires_grad_(True)
    loss = tres.loss_fn(tp, _t(_batch()), tcfg)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    assert loss.item() == pytest.approx(np.log(10), abs=1e-6)
    for (path, _), g in zip(leaves, grads):
        assert path.startswith("head/") or not g.any(), path


# ------------------------------------------------------------- padding
@pytest.mark.parametrize("n,k,s,expected", [
    (224, 7, 2, (2, 3)),      # ResNet-50's stem
    (112, 3, 2, (0, 1)),      # its max-pool
    (56, 3, 2, (0, 1)),       # a stage's first 3x3 / 2
    (56, 1, 2, (0, 0)),       # a stride-2 projection
    (56, 3, 1, (1, 1)),       # a stride-1 3x3
    (32, 7, 2, (2, 3)),       # tiny's stem
    (7, 3, 2, (1, 1)),        # an odd size
])
def test_same_pads_are_xla_same(n, k, s, expected):
    assert tres._same_pads(n, k, s) == expected
    assert tuple(lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]) == \
        expected


def _nchw(x: np.ndarray) -> torch.Tensor:
    """(B, H, W, C) numpy → (B, C, H, W) channels-last, as the model."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (1, 2), (3, 1)])
def test_conv_matches_xla_same(k, stride):
    """The standardised conv at tiny's even sizes, against the reference's
    ``_conv``; at stride 2 and k > 1 the symmetric ``padding=k//2`` of a
    plain ``F.conv2d`` fails the same comparison."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    w = rng.standard_normal((k, k, 8, 4)).astype(np.float32)
    ref = np.asarray(jres._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tres._conv(_nchw(x), torch.from_numpy(w), stride)
    _assert_close_scaled(got.permute(0, 2, 3, 1).numpy(), ref)
    if stride == 2 and k > 1:
        ws = tres._standardize(torch.from_numpy(w)).permute(3, 2, 0, 1)
        sym = F.conv2d(_nchw(x), ws, stride=stride, padding=k // 2)
        assert sym.shape == got.shape
        assert _rel_err(sym.permute(0, 2, 3, 1).numpy(), ref) > 0.1


def test_max_pool_matches_xla_same():
    """3x3 / 2 max-pool, SAME with −inf, at even sizes; the symmetric
    padding of ``F.max_pool2d(padding=1)`` gives the same shape and other
    values."""
    x = np.random.default_rng(4).standard_normal((2, 16, 16, 8)).astype(
        np.float32)
    ref = np.asarray(lax.reduce_window(
        jnp.asarray(x), -jnp.inf, lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    got = tres._max_pool(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    sym = F.max_pool2d(_nchw(x), 3, 2, padding=1).permute(0, 2, 3, 1)
    assert sym.shape == got.shape and not np.array_equal(sym.numpy(), ref)


def test_symmetric_padding_fails_the_forward_comparison(tree, monkeypatch):
    """The control of test_forward_matches_jax: PyTorch's symmetric
    ``k//2`` padding (same output sizes) at every conv and the max-pool
    moves the logits far beyond that test's limit."""
    jcfg, tcfg = _cfgs()
    imgs = _batch()["images"]
    ref = _jforward(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs), jcfg)
    monkeypatch.setattr(tres, "_same_pads", lambda n, k, s: (k // 2, k // 2))
    got = tres.forward(params_from_numpy(tree, tcfg, "cpu"),
                       torch.from_numpy(imgs), tcfg)
    assert tuple(got.shape) == (2, 10)
    assert _rel_err(got.numpy(), ref) > 1e-2


# ------------------------------------------------------------ variances
def test_weight_standardisation_is_biased():
    """Mean and BIASED variance over (kh, kw, cin), eps 1e-10: equal to
    the reference's and to numpy's ddof=0; ddof=1 (torch.var's default)
    differs by sqrt(n / (n - 1)) - 1 = 1.4 % at n = 36."""
    w = np.random.default_rng(5).standard_normal((3, 3, 4, 6)).astype(
        np.float32)
    got = tres._standardize(torch.from_numpy(w)).numpy()
    _assert_close_scaled(got, np.asarray(jres._standardize(jnp.asarray(w))))
    mu = w.mean((0, 1, 2), keepdims=True)
    for ddof, match in ((0, True), (1, False)):
        ref = (w - mu) / np.sqrt(w.var((0, 1, 2), keepdims=True, ddof=ddof)
                                 + 1e-10)
        assert (_rel_err(got, ref) < 1e-5) == match


@pytest.mark.parametrize("C,groups", [(8, 4), (16, 32)])
def test_group_norm_is_biased(C, groups):
    """Contiguous channel blocks, min(groups, C) of them, float32 biased
    statistics over (H, W, channels of the group), eps 1e-5; (16, 32): C
    below the group count, one channel a group."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 3, C)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = np.asarray(jres._group_norm(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), groups))
    got = tres._group_norm(_nchw(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), groups)
    got = got.permute(0, 2, 3, 1).numpy()
    _assert_close_scaled(got, ref)
    g = min(groups, C)
    xg = x.reshape(2, 3, 3, g, C // g)
    for ddof, match in ((0, True), (1, False)):
        var = xg.var((1, 2, 4), keepdims=True, ddof=ddof)
        y = ((xg - xg.mean((1, 2, 4), keepdims=True)) / np.sqrt(var + 1e-5)
             ).reshape(x.shape) * scale + bias
        assert (_rel_err(got, y) < 1e-5) == match


# ---------------------------------------------------------------- trees
def test_tree_leaves_walk_lists_in_the_reference_order(tree):
    """The port's tree_leaves and paths on a tree with lists: JAX's
    pytree order (dict keys sorted, list items in order)."""
    _, tcfg = _cfgs()
    tp = params_from_numpy(tree, tcfg, "cpu")
    assert isinstance(tp["stage0"], list) and len(tp["stage1"]) == 1
    ref = jax.tree_util.tree_leaves_with_path(tree)
    got = tx.tree_leaves_with_path(tp)
    assert len(got) == len(ref) == len(tx.tree_leaves(tp))
    for (rpath, r), (path, g) in zip(ref, got):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in rpath]
        assert path == "/".join(keys)
        np.testing.assert_array_equal(g.numpy(), r)
    assert got[0][0] == "head/bias" and got[-1][0] == "stem/gn/scale"
    mapped = tx.tree_map(lambda a, b: a + b, tp, tp)
    assert isinstance(mapped["stage0"], list)
    np.testing.assert_array_equal(
        mapped["stage1"][0]["conv2"].numpy(), 2 * tree["stage1"][0]["conv2"])


def test_params_round_trip(tree):
    """The reference's numpy tree → the port's tensors → numpy: the same
    pytree (lists stay lists) and values."""
    _, tcfg = _cfgs()
    back = params_to_numpy(params_from_numpy(tree, tcfg, "cpu"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("preset", ["resnet50", "tiny"])
def test_init_params_matches_jax_shapes(preset):
    """The port's tree (on meta: nothing drawn) against jax.eval_shape of
    the reference's init: the same keys, lists, shapes and count."""
    ref = jax.eval_shape(lambda: jres.init_params(
        jax.random.key(0), jres.PRESETS[preset]()))
    got = tres.init_params(None, tres.PRESETS[preset](), device="meta")
    assert tx.tree_map(lambda t: tuple(t.shape), got) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    n = tres.param_count(got)
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    if preset == "resnet50":
        assert 23.4e6 < n < 25.6e6


def test_init_params_draws_the_reference_scales():
    _, tcfg = _cfgs()
    p = tres.init_params(torch.Generator().manual_seed(0),
                         dataclasses.replace(tcfg, width=64), device="cpu")
    w = p["stage0"][0]["conv2"]                       # (3, 3, 64, 64)
    assert abs(w.std().item() - np.sqrt(2 / (9 * 64))) < 0.01 * w.std()
    assert not p["head"]["kernel"].any() and p["stem"]["gn"]["scale"].eq(
        1).all()


def test_rules_are_the_reference_partition_specs():
    ref = [(pat, tuple(spec)) for pat, spec in jres.RESNET_RULES]
    assert tres.RESNET_RULES == ref


def test_remat_on_matches_remat_off(tree):
    """Checkpointed blocks replay the same forward: the same gradients."""
    _, off = _cfgs()
    on = dataclasses.replace(off, remat=True)
    batch = _batch(seed=7)
    a = jax.tree_util.tree_leaves(_port_grads(tree, batch, off)[1])
    b = jax.tree_util.tree_leaves(_port_grads(tree, batch, on)[1])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------- train program
def test_train_program_trajectory_matches_jax(tree):
    """Three steps of build_train_program on one batch, both sides: the
    optimizer, grads_of and shard_batch walk the stage lists."""
    jcfg, tcfg = _cfgs()
    batch = _batch(B=4, seed=8)
    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, b: jres.loss_fn(p, b, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=1e-2, warmup=1, total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc,
        rules=jres.RESNET_RULES, batch_rank=1)
    tprog = tspmd.build_train_program(
        loss_fn=lambda p, b: tres.loss_fn(p, b, tcfg),
        init_params_fn=lambda g: params_from_numpy(tree, tcfg, "cpu"),
        optimizer=tspmd.default_optimizer(lr=1e-2, warmup=1, total_steps=50),
        device="cpu")
    js = jprog.init_fn(jax.random.key(0))
    ts = tprog.init_fn(torch.Generator())
    jb = jspmd.shard_batch(jprog, batch)
    tb = tspmd.shard_batch(tprog, batch)
    traj = []
    for _ in range(3):
        js, jm = jprog.step_fn(js, jb)
        ts, tm = tprog.step_fn(ts, tb)
        traj.append([(float(jm[k]), tm[k].item())
                     for k in ("loss", "grad_norm")])
    traj = np.array(traj)
    np.testing.assert_allclose(traj[:, 0, 1], traj[:, 0, 0], rtol=1e-4)
    np.testing.assert_allclose(traj[:, 1, 1], traj[:, 1, 0], rtol=1e-3)
    assert traj[-1, 0, 1] < traj[0, 0, 1]
    got = params_to_numpy(ts.params)
    assert isinstance(got["stage0"], list)
    for (path, r), g, p0 in zip(
            jax.tree_util.tree_leaves_with_path(js.params),
            jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        du_ref, du = np.asarray(r) - p0, g - p0
        assert np.linalg.norm(du - du_ref) <= \
            1e-3 * np.linalg.norm(du_ref) + 1e-9, jax.tree_util.keystr(path)


# ----------------------------------------------------------------- bf16
def test_bf16_forward_matches_jax(tree):
    """The reference's dtype, bf16 activations, both sides: every conv
    rounds its output to bf16 (8 significant bits) and GroupNorm rounds
    again, at the same points on both sides, but a float32 sum taken in
    another order (PyTorch's CPU conv picks its blocking by thread count)
    can land an activation one bf16 step (2^-8 relative) apart, and the
    next layers carry that step on.  Through tiny's stem, two blocks and
    the pool the logits stay within 2^-5 of their largest magnitude
    (measured 0.71 % on 2 threads; a shifted padding moves them by more
    than 10 %)."""
    jcfg = jres.tiny()
    tcfg = tres.tiny()
    imgs = _batch()["images"]
    ref = _jforward(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs), jcfg)
    got = tres.forward(params_from_numpy(tree, tcfg, "cpu"),
                       torch.from_numpy(imgs), tcfg)
    assert _rel_err(got.numpy(), ref) < 2 ** -5


def test_init_params_raises_without_card_unless_cpu(monkeypatch):
    """The entry point runs on cuda unless asked for the CPU, and raises
    without a card instead of dropping to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tres.init_params(torch.Generator(), tres.tiny())
    p = tres.init_params(torch.Generator(), tres.tiny(), device="cpu")
    assert all(t.device.type == "cpu" for t in tx.tree_leaves(p))
