"""ray_tpu_torch's T5 held against ray_tpu.models.t5 on the CPU.

Weights come from the JAX init of ``tiny`` (E 64, 2 layers a stack, 4
heads of 16, 8 buckets over 32 positions) and cross by
``params_from_numpy``; ids are made with numpy from a seed.  Both sides
run in float32 unless a test says otherwise.

Tolerances, each with its reason (those of tests/test_torch_train.py):
float32 on both sides, with sums taken in other orders.  Outputs to 1e-5
of their largest magnitude; the loss to 1e-5 relative; a gradient leaf
to 1e-4 of its largest element; train-program trajectories to 1e-4
relative on losses, 1e-3 on grad norms and each leaf's update to 1e-3 of
its L2 norm.  Bucket tables are integers: equal.  The bf16 forward: see
``test_bf16_forward_matches_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import t5 as jt5
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd
from ray_tpu_torch.models import t5 as tt5
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
    jcfg = dataclasses.replace(jt5.tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tt5.tiny(), dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jax.jit(jt5.init_params,
                                            static_argnums=1)(
        jax.random.key(0), jcfg))


def _batch(B=2, S=12, T=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, 256, (B, S)).astype(np.int32),
            "decoder_inputs": rng.integers(0, 256, (B, T)).astype(np.int32),
            "targets": rng.integers(0, 256, (B, T)).astype(np.int32)}


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _assert_close_scaled(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * np.abs(ref).max())


# ------------------------------------------------------------- buckets
@pytest.mark.parametrize("buckets,max_dist", [(32, 128), (8, 32)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_buckets_equal_jax(buckets, max_dist, bidirectional):
    """Every relative position in [-4096, 4096], t5-base's (32, 128) and
    tiny's (8, 32), both directions: the float32 log truncated to int32
    lands in the same bucket on both sides."""
    rel = np.arange(-4096, 4097, dtype=np.int32)
    ref = np.asarray(jt5._relative_buckets(jnp.asarray(rel), buckets,
                                           max_dist, bidirectional))
    got = tt5._relative_buckets(torch.from_numpy(rel), buckets, max_dist,
                                bidirectional)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.min() == 0 and ref.max() == buckets - 1    # the full range


@pytest.mark.parametrize("bidirectional", [True, False])
def test_rel_bias_matches_jax(tree, bidirectional):
    jcfg, tcfg = _cfgs()
    table = np.array(tree["enc_rel_bias"])
    ref = jt5._rel_bias(jnp.asarray(table), 9, 7, jcfg, bidirectional)
    got = tt5._rel_bias(torch.from_numpy(table), 9, 7, tcfg, bidirectional)
    assert tuple(got.shape) == (1, tcfg.n_head, 9, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------- forward
def test_encode_and_forward_match_jax(tree):
    jcfg, tcfg = _cfgs()
    b = _batch()
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, "cpu")
    ref = jax.jit(jt5.encode, static_argnums=2)(jp, jnp.asarray(b["inputs"]),
                                                jcfg)
    got = tt5.encode(tp, torch.from_numpy(b["inputs"]), tcfg)
    _assert_close_scaled(got.numpy(), ref)
    ref = jax.jit(jt5.forward, static_argnums=3)(
        jp, jnp.asarray(b["inputs"]), jnp.asarray(b["decoder_inputs"]), jcfg)
    got = tt5.forward(tp, torch.from_numpy(b["inputs"]),
                      torch.from_numpy(b["decoder_inputs"]), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8, 256)
    _assert_close_scaled(got.numpy(), ref)


def test_decoder_is_causal(tree):
    """A decoder position's logits do not move when later decoder ids
    change, and equal the reference's for the changed ids too."""
    jcfg, tcfg = _cfgs()
    b = _batch(seed=2)
    tp = params_from_numpy(tree, tcfg, "cpu")
    dec = b["decoder_inputs"].copy()
    dec2 = dec.copy()
    dec2[:, 5:] = (dec2[:, 5:] + 1) % 256
    a = tt5.forward(tp, torch.from_numpy(b["inputs"]), torch.from_numpy(dec),
                    tcfg)
    c = tt5.forward(tp, torch.from_numpy(b["inputs"]),
                    torch.from_numpy(dec2), tcfg)
    np.testing.assert_array_equal(a[:, :5].numpy(), c[:, :5].numpy())
    assert not torch.equal(a[:, 5:], c[:, 5:])
    ref = jax.jit(jt5.forward, static_argnums=3)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(b["inputs"]),
        jnp.asarray(dec2), jcfg)
    _assert_close_scaled(c.numpy(), ref)


def test_loss_and_grads_match_jax(tree):
    jcfg, tcfg = _cfgs()
    b = _batch(seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jt5.loss_fn),
                            static_argnums=2)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    tp = params_from_numpy(tree, tcfg, "cpu")
    leaves = tx.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss = tt5.loss_fn(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                        tcfg)
    it = iter(torch.autograd.grad(tloss, leaves))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    got = params_to_numpy(tx.tree_map(lambda _: next(it), tp))
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                            jax.tree_util.tree_leaves(got)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-8,
                                   err_msg=jax.tree_util.keystr(path))


def test_init_params_and_param_count_match_jax():
    """t5-base's tree (on meta) against jax.eval_shape of the reference's
    init, and param_count_analytic against the reference's and the
    tree's count (248 M)."""
    ref = jax.eval_shape(lambda: jt5.init_params(jax.random.key(0),
                                                 jt5.t5_base()))
    got = tt5.init_params(None, tt5.t5_base(), device="meta")
    assert tx.tree_map(lambda t: tuple(t.shape), got) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    n = sum(t.numel() for t in tx.tree_leaves(got))
    assert tt5.param_count_analytic(tt5.t5_base()) == \
        jt5.param_count_analytic(jt5.t5_base()) == n
    assert 247e6 < n < 249e6
    assert tt5.param_count_analytic(tt5.t5_large()) == \
        jt5.param_count_analytic(jt5.t5_large())


def test_init_params_draws_the_reference_scales():
    _, tcfg = _cfgs()
    p = tt5.init_params(torch.Generator().manual_seed(0),
                        dataclasses.replace(tcfg, n_embd=256), device="cpu")
    assert abs(p["shared_embed"].std().item() - 1.0) < 0.02
    q = p["encoder"]["attn_q"]
    assert abs(q.std().item() - (256 * 16) ** -0.5) < 0.001
    assert p["enc_ln_f"]["scale"].eq(1).all()


def test_remat_on_matches_remat_off(tree):
    _, off = _cfgs()
    on = dataclasses.replace(off, remat=True)
    b = {k: torch.from_numpy(v) for k, v in _batch(seed=5).items()}
    grads = []
    for cfg in (off, on):
        tp = params_from_numpy(tree, cfg, "cpu")
        leaves = tx.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        grads.append(torch.autograd.grad(tt5.loss_fn(tp, b, cfg), leaves))
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- train program
def test_train_program_trajectory_matches_jax(tree):
    """Three steps of build_train_program on one batch, both sides."""
    jcfg, tcfg = _cfgs()
    b = _batch(B=4, seed=6)
    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, x: jt5.loss_fn(p, x, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=1e-2, warmup=1, total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc)
    tprog = tspmd.build_train_program(
        loss_fn=lambda p, x: tt5.loss_fn(p, x, tcfg),
        init_params_fn=lambda g: params_from_numpy(tree, tcfg, "cpu"),
        optimizer=tspmd.default_optimizer(lr=1e-2, warmup=1, total_steps=50),
        device="cpu")
    js = jprog.init_fn(jax.random.key(0))
    ts = tprog.init_fn(torch.Generator())
    jb, tb = jspmd.shard_batch(jprog, b), tspmd.shard_batch(tprog, b)
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
    for (path, r), g, p0 in zip(
            jax.tree_util.tree_leaves_with_path(js.params),
            jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        du_ref, du = np.asarray(r) - p0, g - p0
        assert np.linalg.norm(du - du_ref) <= \
            1e-3 * np.linalg.norm(du_ref) + 1e-9, jax.tree_util.keystr(path)


# ----------------------------------------------------------------- bf16
def test_bf16_forward_matches_jax(tree):
    """The reference's dtype, bf16 activations, both sides.  Products and
    RMSNorm round to bf16 (8 significant bits) at the same points, but a
    float32 sum in another order, or the reference's tanh GELU computed
    op by op in bf16 where PyTorch's rounds once, can land a value one
    bf16 step (2^-8 relative) apart, and the residual streams carry it
    through two stacks into the LM head.  The logits stay within 2^-5 of
    their largest magnitude (measured 0.91 %)."""
    jcfg, tcfg = jt5.tiny(), tt5.tiny()
    b = _batch()
    ref = jax.jit(jt5.forward, static_argnums=3)(
        jax.tree.map(jnp.asarray, tree),
        jnp.asarray(b["inputs"]), jnp.asarray(b["decoder_inputs"]), jcfg)
    got = tt5.forward(params_from_numpy(tree, tcfg, "cpu"),
                      torch.from_numpy(b["inputs"]),
                      torch.from_numpy(b["decoder_inputs"]), tcfg)
    assert _rel_err(got.numpy(), ref) < 2 ** -5


def test_init_params_raises_without_card_unless_cpu(monkeypatch):
    """The entry point runs on cuda unless asked for the CPU, and raises
    without a card instead of dropping to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt5.init_params(torch.Generator(), tt5.tiny())
    p = tt5.init_params(torch.Generator(), tt5.tiny(), device="cpu")
    assert all(t.device.type == "cpu" for t in tx.tree_leaves(p))
