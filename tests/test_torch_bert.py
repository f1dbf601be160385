"""ray_tpu_torch's BERT held against ray_tpu.models.bert on the CPU.

Weights come from the JAX init of ``tiny`` (E 64, 2 layers, 4 heads),
its zero ``cls`` head redrawn from a seed so that every gradient of the
classification loss is nonzero, and cross by ``params_from_numpy``;
tokens and masks are made with numpy from a seed, row 1 padded.  Both
sides run in float32 unless a test says otherwise.  At E 64 the
reference computes its LayerNorm inline; the port's side runs its
LayerNorm op's plain version through its autograd Function.

Tolerances, each with its reason (those of tests/test_torch_train.py):
float32 on both sides, with sums taken in other orders.  Outputs to 1e-5
of their largest magnitude; losses to 1e-5 relative; a gradient leaf to
1e-4 of its largest element; train-program trajectories to 1e-4 relative
on losses, 1e-3 on grad norms and each leaf's update to 1e-3 of its L2
norm (the key bias excepted, as for GPT-2: see ``_assert_updates``).
The bf16 forward: see ``test_bf16_classify_matches_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import bert as jbert
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.ops import layer_norm as tln
from ray_tpu_torch.parallel import spmd as tspmd
from ray_tpu_torch.parallel import transforms as tx

LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jbert.tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tbert.tiny(), dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tree():
    """The reference's tiny init as numpy, the zero cls head redrawn."""
    jcfg, _ = _cfgs()
    t = jax.tree.map(np.asarray, jax.jit(jbert.init_params, static_argnums=1)(
        jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    for k in ("kernel", "bias"):
        t["cls"][k] = (0.5 * rng.standard_normal(t["cls"][k].shape)) \
            .astype(np.float32)
    return t


def _batch(B=2, T=16, seed=0):
    """Tokens, a mask with row 1 padded after 9 tokens, labels, MLM
    targets and positions."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), np.int32)
    mask[1, 9:] = 0
    return {"tokens": rng.integers(0, 128, (B, T)).astype(np.int32),
            "attention_mask": mask,
            "labels": rng.integers(0, 2, B).astype(np.int32),
            "targets": rng.integers(0, 128, (B, T)).astype(np.int32),
            "loss_mask": (rng.random((B, T)) < 0.3).astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _assert_close_scaled(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * np.abs(ref).max())


def _assert_tree_close(got, ref, rel=1e-4):
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(got)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=rel * np.abs(r).max() + 1e-8,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("fn", ["encode", "pooled", "classify",
                                "mlm_logits"])
def test_forward_matches_jax(tree, fn):
    jcfg, tcfg = _cfgs()
    b = _batch()
    ref = jax.jit(getattr(jbert, fn), static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(b["tokens"]), jcfg,
        jnp.asarray(b["attention_mask"]))
    got = getattr(tbert, fn)(params_from_numpy(tree, tcfg, "cpu"),
                             torch.from_numpy(b["tokens"]), tcfg,
                             torch.from_numpy(b["attention_mask"]))
    assert tuple(got.shape) == ref.shape
    _assert_close_scaled(got.numpy(), ref)


def test_encode_takes_token_types_and_no_mask(tree):
    jcfg, tcfg = _cfgs()
    b = _batch(seed=3)
    types = (np.arange(16) >= 8).astype(np.int32)[None].repeat(2, 0)
    ref = jax.jit(jbert.encode, static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(b["tokens"]), jcfg,
        None, jnp.asarray(types))
    got = tbert.encode(params_from_numpy(tree, tcfg, "cpu"),
                       torch.from_numpy(b["tokens"]), tcfg, None,
                       torch.from_numpy(types))
    _assert_close_scaled(got.numpy(), ref)


@pytest.mark.parametrize("loss", ["classification_loss", "mlm_loss"])
def test_loss_and_grads_match_jax(tree, loss):
    jcfg, tcfg = _cfgs()
    b = _batch(seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(getattr(jbert, loss)),
                            static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), _j(b), jcfg)
    tp = params_from_numpy(tree, tcfg, "cpu")
    leaves = tx.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss = getattr(tbert, loss)(tp, _t(b), tcfg)
    it = iter(torch.autograd.grad(tloss, leaves, allow_unused=True,
                                  materialize_grads=True))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close(params_to_numpy(tx.tree_map(lambda _: next(it), tp)),
                       jax.tree.map(np.asarray, jgrads))


def test_padding_mask_invariance(tree):
    """A padded row's outputs are those of the same row alone, unpadded
    (padded keys get float32.min, hence softmax weight exactly 0); with
    the mask ignored they are not."""
    _, tcfg = _cfgs()
    tp = params_from_numpy(tree, tcfg, "cpu")
    b = _batch(seed=4)
    toks, mask = torch.from_numpy(b["tokens"]), torch.from_numpy(
        b["attention_mask"])
    pooled = tbert.pooled(tp, toks, tcfg, mask)
    logits = tbert.classify(tp, toks, tcfg, mask)
    alone = tbert.pooled(tp, toks[1:, :9], tcfg)
    _assert_close_scaled(pooled[1:].numpy(), alone.numpy())
    _assert_close_scaled(logits[1:].numpy(),
                         tbert.classify(tp, toks[1:, :9], tcfg).numpy())
    unmasked = tbert.pooled(tp, toks, tcfg)
    assert _rel_err(unmasked[1:].numpy(), alone.numpy()) > 1e-3


def test_layer_norm_goes_through_the_op_at_eps_1e_12(tree, monkeypatch):
    """Every LayerNorm of ``classify`` is ``ops.layer_norm.layer_norm`` at
    eps 1e-12: 1 + 2 x n_layer calls (chip_smoke.py counts the kernel's
    launches on the card: 25 at BERT-base)."""
    _, tcfg = _cfgs()
    calls = []

    def spy(x, scale, bias, eps=1e-5):
        calls.append((tuple(x.shape), eps))
        return tln.layer_norm(x, scale, bias, eps)

    monkeypatch.setattr(tbert, "layer_norm", spy)
    b = _batch()
    with torch.no_grad():
        tbert.classify(params_from_numpy(tree, tcfg, "cpu"),
                       torch.from_numpy(b["tokens"]), tcfg,
                       torch.from_numpy(b["attention_mask"]))
    assert calls == [((2, 16, 64), 1e-12)] * (1 + 2 * tcfg.n_layer)


def test_init_params_matches_jax_shapes():
    """bert-base's tree (on meta) against jax.eval_shape of the
    reference's init: the same keys, shapes and count (110 M)."""
    ref = jax.eval_shape(lambda: jbert.init_params(jax.random.key(0),
                                                   jbert.bert_base()))
    got = tbert.init_params(None, tbert.bert_base(), device="meta")
    assert tx.tree_map(lambda t: tuple(t.shape), got) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    n = tbert.param_count(got)
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert 109e6 < n < 111e6


def test_init_params_draws_the_reference_scales():
    _, tcfg = _cfgs()
    p = tbert.init_params(torch.Generator().manual_seed(0),
                          dataclasses.replace(tcfg, n_embd=256), device="cpu")
    assert abs(p["wte"].std().item() - 0.02) < 0.001
    assert not p["cls"]["kernel"].any() and p["ln_emb"]["scale"].eq(1).all()


def test_remat_on_matches_remat_off(tree):
    _, off = _cfgs()
    on = dataclasses.replace(off, remat=True)
    b = _t(_batch(seed=5))
    grads = []
    for cfg in (off, on):
        tp = params_from_numpy(tree, cfg, "cpu")
        leaves = tx.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        grads.append(torch.autograd.grad(
            tbert.classification_loss(tp, b, cfg), leaves, allow_unused=True,
            materialize_grads=True))
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- train program
def _assert_updates(ts, js, tree, steps):
    """Each leaf's update held to 1e-3 of its L2 norm.  The key bias
    (``attn_qkv/bias[:, 1]``) has an exactly zero gradient in exact
    arithmetic (shifting every score of a query row leaves its softmax
    unchanged), so Adam turns float32 noise into steps of up to lr: it is
    held within lr a step of its start (tests/test_torch_train.py)."""
    got = params_to_numpy(ts.params)
    ref = jax.tree.map(np.array, js.params)
    k0 = tree["blocks"]["attn_qkv"]["bias"][:, 1]
    for t in (got, ref):
        kb = t["blocks"]["attn_qkv"]["bias"]
        assert np.abs(kb[:, 1] - k0).max() <= LR * steps * 1.001
        kb[:, 1] = k0
    for (path, r), g, p0 in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(tree)):
        du_ref, du = r - p0, g - p0
        assert np.linalg.norm(du - du_ref) <= \
            1e-3 * np.linalg.norm(du_ref) + 1e-9, jax.tree_util.keystr(path)


def test_train_program_trajectory_matches_jax(tree):
    """Three steps of build_train_program on the MLM loss, both sides."""
    jcfg, tcfg = _cfgs()
    b = _batch(B=4, seed=6)
    del b["labels"]                    # the MLM loss's batch is (B, T)
    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, x: jbert.mlm_loss(p, x, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=LR, warmup=1, total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc)
    tprog = tspmd.build_train_program(
        loss_fn=lambda p, x: tbert.mlm_loss(p, x, tcfg),
        init_params_fn=lambda g: params_from_numpy(tree, tcfg, "cpu"),
        optimizer=tspmd.default_optimizer(lr=LR, warmup=1, total_steps=50),
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
    _assert_updates(ts, js, tree, 3)


# ----------------------------------------------------------------- bf16
def test_bf16_classify_matches_jax(tree):
    """The reference's dtype, bf16 activations, both sides.  Each product
    rounds to bf16 (8 significant bits) at the same points, but a float32
    sum in another order, or the reference's tanh GELU computed op by op
    in bf16 where PyTorch's computes it in float32 and rounds once, can
    land a value one bf16 step (2^-8 relative) apart; LayerNorm after
    every sublayer keeps such steps from growing.  Through two layers, the
    pooler and the head the pooled output and the logits stay within
    2^-5 of their largest magnitude (measured 0.40 % and 0.46 %)."""
    jcfg, tcfg = jbert.tiny(), tbert.tiny()
    b = _batch()
    args = (jnp.asarray(b["tokens"]), jcfg, jnp.asarray(b["attention_mask"]))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, tcfg, "cpu")
    targs = (torch.from_numpy(b["tokens"]), tcfg,
             torch.from_numpy(b["attention_mask"]))
    pooled = tbert.pooled(tp, *targs)
    assert pooled.dtype == torch.bfloat16
    jpooled = jax.jit(jbert.pooled, static_argnums=2)(jp, *args)
    assert _rel_err(pooled.float().numpy(), jpooled.astype(jnp.float32)) \
        < 2 ** -5
    jlogits = jax.jit(jbert.classify, static_argnums=2)(jp, *args)
    assert _rel_err(tbert.classify(tp, *targs).numpy(), jlogits) < 2 ** -5


def test_init_params_raises_without_card_unless_cpu(monkeypatch):
    """The entry point runs on cuda unless asked for the CPU, and raises
    without a card instead of dropping to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.init_params(torch.Generator(), tbert.tiny())
    p = tbert.init_params(torch.Generator(), tbert.tiny(), device="cpu")
    assert all(t.device.type == "cpu" for t in tx.tree_leaves(p))
