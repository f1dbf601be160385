"""ray_tpu_torch's ViT held against ray_tpu.models.vit on the CPU.

Weights come from the JAX init of ``tiny`` (32×32 images, 8×8 patches,
E 64, 2 layers), its zero head redrawn from a seed so that every
gradient is nonzero, and cross by ``params_from_numpy``; images are made
with numpy from a seed.  Both sides run in float32 unless a test says
otherwise; the reference computes its LayerNorm inline, the port's side
runs its LayerNorm op's plain version through its autograd Function.

Tolerances, each with its reason (those of tests/test_torch_train.py):
float32 on both sides, with sums taken in other orders.  Logits to 1e-5
of their largest magnitude; the loss to 1e-5 relative; a gradient leaf
to 1e-4 of its largest element; train-program trajectories to 1e-4
relative on losses, 1e-3 on grad norms and each leaf's update to 1e-3 of
its L2 norm (the key bias excepted: see the trajectory test).  The bf16
forward: see ``test_bf16_forward_matches_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd
from ray_tpu_torch.models import vit as tvit
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
    jcfg = dataclasses.replace(jvit.tiny(), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tvit.tiny(), dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tree():
    """The reference's tiny init as numpy, the zero head redrawn."""
    jcfg, _ = _cfgs()
    t = jax.tree.map(np.asarray, jax.jit(jvit.init_params, static_argnums=1)(
        jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    for k in ("kernel", "bias"):
        t["head"][k] = (0.5 * rng.standard_normal(t["head"][k].shape)) \
            .astype(np.float32)
    return t


_jforward = jax.jit(jvit.forward, static_argnums=2)


def _batch(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, B).astype(np.int32)}


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _assert_close_scaled(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * np.abs(ref).max())


# ------------------------------------------------------------- forward
def test_patchify_order_matches_jax():
    """Patches in (gh, gw) order, each flattened (p, p, C): the order the
    patch-embedding matrix's rows take."""
    x = np.arange(2 * 32 * 16 * 3, dtype=np.float32).reshape(2, 32, 16, 3)
    ref = np.asarray(jvit.patchify(jnp.asarray(x), 8))
    got = tvit.patchify(torch.from_numpy(x), 8).numpy()
    assert got.shape == (2, 8, 192)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, 1, :3], x[0, 0, 8])  # patch (0, 1)


def test_forward_matches_jax(tree):
    jcfg, tcfg = _cfgs()
    imgs = _batch()["images"]
    ref = _jforward(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs), jcfg)
    got = tvit.forward(params_from_numpy(tree, tcfg, "cpu"),
                       torch.from_numpy(imgs), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10)
    _assert_close_scaled(got.numpy(), ref)


def test_loss_and_grads_match_jax(tree):
    jcfg, tcfg = _cfgs()
    b = _batch(seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jvit.loss_fn),
                            static_argnums=2)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in b.items()}, jcfg)
    tp = params_from_numpy(tree, tcfg, "cpu")
    leaves = tx.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss = tvit.loss_fn(tp, {k: torch.from_numpy(v) for k, v in b.items()},
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


def test_layer_norm_goes_through_the_op(tree, monkeypatch):
    """Every LayerNorm is ``ops.layer_norm.layer_norm`` at eps 1e-6,
    2 x n_layer + 1 calls, the last on the CLS rows x[:, 0]: a (B, E)
    view whose rows lie T·E elements apart, which the kernel reads in
    place on the card (chip_smoke.py counts 25 forwards and 25 backwards
    a ViT-B/16 step, all on the vector route)."""
    _, tcfg = _cfgs()
    calls = []

    def spy(x, scale, bias, eps=1e-5):
        calls.append((tuple(x.shape), tuple(x.stride()), eps))
        return tln.layer_norm(x, scale, bias, eps)

    monkeypatch.setattr(tvit, "layer_norm", spy)
    tvit.forward(params_from_numpy(tree, tcfg, "cpu"),
                 torch.from_numpy(_batch()["images"]), tcfg)
    T, E = tcfg.num_patches + 1, tcfg.n_embd
    assert calls[:-1] == [((2, T, E), (T * E, E, 1), 1e-6)] * 2 \
        * tcfg.n_layer
    assert calls[-1] == ((2, E), (T * E, 1), 1e-6)


def test_init_params_and_param_count_match_jax():
    """vit-b16's tree (on meta) against jax.eval_shape of the reference's
    init, and param_count_analytic against the reference's and the
    tree's count (86 M)."""
    ref = jax.eval_shape(lambda: jvit.init_params(jax.random.key(0),
                                                  jvit.vit_b16()))
    got = tvit.init_params(None, tvit.vit_b16(), device="meta")
    assert tx.tree_map(lambda t: tuple(t.shape), got) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    n = sum(t.numel() for t in tx.tree_leaves(got))
    assert tvit.param_count_analytic(tvit.vit_b16()) == \
        jvit.param_count_analytic(jvit.vit_b16()) == n
    assert 86e6 < n < 87e6
    assert tvit.param_count_analytic(tvit.vit_l16()) == \
        jvit.param_count_analytic(jvit.vit_l16())


def test_init_params_draws_the_reference_scales():
    _, tcfg = _cfgs()
    p = tvit.init_params(torch.Generator().manual_seed(0),
                         dataclasses.replace(tcfg, n_embd=256), device="cpu")
    out = p["blocks"]["mlp_out"]["kernel"]
    assert abs(out.std().item() - 0.02 / np.sqrt(4)) < 0.001
    assert not p["head"]["kernel"].any() and not p["cls_token"].any()


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
        grads.append(torch.autograd.grad(tvit.loss_fn(tp, b, cfg), leaves))
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- train program
def test_train_program_trajectory_matches_jax(tree):
    """Three steps of build_train_program on one batch, both sides.  The
    key bias (``attn_qkv/bias[:, 1]``) has an exactly zero gradient in
    exact arithmetic, so Adam turns float32 noise into steps of up to lr:
    it is held within lr a step of its start (tests/test_torch_train.py);
    every other leaf's update to 1e-3 of its L2 norm."""
    jcfg, tcfg = _cfgs()
    b = _batch(B=4, seed=6)
    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, x: jvit.loss_fn(p, x, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=LR, warmup=1, total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc,
        batch_rank=1)
    tprog = tspmd.build_train_program(
        loss_fn=lambda p, x: tvit.loss_fn(p, x, tcfg),
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
    got = params_to_numpy(ts.params)
    ref = jax.tree.map(np.array, js.params)
    k0 = tree["blocks"]["attn_qkv"]["bias"][:, 1]
    for t in (got, ref):
        kb = t["blocks"]["attn_qkv"]["bias"]
        assert np.abs(kb[:, 1] - k0).max() <= LR * 3 * 1.001
        kb[:, 1] = k0
    for (path, r), g, p0 in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(tree)):
        du_ref, du = r - p0, g - p0
        assert np.linalg.norm(du - du_ref) <= \
            1e-3 * np.linalg.norm(du_ref) + 1e-9, jax.tree_util.keystr(path)


# ----------------------------------------------------------------- bf16
def test_bf16_forward_matches_jax(tree):
    """The reference's dtype, bf16 activations, both sides.  Each product
    and LayerNorm rounds to bf16 (8 significant bits) at the same points,
    but a float32 sum in another order, or the reference's tanh GELU
    computed op by op in bf16 where PyTorch's rounds once, can land a
    value one bf16 step (2^-8 relative) apart, and the residual stream
    carries it on.  Through two layers, ln_f and the head the logits stay
    within 2^-5 of their largest magnitude (measured 0.80 %)."""
    jcfg, tcfg = jvit.tiny(), tvit.tiny()
    imgs = _batch()["images"]
    ref = _jforward(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs), jcfg)
    got = tvit.forward(params_from_numpy(tree, tcfg, "cpu"),
                       torch.from_numpy(imgs), tcfg)
    assert _rel_err(got.numpy(), ref) < 2 ** -5


def test_init_params_raises_without_card_unless_cpu(monkeypatch):
    """The entry point runs on cuda unless asked for the CPU, and raises
    without a card instead of dropping to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.init_params(torch.Generator(), tvit.tiny())
    p = tvit.init_params(torch.Generator(), tvit.tiny(), device="cpu")
    assert all(t.device.type == "cpu" for t in tx.tree_leaves(p))
