"""ray_tpu_torch Llama training (loss, gradients, remat, the train
program) held against ray_tpu.models.llama on the CPU.

Weights come from the JAX init and cross by ``params_from_numpy``; batches
are made with numpy from a seed; both sides run in float32.  Two configs:
``llama.tiny()`` (head dim 16, 4 query heads over 2 KV heads) with dense
attention, and the same widened to E = 256 with 2 query heads over 1 KV
head, Llama-3 8B's head dim 128, with ``attn_impl="flash"``: the JAX side
runs both Pallas kernels, forward and backward, in interpret mode on K/V
expanded by ``_gqa_expand``, and the port's side the plain versions of
its flash kernels through the ``flash_fwd`` op, which take the KV heads
as they are and sum dk and dv over each group.

Tolerances, each with its reason (the limits of tests/test_torch_train.py
for GPT-2): float32 on both sides, with sums taken in other orders.  Loss
values agree to 1e-5 relative; a gradient leaf is held to 1e-4 of its
largest element (the gradients sum over every token of the batch,
through a softmax).  Trajectories compound those roundings through Adam:
1e-4 relative on losses, 1e-3 on grad norms, and each leaf's update to
1e-3 of its L2 norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.parallel import spmd as tspmd
from ray_tpu_torch.parallel import transforms as tx


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# name -> (config changes, attn_impl, batch, sequence length)
CONFIGS = {
    "tiny_dense": ({}, "dense", 2, 17),
    "d128_flash": (dict(n_embd=256, n_head=2, n_kv_head=1), "flash", 2, 64),
}


def _cfgs(name, **kw):
    changes, attn, _, _ = CONFIGS[name]
    jcfg = dataclasses.replace(jllama.tiny(), dtype=jnp.float32,
                               attn_impl=attn, **changes, **kw)
    tcfg = dataclasses.replace(tllama.tiny(), dtype=torch.float32,
                               attn_impl=attn, **changes, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def init_trees():
    """The JAX init of each config, as numpy."""
    return {name: jax.tree.map(np.asarray, jllama.init_params(
        jax.random.key(0), _cfgs(name)[0])) for name in CONFIGS}


def _batch(name, V, form, seed=0):
    _, _, B, T = CONFIGS[name]
    toks = np.random.default_rng(seed).integers(0, V, (B, T + 1)).astype(
        np.int32)
    if form == "tokens":
        return {"tokens": toks}
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _port_grads(tree, batch, cfg):
    tp = params_from_numpy(tree, cfg, "cpu")
    leaves = tx.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tllama.loss_fn(tp, tb, cfg)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("form", ["tokens", "inputs_targets"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(init_trees, name, form):
    """loss_fn and the gradient of every leaf, both batch forms."""
    jcfg, tcfg = _cfgs(name)
    assert tcfg.head_dim == jcfg.head_dim
    tree = init_trees[name]
    batch = _batch(name, jcfg.vocab_size, form)
    ref_loss, ref = jax.value_and_grad(
        lambda p: jllama.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                     batch.items()}, jcfg))(
        jax.tree.map(jnp.asarray, tree))
    loss, got = _port_grads(tree, batch, tcfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref), got):
        r = np.asarray(r)
        assert g.shape == r.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-8,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_remat_on_matches_remat_off(init_trees, name):
    """Checkpointed blocks replay the same forward: the same gradients
    (the flash config replays the flash forward under checkpoint)."""
    _, on = _cfgs(name)
    assert on.remat is True
    off = dataclasses.replace(on, remat=False)
    batch = _batch(name, on.vocab_size, "tokens", seed=1)
    (_, a), (_, b) = (_port_grads(init_trees[name], batch, c)
                      for c in (on, off))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


def test_config_takes_the_reference_fields():
    """remat and context_axis are the reference's fields, with its
    defaults; ulysses without a mesh is dense attention (over a mesh:
    tests/test_torch_context_parallel.py)."""
    for field in ("remat", "context_axis"):
        assert getattr(tllama.LlamaConfig(), field) == \
            getattr(jllama.LlamaConfig(), field)
    assert tllama.LlamaConfig(remat=False).remat is False
    assert tllama.LlamaConfig(context_axis=None).context_axis is None
    cfg = dataclasses.replace(tllama.tiny(), attn_impl="ulysses",
                              context_axis="context")
    tp = tllama.init_params(torch.Generator(), cfg, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    torch.testing.assert_close(
        tllama.forward(tp, toks, cfg),
        tllama.forward(tp, toks, dataclasses.replace(cfg, attn_impl="dense")))


def test_rules_are_the_reference_partition_specs():
    """LLAMA_RULES: the reference's (regex, PartitionSpec) table as
    (regex, axis tuple), in order."""
    ref = [(pat, tuple(spec)) for pat, spec in jllama.LLAMA_RULES]
    assert tllama.LLAMA_RULES == ref


# ------------------------------------------------------- train program
def _programs(name, tree, steps=10):
    """The reference's and the port's train programs from the same init
    and batch, as tests/test_torch_train.py builds them for GPT-2."""
    jcfg, tcfg = _cfgs(name)
    toks = _batch(name, jcfg.vocab_size, "tokens", seed=2)["tokens"]
    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, b: jllama.loss_fn(p, b, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=1e-2, warmup=1,
                                          total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc)
    tprog = tspmd.build_train_program(
        loss_fn=lambda p, b: tllama.loss_fn(p, b, tcfg),
        init_params_fn=lambda g: params_from_numpy(tree, tcfg, "cpu"),
        optimizer=tspmd.default_optimizer(lr=1e-2, warmup=1,
                                          total_steps=50),
        device="cpu")
    js = jprog.init_fn(jax.random.key(0))
    ts = tprog.init_fn(torch.Generator())
    jb = jspmd.shard_batch(jprog, {"tokens": toks})
    tb = tspmd.shard_batch(tprog, {"tokens": toks})
    out = []
    for _ in range(steps):
        js, jm = jprog.step_fn(js, jb)
        ts, tm = tprog.step_fn(ts, tb)
        out.append([(float(jm[k]), tm[k].item())
                    for k in ("loss", "grad_norm", "step")])
    return np.array(out), js, ts


def test_train_program_trajectory_matches_jax(init_trees):
    """10 steps of build_train_program on one batch: losses, grad norms,
    steps, and each leaf's update."""
    tree = init_trees["tiny_dense"]
    traj, js, ts = _programs("tiny_dense", tree)
    np.testing.assert_allclose(traj[:, 0, 1], traj[:, 0, 0], rtol=1e-4)
    np.testing.assert_allclose(traj[:, 1, 1], traj[:, 1, 0], rtol=1e-3)
    np.testing.assert_array_equal(traj[:, 2, 1], traj[:, 2, 0])
    assert traj[-1, 0, 1] < traj[0, 0, 1]
    got = params_to_numpy(ts.params)
    for (path, r), g, p0 in zip(
            jax.tree_util.tree_leaves_with_path(js.params),
            jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        du_ref, du = np.asarray(r) - p0, g - p0
        assert np.linalg.norm(du - du_ref) <= \
            1e-3 * np.linalg.norm(du_ref) + 1e-9, jax.tree_util.keystr(path)
