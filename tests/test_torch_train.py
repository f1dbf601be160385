"""ray_tpu_torch training (GPT-2 loss, optimizer, train program) held
against the JAX reference on the CPU.

Weights come from the JAX init and cross by ``params_from_numpy``; batches
and data are made with numpy from a seed; both sides run in float32.  With
``n_embd=128`` and ``attn_impl="flash"`` the JAX side runs both Pallas
kernels, forward and backward, in interpret mode, and the port's side
their plain versions through its ``autograd.Function``s.

Tolerances, each with its reason: float32 on both sides, with sums taken
in other orders.  Loss values agree to 1e-5 relative.  A gradient leaf is
held to 1e-4 of its largest element (the gradients sum over every token
of the batch, through a softmax).  Optimizer trajectories compound those
roundings through Adam's division by sqrt(nu) for 10-60 steps: 1e-4
relative on losses and 1e-5 absolute on the quadratic's O(1) params
(the train program's params: see ``_assert_params_close``); the grad
norm gets 1e-3, because at lr 1e-2 Adam's first steps make it spike
several-fold on the 2-layer model, and a spike's height follows the
float32 rounding of the step before; bf16 moments round the same float32
values, and a value at a rounding boundary can land one bf16 step apart,
so the compact optimizer gets 1e-3.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import optim as joptim
from ray_tpu.parallel import spmd as jspmd
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.parallel import optim as toptim
from ray_tpu_torch.parallel import spmd as tspmd
from ray_tpu_torch.parallel import transforms as tx


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jgpt2.tiny(), n_embd=128, dtype=jnp.float32,
                               attn_impl="flash", **kw)
    tcfg = dataclasses.replace(tgpt2.tiny(), n_embd=128, dtype=torch.float32,
                               attn_impl="flash", **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def init_tree():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(0),
                                                      jcfg))


def _tokens(B, T, V, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(
        np.int32)


def _assert_tree_close(got, ref, rel=1e-4):
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(got)):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=rel * np.abs(r).max() + 1e-8,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_params_close(ts, js, steps: int, init_tree):
    """Each leaf's update (params minus init) after ``steps`` train-program
    steps, held to 1e-3 of its L2 norm: Adam normalizes every element's
    update, so the few elements whose gradient sits near float32 noise take
    partly noise-driven steps, which an element-wise limit would not
    survive and an L2 limit does.  The key bias (attn_qkv.bias[:, 1]) has
    an exactly zero gradient in exact arithmetic (shifting every score of
    a query row leaves its softmax unchanged), so Adam turns noise into
    steps of up to lr on either side: it is only held within lr per step
    of its start."""
    got = params_to_numpy(ts.params)
    ref = jax.tree.map(np.array, js.params)        # writable copies
    k0 = init_tree["blocks"]["attn_qkv"]["bias"][:, 1]
    for tree in (got, ref):
        kb = tree["blocks"]["attn_qkv"]["bias"]
        assert np.abs(kb[:, 1] - k0).max() <= 1e-2 * steps * 1.001
        kb[:, 1] = k0
    for (path, r), g, p0 in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(init_tree)):
        du_ref, du = r - p0, g - p0
        assert np.linalg.norm(du - du_ref) <= \
            1e-3 * np.linalg.norm(du_ref) + 1e-9, jax.tree_util.keystr(path)


# ------------------------------------------------------------- loss_fn
@pytest.mark.parametrize("variant", [{}, {"loss_chunks": 4},
                                     {"loss_vocab_chunks": 3}],
                         ids=["full", "seq_chunks", "vocab_chunks"])
def test_loss_and_grads_match_jax(init_tree, variant):
    jcfg, tcfg = _cfgs(**variant)
    toks = _tokens(2, 33, jcfg.vocab_size)
    jp = jax.tree.map(jnp.asarray, init_tree)
    jloss, jgrads = jax.value_and_grad(jgpt2.loss_fn)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tp = params_from_numpy(init_tree, tcfg, "cpu")
    leaves = tx.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss = tgpt2.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()},
                          tcfg)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    it = iter(tgrads)
    _assert_tree_close(params_to_numpy(tx.tree_map(lambda _: next(it), tp)),
                       jax.tree.map(np.asarray, jgrads))


def test_remat_on_matches_remat_off(init_tree):
    """Checkpointed blocks replay the same forward: the same gradients."""
    _, on = _cfgs()
    off = dataclasses.replace(on, remat=False)
    toks = torch.from_numpy(_tokens(2, 17, on.vocab_size, seed=1)).long()
    grads = []
    for cfg in (on, off):
        tp = params_from_numpy(init_tree, cfg, "cpu")
        leaves = tx.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        grads.append(torch.autograd.grad(
            tgpt2.loss_fn(tp, {"tokens": toks}, cfg), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy,err", [
    pytest.param("dots", None, id="dots"),
    pytest.param("attn", None, id="attn"),
    pytest.param("attn_qkv", None, id="attn_qkv"),
    ("bogus", ValueError),
    pytest.param("attn_dense", ValueError, id="attn_dense-ValueError"),
    pytest.param("attn_auto", ValueError, id="attn_auto_on_cpu-ValueError"),
])
def test_non_full_remat_policies_raise(init_tree, policy, err):
    """The selective policies: the loss and every gradient against the
    reference's under the same policy (its jax.checkpoint policies, both
    Pallas kernels in interpret mode), to test_loss_and_grads_match_jax's
    limits.  No policy may quietly act as full remat: an unknown one
    raises, and so does ``attn`` where attention is not flash (the
    reference's ValueError): dense, or ``auto``, which is dense on the
    CPU."""
    if err is not None:
        impl = {"attn_dense": "dense", "attn_auto": "auto"}.get(policy)
        kw = dict(remat_policy="attn", attn_impl=impl) if impl \
            else dict(remat_policy=policy)
        _, cfg = _cfgs()
        cfg = dataclasses.replace(cfg, **kw)
        tp = params_from_numpy(init_tree, cfg, "cpu")
        with pytest.raises(err):
            tgpt2.loss_fn(tp, {"tokens": torch.zeros((1, 9),
                                                     dtype=torch.long)}, cfg)
        return
    jcfg, tcfg = _cfgs(remat_policy=policy)
    toks = _tokens(2, 33, jcfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(jgpt2.loss_fn)(
        jax.tree.map(jnp.asarray, init_tree), {"tokens": jnp.asarray(toks)},
        jcfg)
    tloss, tgrads = _torch_loss_grads(init_tree, tcfg, toks)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    _assert_tree_close(tgrads, jax.tree.map(np.asarray, jgrads))


def _torch_loss_grads(init_tree, cfg, toks):
    """(loss, gradient tree as numpy) of the port's GPT-2 loss."""
    tp = params_from_numpy(init_tree, cfg, "cpu")
    leaves = tx.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tgpt2.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss, params_to_numpy(tx.tree_map(lambda _: next(it), tp))


class _OpCounts(TorchDispatchMode):
    """Counts every op dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(init_tree, cfg, toks):
    """The ops the backward dispatches (the replays included), and the
    gradients."""
    tp = params_from_numpy(init_tree, cfg, "cpu")
    leaves = tx.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tgpt2.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()}, cfg)
    with _OpCounts() as mode:
        grads = torch.autograd.grad(loss, leaves)
    return mode.counts, grads


@pytest.mark.parametrize("policy", ["full", "dots", "attn", "attn_qkv"])
def test_remat_policy_replays_what_it_does_not_save(init_tree, policy):
    """What each policy's backward replays, counted at the dispatcher:
    ``full`` the flash forward and the qkv projection of every block;
    ``dots`` no 2-D projection (the backward's aten.mm count is that of
    no remat at all) and no qkv, but the flash forward; ``attn`` no flash
    forward; ``attn_qkv`` neither.  The gradients are those of ``full``,
    bitwise: a replay repeats the same arithmetic."""
    _, full = _cfgs()
    L = full.n_layer
    toks = _tokens(2, 17, full.vocab_size, seed=3)
    no_remat, _ = _backward_ops(init_tree,
                                dataclasses.replace(full, remat=False), toks)
    full_counts, full_grads = _backward_ops(init_tree, full, toks)
    counts, grads = _backward_ops(
        init_tree, dataclasses.replace(full, remat_policy=policy), toks)
    ops = torch.ops.ray_tpu_torch
    flash, qkv = ops.flash_fwd.default, ops.attn_qkv.default
    mm = torch.ops.aten.mm.default
    assert no_remat[flash] == no_remat[qkv] == 0
    want_flash = 0 if policy in ("attn", "attn_qkv") else L
    want_qkv = 0 if policy in ("dots", "attn_qkv") else L
    assert (counts[flash], counts[qkv]) == (want_flash, want_qkv)
    if policy == "dots":
        assert counts[mm] == no_remat[mm]
    else:
        assert counts[mm] > no_remat[mm]
    assert full_counts[flash] == full_counts[qkv] == L
    for a, b in zip(grads, full_grads):
        assert torch.equal(a, b)


def _recipe_cfgs():
    """bench.py's GPT-2-1.5B recipe (remat "attn", bf16 params) on the
    tiny model; float32 activations, so that only the params and the
    moments round to bf16, both sides at the same points."""
    jcfg, tcfg = _cfgs(remat_policy="attn")
    return (dataclasses.replace(jcfg, param_dtype=jnp.bfloat16),
            dataclasses.replace(tcfg, param_dtype=torch.bfloat16))


def test_flagship_recipe_trajectory_matches_jax(init_tree):
    """bf16 params (the LayerNorm affine and the tied wte among them),
    bf16 Adam moments (default_optimizer(moments_dtype=bf16)) and remat
    "attn", five train-program steps on one batch against the reference's.
    Limits: the losses to 1e-4 relative (the float32 trajectory's limit)
    and each leaf's update to 5e-3 of its L2 norm: both sides round the
    same float32 values to bf16 at the same points, but a value within a
    float32 rounding of a bf16 boundary lands one bf16 step (2^-8
    relative) apart, and Adam's normalised steps carry such a step on
    (measured: at most 1.8e-3)."""
    jcfg, tcfg = _recipe_cfgs()
    toks = _tokens(4, 33, jcfg.vocab_size, seed=4)
    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, b: jgpt2.loss_fn(p, b, jcfg),
        init_params_fn=lambda r: jax.tree.map(
            lambda a: jnp.asarray(a, jnp.bfloat16), init_tree),
        optimizer=jspmd.default_optimizer(lr=1e-2, warmup=1, total_steps=50,
                                          moments_dtype=jnp.bfloat16),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc)
    tprog = tspmd.build_train_program(
        loss_fn=lambda p, b: tgpt2.loss_fn(p, b, tcfg),
        init_params_fn=lambda g: params_from_numpy(init_tree, tcfg, "cpu"),
        optimizer=tspmd.default_optimizer(lr=1e-2, warmup=1, total_steps=50,
                                          moments_dtype=torch.bfloat16),
        device="cpu")
    js = jprog.init_fn(jax.random.key(0))
    ts = tprog.init_fn(torch.Generator())
    assert all(t.dtype == torch.bfloat16 for t in tx.tree_leaves(ts.params))
    jb = jspmd.shard_batch(jprog, {"tokens": toks})
    tb = tspmd.shard_batch(tprog, {"tokens": toks})
    losses = []
    for _ in range(5):
        js, jm = jprog.step_fn(js, jb)
        ts, tm = tprog.step_fn(ts, tb)
        losses.append((float(jm["loss"]), tm["loss"].item()))
    losses = np.array(losses)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-4)
    assert losses[-1, 1] < losses[0, 1]
    p0 = jax.tree.map(lambda a: np.asarray(a, np.float32), init_tree)
    got = params_to_numpy(ts.params)
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), js.params)
    for (path, r), g, a0 in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(p0)):
        du_ref, du = r - a0, g - a0
        assert np.linalg.norm(du - du_ref) <= \
            5e-3 * np.linalg.norm(du_ref) + 1e-6, jax.tree_util.keystr(path)


def test_flops_per_token_matches_jax():
    for j, t in ((jgpt2.gpt2_small(), tgpt2.gpt2_small()),
                 (jgpt2.tiny(), tgpt2.tiny())):
        assert tgpt2.flops_per_token(t, 1024) == \
            jgpt2.flops_per_token(j, 1024)


# ----------------------------------------------------------- optimizer
@pytest.mark.parametrize("warmup,total", [(1, 50), (5, 50), (100, 10_000)])
def test_schedule_matches_optax(warmup, total):
    """Counts 0-60: the warmup's first value is exactly 0."""
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                             max(total, warmup + 1),
                                             end_value=3e-5)
    got = tx.warmup_cosine_decay_schedule(0.0, 3e-4, warmup,
                                          max(total, warmup + 1),
                                          end_value=3e-5)
    counts = np.arange(61, dtype=np.int32)
    r = np.asarray(jax.vmap(ref)(jnp.asarray(counts)))
    g = np.array([got(torch.tensor(c)).item() for c in counts])
    assert g[0] == 0.0
    np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-12)


def _quadratic_p0():
    """tests/test_spmd.py:172's objective and start."""
    return {"w": np.asarray(jax.random.normal(jax.random.key(0),
                                              (8, 8))) * 0.5,
            "b": np.ones((8,), np.float32)}


def _jloss(p):
    return jnp.sum((p["w"] @ p["w"].T - jnp.eye(8)) ** 2) + \
        jnp.sum(p["b"] ** 2)


def _tloss(p):
    return torch.sum((p["w"] @ p["w"].T - torch.eye(8)) ** 2) + \
        torch.sum(p["b"] ** 2)


def _run_jax(opt, p0, steps=60):
    p = jax.tree.map(jnp.asarray, p0)
    s = opt.init(p)
    for _ in range(steps):
        u, s = opt.update(jax.grad(_jloss)(p), s, p)
        p = joptim.apply_updates_mixed(p, u)
    return jax.tree.map(np.asarray, p)


def _run_torch(opt, p0, steps=60):
    p = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in p0.items()}
    s = opt.init(p)
    for _ in range(steps):
        for v in p.values():
            v.requires_grad_(True)
        g = dict(zip(p, torch.autograd.grad(_tloss(p), list(p.values()))))
        for v in p.values():
            v.requires_grad_(False)
        with torch.no_grad():
            u, s = opt.update(g, s, p)
            toptim.apply_updates_mixed(p, u)
    return {k: v.numpy() for k, v in p.items()}, s


def test_default_optimizer_matches_reference():
    """60 steps of clip + AdamW + warmup-cosine on the quadratic."""
    p0 = _quadratic_p0()
    ref = _run_jax(jspmd.default_optimizer(lr=1e-2, warmup=5,
                                           total_steps=60), p0)
    got, _ = _run_torch(tspmd.default_optimizer(lr=1e-2, warmup=5,
                                                total_steps=60), p0)
    for k in p0:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0)


def test_plain_adamw_chain_matches_optax():
    """test_spmd.py:172's f32 reference chain, constant learning rate."""
    p0 = _quadratic_p0()
    ref = _run_jax(optax.chain(optax.clip_by_global_norm(1.0),
                               optax.adamw(1e-2, weight_decay=0.01)), p0)
    got, _ = _run_torch(tx.chain(tx.clip_by_global_norm(1.0),
                                 tx.adamw(1e-2, weight_decay=0.01)), p0)
    for k in p0:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0)


def test_adamw_compact_matches_reference():
    p0 = _quadratic_p0()
    ref = _run_jax(joptim.adamw_compact(1e-2, weight_decay=0.01, clip=1.0),
                   p0)
    got, state = _run_torch(
        toptim.adamw_compact(1e-2, weight_decay=0.01, clip=1.0), p0)
    adam = state[1]
    assert all(t.dtype == torch.bfloat16
               for t in tx.tree_leaves(adam["mu"]) + tx.tree_leaves(
                   adam["nu"]))
    for k in p0:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-3, rtol=0)


def test_clip_has_no_epsilon():
    """optax's clip: g / norm * c exactly, unlike clip_grad_norm_."""
    g = {"a": torch.tensor([3.0, 4.0])}
    out, _ = tx.clip_by_global_norm(1.0).update(g, ())
    assert out["a"].tolist() == [0.6000000238418579, 0.800000011920929]
    out, _ = tx.clip_by_global_norm(10.0).update(g, ())
    assert torch.equal(out["a"], g["a"])


# ------------------------------------------------------- train program
def _programs(init_tree, accum_steps=1, steps=10):
    """The reference's and the port's train programs from the same init
    and batch, as bench.py builds the reference's on one device."""
    jcfg, tcfg = _cfgs()
    toks = _tokens(4, 33, jcfg.vocab_size, seed=2)
    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, b: jgpt2.loss_fn(p, b, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, init_tree),
        optimizer=jspmd.default_optimizer(lr=1e-2, warmup=1,
                                          total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc,
        accum_steps=accum_steps)
    tprog = tspmd.build_train_program(
        loss_fn=lambda p, b: tgpt2.loss_fn(p, b, tcfg),
        init_params_fn=lambda g: params_from_numpy(init_tree, tcfg, "cpu"),
        optimizer=tspmd.default_optimizer(lr=1e-2, warmup=1,
                                          total_steps=50),
        mesh_config=tspmd.MeshConfig(data=1), accum_steps=accum_steps,
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


def _assert_trajectory_close(traj):
    """traj: (steps, [loss, grad_norm, step], [reference, port])."""
    np.testing.assert_allclose(traj[:, 0, 1], traj[:, 0, 0], rtol=1e-4)
    np.testing.assert_allclose(traj[:, 1, 1], traj[:, 1, 0], rtol=1e-3)
    np.testing.assert_array_equal(traj[:, 2, 1], traj[:, 2, 0])


def test_train_program_trajectory_matches_jax(init_tree):
    traj, js, ts = _programs(init_tree)
    _assert_trajectory_close(traj)
    assert traj[0, 0, 1] == traj[1, 0, 1]     # lr 0 at count 0: a no-op
    assert traj[-1, 0, 1] < traj[0, 0, 1]
    assert int(ts.step) == 10 and ts.step.dtype == torch.int32
    _assert_params_close(ts, js, 10, init_tree)


def test_grad_accumulation_matches_jax(init_tree):
    traj, js, ts = _programs(init_tree, accum_steps=4, steps=2)
    _assert_trajectory_close(traj)
    _assert_params_close(ts, js, 2, init_tree)


def test_step_updates_state_in_place(init_tree):
    _, tcfg = _cfgs()
    prog = tspmd.build_train_program(
        loss_fn=lambda p, b: tgpt2.loss_fn(p, b, tcfg),
        init_params_fn=lambda g: params_from_numpy(init_tree, tcfg, "cpu"),
        optimizer=tspmd.default_optimizer(lr=1e-2, warmup=1), device="cpu")
    state = prog.init_fn(torch.Generator())
    wte = state.params["wte"]
    toks = _tokens(2, 9, tcfg.vocab_size)
    batch = tspmd.shard_batch(prog, {"tokens": toks})
    assert batch["tokens"].dtype == torch.int64
    for _ in range(2):
        new, m = prog.step_fn(state, batch)
    assert new is state and state.params["wte"] is wte
    assert not wte.requires_grad
    assert set(m) == {"loss", "grad_norm", "step"} and m["step"].item() == 2


# -------------------------------------------------------- entry points
def test_entry_points_raise_without_card_unless_cpu(monkeypatch, init_tree):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(loss_fn=lambda p, b: 0, init_params_fn=lambda g: {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmd.build_train_program(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspmd.build_train_program(mesh=[torch.device("cuda")], **kw)
    assert tspmd.build_train_program(device="cpu", **kw).device.type == "cpu"
    assert tspmd.build_train_program(mesh="cpu", **kw).device.type == "cpu"


@pytest.mark.parametrize("placement", [
    {"mesh_config": tspmd.MeshConfig(data=2)},
    {"mesh_config": tspmd.MeshConfig(data=-1, tensor=2)},
    {"mesh": ["cpu", "cpu"]},
])
def test_more_than_one_device_raises(placement):
    """Outside a torch.distributed domain a layout of more than one
    device cannot be placed (a mesh is one process a rank, over a
    domain), and a list of devices is not a mesh."""
    with pytest.raises(ValueError, match="devices|not a mesh"):
        tspmd.build_train_program(loss_fn=lambda p, b: 0,
                                  init_params_fn=lambda g: {},
                                  device="cpu", **placement)
