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

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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


@pytest.mark.parametrize("policy,err", [("dots", NotImplementedError),
                                        ("attn", NotImplementedError),
                                        ("attn_qkv", NotImplementedError),
                                        ("bogus", ValueError)])
def test_non_full_remat_policies_raise(init_tree, policy, err):
    """No policy may quietly act as full remat."""
    _, cfg = _cfgs(remat_policy=policy)
    tp = params_from_numpy(init_tree, cfg, "cpu")
    with pytest.raises(err):
        tgpt2.loss_fn(tp, {"tokens": torch.zeros((1, 9), dtype=torch.long)},
                      cfg)


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
    with pytest.raises(NotImplementedError, match="slice 4"):
        tspmd.build_train_program(loss_fn=lambda p, b: 0,
                                  init_params_fn=lambda g: {},
                                  device="cpu", **placement)
