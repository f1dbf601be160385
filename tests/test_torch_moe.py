"""ray_tpu_torch's MoE FFN and MoE transformer held against ray_tpu.ops.moe
and ray_tpu.models.moe_transformer on the CPU.

Inputs and weights are made with numpy from a seed (or come from the JAX
init through ``params_from_numpy``) and both sides run in float32, unless
a test says otherwise.  The port's FFN is checked in both forms: the
index form it takes (``moe_ffn``, gathers by slot) and the reference's
einsum form (``moe_ffn_plain``).  With ``n_embd=128`` the JAX side runs its Pallas LayerNorm
in interpret mode (E % 128 == 0); at ``tiny``'s E 64 it takes its plain
branch.  The port's side runs the LayerNorm's plain version through its
autograd Function.

Tolerances, each with its reason: routing (top-k indices, queue
positions, drops, dispatch one-hots) is compared exactly.  Float32
values are summed in other orders on the two sides: gates, logits and
the FFN's output to 1e-5 relative (a few float32 steps through two
products of depth <= ff); the transformer's loss to 1e-5 relative and
each gradient leaf to 1e-4 of its largest element, the limits of
tests/test_torch_train.py; train-program trajectories to 1e-4 relative on
losses and 1e-3 of each leaf's update's L2 norm, as there.  The index
and einsum forms compute the same products: bitwise equal in bf16
(the combine's k products of bf16 values are exact in float32, summed
once, rounded once); in float32 the einsum's fused multiply-adds round
differently from the index form's products and sum, so 2 float32 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as jmodels
from ray_tpu.models import moe_transformer as jmt
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import spmd as jspmd
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import moe_transformer as tmt
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.parallel import spmd as tspmd
from ray_tpu_torch.parallel import transforms as tx

# the index form (moe_ffn) and the reference's einsum form (its plain
# version)
FORMS = {"index": tmoe.moe_ffn, "einsum": tmoe.moe_ffn_plain}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ffn_inputs(seed, B=2, S=24, d=16, E=4, ff=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w_router = (rng.standard_normal((d, E)) * 0.5).astype(np.float32)
    w_in = (rng.standard_normal((E, d, ff)) / np.sqrt(d)).astype(np.float32)
    w_out = (rng.standard_normal((E, ff, d)) / np.sqrt(ff)).astype(
        np.float32)
    return x, w_router, w_in, w_out


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize("N,E,k,cf", [(8192, 8, 2, 1.25), (48, 4, 2, 1.25),
                                      (48, 4, 2, 0.5), (3, 8, 1, 1.0),
                                      (1000, 6, 2, 1.1)])
def test_expert_capacity_matches_jax(N, E, k, cf):
    assert tmoe.expert_capacity(N, E, k, cf) == \
        jmoe.expert_capacity(N, E, k, cf)


@pytest.mark.parametrize("k", [1, 2])
def test_topk_router_matches_jax(k):
    x, w, _, _ = _ffn_inputs(0)
    tokens = x.reshape(-1, x.shape[-1])
    jg, jl, ji = jmoe.topk_router(jnp.asarray(tokens), jnp.asarray(w), k)
    tg, tl, ti = tmoe.topk_router(_t(tokens), _t(w), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    assert tl.dtype == tg.dtype == torch.float32


def test_topk_router_ties_go_to_the_lower_index():
    """A zero router gives every expert the same probability:
    lax.top_k keeps the lowest indices, and so must the port."""
    tokens = np.random.default_rng(1).standard_normal((5, 8)).astype(
        np.float32)
    w = np.zeros((8, 6), np.float32)
    _, _, ji = jmoe.topk_router(jnp.asarray(tokens), jnp.asarray(w), 2)
    tg, _, ti = tmoe.topk_router(_t(tokens), _t(w), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy() == [0, 1]).all()
    np.testing.assert_allclose(tg[:, :2].numpy(), 0.5)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_dispatch_tensors_match_jax(cf):
    """Queue positions in flattened token order; cf 0.5 drops tokens."""
    x, w, _, _ = _ffn_inputs(2)
    tokens = x.reshape(-1, x.shape[-1])
    N, E = tokens.shape[0], w.shape[1]
    cap = jmoe.expert_capacity(N, E, 2, cf)
    jg, _, _ = jmoe.topk_router(jnp.asarray(tokens), jnp.asarray(w), 2)
    jd, jc, jdrop = jmoe._dispatch_tensors(jg, cap)
    td, tc, tdrop = tmoe._dispatch_tensors(_t(np.asarray(jg)), cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    assert (np.asarray(jdrop).any()) == (cf < 1)


def test_load_balance_loss_matches_jax():
    x, w, _, _ = _ffn_inputs(3)
    tokens = x.reshape(-1, x.shape[-1])
    jg, jl, _ = jmoe.topk_router(jnp.asarray(tokens), jnp.asarray(w), 2)
    ja, jz = jmoe.load_balance_loss(jg, jl)
    ta, tz = tmoe.load_balance_loss(_t(np.asarray(jg)), _t(np.asarray(jl)))
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    np.testing.assert_allclose(tz.item(), float(jz), rtol=1e-6)


def _jax_ffn(x, w, wi, wo, cf):
    y, m = jmoe.moe_ffn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(wi),
                        jnp.asarray(wo), k=2, capacity_factor=cf)
    return y, m


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["fits", "drops"])
@pytest.mark.parametrize("form", list(FORMS))
def test_moe_ffn_matches_jax(form, cf):
    """Output and metrics of both forms against the reference's, and the
    gradients of the input, router and both expert banks against
    jax.grad (the default activation is the tanh GELU, jax.nn.gelu's)."""
    x, w, wi, wo = _ffn_inputs(4)
    jy, jm = _jax_ffn(x, w, wi, wo, cf)
    targs = [_t(a).requires_grad_() for a in (x, w, wi, wo)]
    ty, tm = FORMS[form](*targs, k=2, capacity_factor=cf)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for a, b in ((tm.aux_loss, jm.aux_loss),
                 (tm.router_z_loss, jm.router_z_loss),
                 (tm.fraction_dropped, jm.fraction_dropped)):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)
    assert (float(jm.fraction_dropped) > 0) == (cf < 1)
    wgt = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)

    def jloss(*a):
        y, m = jmoe.moe_ffn(*a, k=2, capacity_factor=cf)
        return (y * wgt).sum() + m.aux_loss + m.router_z_loss

    jgr = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, wi, wo)))
    tloss = (ty * _t(wgt)).sum() + tm.aux_loss + tm.router_z_loss
    tgr = torch.autograd.grad(tloss, targs)
    for a, r in zip(tgr, jgr):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_moe_ffn_index_form_equals_einsum_form():
    """bf16 activations (the card's): the two forms bitwise equal, with
    tokens dropped; in float32 within 2 float32 steps."""
    x, w, wi, wo = _ffn_inputs(6, S=40)
    for dt in (torch.bfloat16, torch.float32):
        args = (_t(x).to(dt), _t(w), _t(wi).to(dt), _t(wo).to(dt))
        yi, mi = tmoe.moe_ffn(*args, capacity_factor=0.5)
        ye, me = tmoe.moe_ffn_plain(*args, capacity_factor=0.5)
        assert mi.fraction_dropped.item() == me.fraction_dropped.item() > 0
        if dt == torch.bfloat16:
            assert torch.equal(yi, ye)
        else:
            torch.testing.assert_close(yi, ye, rtol=2 * 2 ** -23,
                                       atol=2 * 2 ** -23)


def test_init_moe_params_shapes():
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 4)
    j = jmoe.init_moe_params(jax.random.key(0), 16, 32, 4)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in j.items()}
    assert abs(p["w_in"].std().item() - 0.25) < 0.05


def test_rules_are_the_reference_partition_specs():
    ref = [(pat, tuple(spec)) for pat, spec in jmoe.MOE_RULES]
    assert tmoe.MOE_RULES == ref
    ref = [(pat, tuple(spec)) for pat, spec in jmt.MOE_TRANSFORMER_RULES]
    assert tmt.MOE_TRANSFORMER_RULES == ref


# -------------------------------------------------------- transformer
CONFIGS = {"tiny": {}, "e128": {"n_embd": 128}}


def _cfgs(name, **kw):
    jcfg = dataclasses.replace(jmt.tiny(), dtype=jnp.float32,
                               **CONFIGS[name], **kw)
    tcfg = dataclasses.replace(tmt.tiny(), dtype=torch.float32,
                               **CONFIGS[name], **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def trees():
    return {name: jax.tree.map(np.asarray, jmt.init_params(
        jax.random.key(0), _cfgs(name)[0])) for name in CONFIGS}


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


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(trees, name):
    jcfg, tcfg = _cfgs(name)
    toks = _tokens(2, 33, jcfg.vocab_size)
    jl, jm = jmt.forward(jax.tree.map(jnp.asarray, trees[name]),
                         jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tl, tm = tmt.forward(params_from_numpy(trees[name], tcfg, "cpu"),
                             torch.from_numpy(toks).long(), tcfg)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for key in jm:
        np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                   rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(trees, name, remat):
    jcfg, tcfg = _cfgs(name, remat=remat)
    toks = _tokens(2, 33, jcfg.vocab_size, seed=1)
    jloss, jgrads = jax.value_and_grad(jmt.loss_fn)(
        jax.tree.map(jnp.asarray, trees[name]), {"tokens": jnp.asarray(toks)},
        jcfg)
    tp = params_from_numpy(trees[name], tcfg, "cpu")
    leaves = tx.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss = tmt.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    it = iter(tgrads)
    _assert_tree_close(params_to_numpy(tx.tree_map(lambda _: next(it), tp)),
                       jax.tree.map(np.asarray, jgrads))


def test_remat_on_matches_remat_off(trees):
    """Checkpointed blocks (their tuple outputs) replay the same forward:
    the same gradients."""
    _, on = _cfgs("tiny")
    off = dataclasses.replace(on, remat=False)
    toks = torch.from_numpy(_tokens(2, 17, on.vocab_size, seed=2)).long()
    grads = []
    for cfg in (on, off):
        tp = params_from_numpy(trees["tiny"], cfg, "cpu")
        leaves = tx.tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        grads.append(torch.autograd.grad(
            tmt.loss_fn(tp, {"tokens": toks}, cfg), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_init_params_matches_jax_shapes_and_count():
    """moe-small's param tree (on the meta device: nothing drawn) against
    jax.eval_shape of the reference's init: the same keys, shapes and
    count (0.52 B)."""
    cfg = tmt.moe_small()
    ref = jax.eval_shape(lambda: jmt.init_params(jax.random.key(0),
                                                 jmt.moe_small()))
    got = tmt.init_params(None, cfg, device="meta")
    ref_shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    got_shapes = tx.tree_map(lambda t: tuple(t.shape), got)
    assert got_shapes == ref_shapes
    n = sum(t.numel() for t in tx.tree_leaves(got))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert 0.51e9 < n < 0.53e9


def test_init_params_draws_on_the_generator_device():
    _, cfg = _cfgs("tiny")
    p = tmt.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    q = tmt.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for a, b in zip(tx.tree_leaves(p), tx.tree_leaves(q)):
        assert torch.equal(a, b) and a.dtype == torch.float32
    w_in = p["blocks"]["moe"]["w_in"]
    assert abs(w_in.std().item() - 1 / np.sqrt(cfg.n_embd)) < 0.01
    assert p["blocks"]["ln_1"]["scale"].eq(1).all()


def test_params_round_trip(trees):
    """The reference's numpy tree → the port's tensors → numpy: the same
    keys, shapes and values, the stacked moe leaves with their L axis."""
    _, cfg = _cfgs("tiny")
    tp = params_from_numpy(trees["tiny"], cfg, "cpu")
    assert tuple(tp["blocks"]["moe"]["w_in"].shape) == \
        (cfg.n_layer, cfg.num_experts, cfg.n_embd, cfg.expert_ff)
    back = params_to_numpy(tp)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(trees["tiny"]),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(g, r, err_msg=jax.tree_util.keystr(path))


def test_train_program_trajectory_matches_jax(trees):
    """Six steps of build_train_program on one batch, both sides."""
    jcfg, tcfg = _cfgs("tiny")
    tree = trees["tiny"]
    toks = _tokens(4, 33, jcfg.vocab_size, seed=3)
    mc = jmesh.MeshConfig(data=1).resolved(1)
    jprog = jspmd.build_train_program(
        loss_fn=lambda p, b: jmt.loss_fn(p, b, jcfg),
        init_params_fn=lambda r: jax.tree.map(jnp.asarray, tree),
        optimizer=jspmd.default_optimizer(lr=1e-2, warmup=1, total_steps=50),
        mesh=jmesh.build_mesh(mc, [jax.devices()[0]]), mesh_config=mc)
    tprog = tspmd.build_train_program(
        loss_fn=lambda p, b: tmt.loss_fn(p, b, tcfg),
        init_params_fn=lambda g: params_from_numpy(tree, tcfg, "cpu"),
        optimizer=tspmd.default_optimizer(lr=1e-2, warmup=1, total_steps=50),
        device="cpu")
    js = jprog.init_fn(jax.random.key(0))
    ts = tprog.init_fn(torch.Generator())
    jb = jspmd.shard_batch(jprog, {"tokens": toks})
    tb = tspmd.shard_batch(tprog, {"tokens": toks})
    traj = []
    for _ in range(6):
        js, jm = jprog.step_fn(js, jb)
        ts, tm = tprog.step_fn(ts, tb)
        traj.append([(float(jm[k]), tm[k].item())
                     for k in ("loss", "grad_norm")])
    traj = np.array(traj)
    np.testing.assert_allclose(traj[:, 0, 1], traj[:, 0, 0], rtol=1e-4)
    np.testing.assert_allclose(traj[:, 1, 1], traj[:, 1, 0], rtol=1e-3)
    assert traj[-1, 0, 1] < traj[0, 0, 1]
    got = params_to_numpy(ts.params)
    ref = jax.tree.map(np.asarray, js.params)
    for (path, r), g, p0 in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(tree)):
        du_ref, du = r - p0, g - p0
        assert np.linalg.norm(du - du_ref) <= \
            1e-3 * np.linalg.norm(du_ref) + 1e-7, jax.tree_util.keystr(path)


# ----------------------------------------------------------- registry
@pytest.mark.parametrize("name", ["gpt2", "llama", "moe", "moe-small",
                                  "moe/tiny", "gpt2-xl", "llama/llama3-8b",
                                  "llama3-8b"])
def test_get_model_matches_reference(name):
    """What the reference's registry returns, the port's returns the
    port's module of the same family."""
    ref = jmodels.get_model(name)
    got = tmodels.get_model(name)
    assert got.__name__.rsplit(".", 1)[1] == ref.__name__.rsplit(".", 1)[1]
    assert set(got.PRESETS) == set(ref.PRESETS)


@pytest.mark.parametrize("name", ["tiny", "nope", "gpt2/nope", "moe/gpt2"])
def test_get_model_raises_as_reference(name):
    """An ambiguous preset ("tiny": every family has one) and unknown
    names raise KeyError on both sides."""
    with pytest.raises(KeyError):
        jmodels.get_model(name)
    with pytest.raises(KeyError):
        tmodels.get_model(name)


@pytest.mark.parametrize("name", ["bert", "vit", "t5", "resnet",
                                  "bert-base", "vit/vit-b16", "resnet50"])
def test_get_model_resolves_the_encoder_and_vision_families(name):
    """The encoder and vision families, by family, "family/preset" and
    bare preset: the port returns its module of the family the reference
    returns, with the same presets."""
    ref = jmodels.get_model(name)
    got = tmodels.get_model(name)
    assert got.__name__.rsplit(".", 1)[1] == ref.__name__.rsplit(".", 1)[1]
    assert set(got.PRESETS) == set(ref.PRESETS)
    assert got is tmodels.REGISTRY[got.__name__.rsplit(".", 1)[1]]


def test_ops_moe_imports_first_in_a_fresh_process():
    """``ray_tpu_torch.ops.moe`` imported before anything else of the
    package (C30: its top-level import of ``models._common`` loaded the
    ``models`` package, whose ``moe_transformer`` imported the
    half-initialised module back)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", "from ray_tpu_torch.ops import moe; "
         "print(len(moe.MOE_RULES))"], env=env, cwd=root,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "6"
