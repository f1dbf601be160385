"""Disaggregated prefill/decode in ray_tpu_torch.serve.llm, held to the
reference's oracles and to the JAX package on the CPU.

Mirrors ``tests/test_serve_llm.py``'s handoff tests (the decode engine
adopts a remotely prefilled block table over the data plane and
continues the stream exactly, with its own ``prefill_steps`` at 0;
batch capacity and cancel; geometry mismatch), the spool half of its
orphan-reap test, its SIGKILL chaos case (a killed replica's export
spool is reaped by the next engine's boot), and
``tests/test_trace_assembly.py``'s handoff tree (one causal tree from
``llm.prefill_remote`` through ``llm.attach`` to the decode spans).
Parity: the same prompt through ``prefill_remote`` → ``attach`` in both
packages gives the same tokens, and the exported blocks' floats agree.
"""

import dataclasses
import logging
import os
import signal
import sys
import time

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.serve.llm import kv_cache as kvmod

cloudpickle.register_pickle_by_value(sys.modules[__name__])

TCFG = {"gpt2": dataclasses.replace(tgpt2.tiny(), dtype=torch.float32),
        "llama": dataclasses.replace(tllama.tiny(), dtype=torch.float32)}
JCFG = {"gpt2": dataclasses.replace(jgpt2.tiny(), dtype=jnp.float32),
        "llama": dataclasses.replace(jllama.tiny(), dtype=jnp.float32)}
JMOD = {"gpt2": jgpt2, "llama": jllama}
BLOCKS = {"gpt2": ("attn_qkv", "attn_out", "mlp_in", "mlp_out"),
          "llama": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
# the K/V parity limit of tests/test_torch_gpt2.py and test_torch_llama.py
KV_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def shm_dir(monkeypatch, tmp_path):
    """The port's shm directory (export spools, the weights plane),
    private to the test."""
    from ray_tpu_torch._private import shm_store
    d = tmp_path / "shm"
    d.mkdir()
    monkeypatch.setattr(shm_store, "_SHM_DIR", d)
    monkeypatch.setenv("RTT_SHM_DIR", str(d))
    return d


def tiny_cfg(model="gpt2:tiny", **kw):
    base = dict(model=model, num_blocks=64, block_size=8, max_num_seqs=4,
                max_model_len=64, max_prefill_tokens=32,
                prefill_len_buckets=(16, 32, 64),
                decode_batch_buckets=(1, 2, 4), share_weights=False)
    base.update(kw)
    return EngineConfig(**base)


def engine(cfg, params=None):
    fam = cfg.model.split(":")[0]
    return LLMEngine(cfg, params, device="cpu", model_cfg=TCFG[fam])


def spools(d):
    return sorted(n for n in os.listdir(d)
                  if n.startswith(kvmod.EXPORT_SPOOL_PREFIX))


# ------------------------------------------- prefill/decode handoff
def test_handoff_attaches_without_recompute(shm_dir):
    """A decode engine adopts a remotely prefilled block table over the
    data plane and continues the stream EXACTLY; its own prefill
    counter stays at zero."""
    cfg = tiny_cfg(model="llama:tiny")
    pre, dec = engine(cfg), engine(cfg)
    try:
        prompt = [5, 9, 13, 21, 34, 2, 11]
        sp = SamplingParams(max_tokens=9)
        ref = pre.generate(prompt, sp)
        man = pre.prefill_remote(prompt, sp)
        assert len(man["blocks"]) == pre.cache.blocks_needed(len(prompt))
        assert man["addr"].startswith("tcp://")
        assert man["block_nbytes"] == pre.cache.block_nbytes == \
            4 * 2 * 2 * 8 * TCFG["llama"].n_kv_head * 16
        assert len(spools(shm_dir)) == 1      # rtt_llm_export_<pid>_*
        got = dec.attach(man, sp).tokens()
        assert got == ref
        assert dec.prefill_steps == 0           # no recompute, ever
        assert dec.decode_steps > 0
        # the prefill side released its working blocks after export
        assert pre.cache.free_block_count() == cfg.num_blocks
    finally:
        pre.shutdown()
        dec.shutdown()
    assert spools(shm_dir) == []              # shutdown removes it


def test_attach_respects_batch_capacity_and_cancel():
    """Adopting more manifests than max_num_seqs must queue the excess
    (not overflow the decode bucket), and an attached stream's cancel()
    frees its blocks."""
    cfg = tiny_cfg(max_num_seqs=2, decode_batch_buckets=(1, 2))
    pre, dec = engine(cfg), engine(cfg)
    try:
        sp = SamplingParams(max_tokens=6)
        mans = [pre.prefill_remote([3 + i, 5, 7], sp) for i in range(5)]
        streams = [dec.attach(m, sp) for m in mans]
        outs = [s.tokens() for s in streams]
        assert all(len(o) == 6 for o in outs)
        assert dec.prefill_steps == 0
        # cancel an attached-but-unread stream: blocks come back
        man = pre.prefill_remote([9, 9, 9], sp)
        s = dec.attach(man, sp)
        s.cancel()
        deadline = time.monotonic() + 10
        while dec.cache.used_block_count() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert dec.cache.used_block_count() == 0
    finally:
        pre.shutdown()
        dec.shutdown()


def test_handoff_rejects_geometry_mismatch():
    pre = engine(tiny_cfg())
    dec = engine(tiny_cfg(block_size=4))
    try:
        man = pre.prefill_remote([1, 2, 3], SamplingParams(max_tokens=2))
        with pytest.raises(ValueError, match="geometry"):
            dec.attach(man, SamplingParams(max_tokens=2))
        assert dec.cache.used_block_count() == 0
    finally:
        pre.shutdown()
        dec.shutdown()


def test_block_transfer_round_trip():
    """``blocks_bytes`` (one gather, one copy) gives ``block_bytes`` of
    each block, in the reference's layout (C order of the block's
    float32 [L, 2, bs, KV, D]), and ``load_block`` puts them back."""
    c = kvmod.PagedKVCache(num_blocks=4, n_layer=2, block_size=2, n_kv=1,
                           head_dim=3, device="cpu")
    c.pool.copy_(torch.arange(c.pool.numel(), dtype=torch.float32)
                 .view_as(c.pool))
    assert c.block_nbytes == 2 * 2 * 2 * 1 * 3 * 4
    rows = c.blocks_bytes([2, 0])
    assert [bytes(r) for r in rows] == [c.block_bytes(2), c.block_bytes(0)]
    assert bytes(rows[0]) == np.arange(48, 72, dtype=np.float32).tobytes()
    c.load_block(1, bytes(rows[0]))             # read-only source too
    c.load_block(3, bytearray(rows[1]))
    assert torch.equal(c.pool[1], c.pool[2])
    assert torch.equal(c.pool[3], c.pool[0])


# ----------------------------------------------------- spool reaping
def test_export_spool_orphan_reap(shm_dir):
    """The spool half of the reference's orphan-reap test: a dead pid's
    ``rtt_llm_export_<pid>_*`` spool goes, a live pid's (and this
    process's) stays; an engine's boot runs the sweep."""
    names = {pid: f"{kvmod.EXPORT_SPOOL_PREFIX}{pid}_x{i}"
             for i, pid in enumerate((999999999, os.getppid(),
                                      os.getpid()))}
    for n in names.values():
        (shm_dir / n).mkdir()
        (shm_dir / n / "obj_llmkv_a_1").write_bytes(b"\0" * 64)
    (shm_dir / "rtt_llm_export_notapid").mkdir()
    assert kvmod.reap_orphan_export_spools(str(shm_dir)) == \
        [names[999999999]]
    assert spools(shm_dir) == sorted(
        [names[os.getppid()], names[os.getpid()], "rtt_llm_export_notapid"])
    (shm_dir / f"{kvmod.EXPORT_SPOOL_PREFIX}999999998_y").mkdir()
    engine(tiny_cfg(), None).shutdown()         # boot sweeps again
    assert f"{kvmod.EXPORT_SPOOL_PREFIX}999999998_y" not in spools(shm_dir)
    assert kvmod.reap_orphan_export_spools(None) == []


# ----------------------------------------------- parity with the JAX side
def _scaled(family):
    """The JAX init with every block matrix ×10, as
    test_torch_serve_llm.py's: the context decides the tokens."""
    mod, cfg = JMOD[family], JCFG[family]
    p = mod.init_params(jax.random.key(0), cfg)
    blocks = dict(p["blocks"])
    for name in BLOCKS[family]:
        blocks[name] = dict(blocks[name], kernel=blocks[name]["kernel"] * 10)
    return dict(p, blocks=blocks)


def _pull_block(pool, man, i):
    raw = pool.pull(man["addr"], man["blocks"][i], size=man["block_nbytes"])
    return np.frombuffer(bytes(raw), np.float32)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_handoff_matches_the_jax_package(family, monkeypatch):
    """The same prompt through prefill_remote → attach in both packages,
    on the same weights (``params_from_numpy``): the same tokens, the
    same manifest geometry, and each exported block's filled positions
    within KV_ATOL of the JAX engine's."""
    from ray_tpu._private.data_plane import DataPlanePool as JPool
    from ray_tpu.serve.llm import EngineConfig as JEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JLLMEngine
    from ray_tpu.serve.llm import SamplingParams as JSamplingParams
    from ray_tpu.serve.llm import model_runner as jrunner
    from ray_tpu_torch._private.data_plane import DataPlanePool

    jp = _scaled(family)
    monkeypatch.setattr(jrunner, "resolve_model",
                        lambda cfg: (JMOD[family], JCFG[family]))
    cfg = tiny_cfg(model=f"{family}:tiny")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    prompt = np.random.default_rng(7).integers(
        1, TCFG[family].vocab_size, 19).tolist()
    n = len(prompt)
    jeng = JLLMEngine(JEngineConfig(**fields), params=jp)
    jpool = JPool()
    try:
        jman = jeng.prefill_remote(prompt, JSamplingParams(max_tokens=8))
        jblocks = [_pull_block(jpool, jman, i)
                   for i in range(len(jman["blocks"]))]
        # the JAX engine adopts its own manifest: the decode side of the
        # handoff, with no prefill of its own
        steps = jeng.prefill_steps
        want = jeng.attach(jman, JSamplingParams(max_tokens=8)).tokens()
        assert jeng.prefill_steps == steps
    finally:
        jpool.close_all()
        jeng.shutdown()
    assert len(set(want)) > 1                   # not one repeated token

    tp = params_from_numpy(jax.tree.map(np.asarray, jp), TCFG[family],
                           "cpu")
    pre, dec = engine(cfg, tp), engine(cfg, tp)
    pool = DataPlanePool()
    try:
        man = pre.prefill_remote(prompt, SamplingParams(max_tokens=8))
        assert {k: man[k] for k in ("block_nbytes", "block_size", "model",
                                    "tokens", "first_token")} == \
            {k: jman[k] for k in ("block_nbytes", "block_size", "model",
                                  "tokens", "first_token")}
        assert len(man["blocks"]) == len(jman["blocks"])
        shape = (-1,) + pre.cache.block_shape   # (1, L, 2, bs, KV, D)
        for i in range(len(man["blocks"])):
            filled = min(cfg.block_size, n - i * cfg.block_size)
            got = _pull_block(pool, man, i).reshape(shape)[0][:, :, :filled]
            ref = jblocks[i].reshape(shape)[0][:, :, :filled]
            np.testing.assert_allclose(got, ref, atol=KV_ATOL, rtol=0)
        got = dec.attach(man, SamplingParams(max_tokens=8)).tokens()
        assert dec.prefill_steps == 0
    finally:
        pool.close_all()
        pre.shutdown()
        dec.shutdown()
    assert got == want


# ------------------------------------------- a cluster: chaos and tracing
@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """One cluster for the tests below, its store and spools in a
    directory of its own; the package logger restored after it."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import rtlog, shm_store
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    d = tmp_path_factory.mktemp("handoff_shm")
    mp = pytest.MonkeyPatch()
    mp.setattr(shm_store, "_SHM_DIR", d)
    mp.setenv("RTT_SHM_DIR", str(d))
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4)
    try:
        yield d
    finally:
        serve.shutdown()
        rt.shutdown()
        mp.undo()
        for h in log.handlers[:]:
            if h not in handlers:
                log.removeHandler(h)
                h.close()
        log.propagate, log.level = propagate, level
        rtlog._stream_configured = False
        rtlog._file_handlers.clear()


@pytest.fixture
def cluster_shm(cluster, monkeypatch):
    """The autouse ``shm_dir`` points this process at a fresh directory:
    point it back at the cluster's, where the replicas write."""
    from ray_tpu_torch._private import shm_store
    monkeypatch.setattr(shm_store, "_SHM_DIR", cluster)
    monkeypatch.setenv("RTT_SHM_DIR", str(cluster))
    return cluster


def _exporting_deployment(cfg):
    """``llm_deployment(cfg)``'s server plus one method that prefills a
    prompt on the replica's engine and exports its blocks: the prefill
    half of a disaggregated pair (user code; the engine API is the
    reference's, no deployment type wraps it)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_deployment
    base = llm_deployment(cfg, device="cpu").user_class

    class ExportingServer(base):
        async def prefill_remote(self, prompt):
            eng = await self._engine_for(self._cfg.model)
            return eng.prefill_remote(prompt)

    return serve.deployment(name="Exporter")(ExportingServer)


def test_chaos_sigkill_exporting_replica_spool_reaped(cluster_shm):
    """Mirror of the reference's chaos case for the export plane:
    SIGKILL a replica that has exported.  The in-flight stream fails
    cleanly, the controller replaces the replica, new traffic flows,
    and the new replica's engine boot reaps the killed pid's
    ``rtt_llm_export_<pid>_*`` spool (found by the pid in its name: the
    port has no ``kv_segment``)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    shm = cluster_shm
    h = serve.run(_exporting_deployment(tiny_cfg()).bind(), name="exp",
                  route_prefix=None)
    man = h.prefill_remote.remote([1, 2, 3, 4]).result()
    victim_pid = h.engine_stats.remote().result()["pid"]
    mine = [n for n in spools(shm)
            if n.startswith(f"{kvmod.EXPORT_SPOOL_PREFIX}{victim_pid}_")]
    assert len(mine) == 1 and os.listdir(shm / mine[0]), spools(shm)
    assert man["addr"].startswith("tcp://")
    gen = h.remote({"prompt": [3, 4, 5], "max_tokens": 48}).result()
    assert len([next(gen), next(gen)]) == 2
    os.kill(victim_pid, signal.SIGKILL)
    with pytest.raises(rt.exceptions.RayServeError):
        for _ in gen:       # fails cleanly, never hangs
            pass
    deadline = time.monotonic() + 120
    out = None
    while time.monotonic() < deadline:
        try:
            out = [int(x) for x in h.remote(
                {"prompt": [1, 2], "max_tokens": 3}).result(timeout_s=30)]
            if len(out) == 3:
                break
        except Exception:  # noqa: BLE001 - replica still restarting
            time.sleep(0.5)
    assert out is not None and len(out) == 3, out
    assert h.engine_stats.remote().result()["pid"] != victim_pid
    with pytest.raises(ProcessLookupError):
        os.kill(victim_pid, 0)
    assert mine[0] not in spools(shm), \
        f"the killed replica's export spool leaked: {spools(shm)}"
    serve.delete("exp")


def _collect(node, out):
    out.append(node)
    for c in node.children:
        _collect(c, out)
    return out


def _find(roots, name):
    return [n for r in roots for n in _collect(r, []) if n.name == name]


def test_one_tree_spans_the_llm_handoff(cluster_shm):
    """The LLM half of the reference's single-tree test: one traced
    request's prefill → decode handoff is ONE causal tree — the
    manifest's ``llm.prefill_remote`` under the root, ``llm.attach``
    under it, every ``llm.decode_step`` under the attach, and the
    attach's KV block pulls (``data.pull`` of ``llmkv_*``) with their
    holder-side ``data.serve_stream`` spans inside it."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import trace_assembly, tracing
    eng_a, eng_b = engine(tiny_cfg()), engine(tiny_cfg())
    try:
        with tracing.trace("root") as root:
            manifest = eng_a.prefill_remote(list(range(1, 12)))
            toks = eng_b.attach(manifest).tokens()
            assert len(toks) >= 2   # first_token + decoded continuation
        need = ["llm.prefill_remote", "llm.attach", "llm.decode_step",
                "data.pull", "data.serve_stream"]
        deadline = time.time() + 30
        while True:
            roots = trace_assembly.build_tree(rt.timeline(), root.trace_id)
            have = {n.name for r in roots for n in _collect(r, [])}
            if all(w in have for w in need) or time.time() > deadline:
                break
            time.sleep(0.25)
    finally:
        eng_a.shutdown()
        eng_b.shutdown()
    assert len(roots) == 1, [f"{r.name}({r.parent_id})" for r in roots]
    assert roots[0].name == "root"

    def args(n):
        return n.primary.get("args") or {}

    pre = _find(roots, "llm.prefill_remote")
    assert pre and args(pre[0])["parent_id"] == root.span_id
    att = _find(roots, "llm.attach")
    assert att and args(att[0])["parent_id"] == pre[0].span_id
    decodes = _find(roots, "llm.decode_step")
    assert decodes and all(args(d)["parent_id"] == att[0].span_id
                           for d in decodes)
    kv_pulls = [n for n in _find(roots, "data.pull")
                if str(args(n).get("object_id", "")).startswith("llmkv_")]
    assert len(kv_pulls) == len(manifest["blocks"]) and all(
        args(n)["parent_id"] == pre[0].span_id for n in kv_pulls)
    serves = _find(roots, "data.serve_stream")
    assert serves and all(args(s)["parent_id"] in
                          {p.span_id for p in kv_pulls} for s in serves)
    text = trace_assembly.render_tree(roots)
    assert "llm.attach" in text and "data.pull" in text
