"""ray_tpu_torch.serve.llm held against the JAX reference on the CPU.

The oracle is the reference's: greedy decode through the paged engine
must give exactly the tokens of recompute-everything greedy decode with
the JAX model's full forward pass, on the same weights (carried across
by ``params_from_numpy``), alone, batched and under preemption, for
GPT-2 and for Llama (grouped-query attention, RoPE, untied head).
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm.model_runner import ModelRunner as JRunner
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models._common import tree_map
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.serve.llm import weights as wmod
from ray_tpu_torch.serve.llm.config import resolve_model
from ray_tpu_torch.serve.llm.kv_cache import NoFreeBlocks, PagedKVCache
from ray_tpu_torch.serve.llm.model_runner import ModelRunner
from ray_tpu_torch.serve.llm.scheduler import IterationScheduler, Sequence

JCFG = dataclasses.replace(jgpt2.tiny(), dtype=jnp.float32)
TCFG = dataclasses.replace(tgpt2.tiny(), dtype=torch.float32)
JLCFG = dataclasses.replace(jllama.tiny(), dtype=jnp.float32)
TLCFG = dataclasses.replace(tllama.tiny(), dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    beside other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**kw):
    base = dict(model="gpt2:tiny", num_blocks=64, block_size=8,
                max_num_seqs=4, max_model_len=64, max_prefill_tokens=32,
                prefill_len_buckets=(16, 32, 64),
                decode_batch_buckets=(1, 2, 4), share_weights=False)
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def jparams():
    """The JAX init with every block matrix scaled ×10: at the init scale
    the tied LM head makes greedy decode repeat the last token, and an
    engine that ignored its context would pass; here tokens vary."""
    p = jgpt2.init_params(jax.random.key(0), JCFG)
    blocks = dict(p["blocks"])
    for name in ("attn_qkv", "attn_out", "mlp_in", "mlp_out"):
        blocks[name] = dict(blocks[name], kernel=blocks[name]["kernel"] * 10)
    return dict(p, blocks=blocks)


@pytest.fixture(scope="module")
def jlparams():
    """The JAX Llama init with every block matrix scaled ×10, as GPT-2's
    above: attention sharp enough that the context decides the tokens."""
    p = jllama.init_params(jax.random.key(0), JLCFG)
    blocks = dict(p["blocks"])
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        blocks[name] = dict(blocks[name], kernel=blocks[name]["kernel"] * 10)
    return dict(p, blocks=blocks)


def make_engine(jparams, **kw):
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG, "cpu")
    return LLMEngine(tiny_cfg(**kw), tp, device="cpu", model_cfg=TCFG)


def make_llama_engine(jlparams, **kw):
    tp = params_from_numpy(jax.tree.map(np.asarray, jlparams), TLCFG, "cpu")
    return LLMEngine(tiny_cfg(model="llama:tiny", **kw), tp, device="cpu",
                     model_cfg=TLCFG)


_jax_forward = jax.jit(lambda p, t: jgpt2.forward(p, t, JCFG))
_jax_llama_forward = jax.jit(lambda p, t: jllama.forward(p, t, JLCFG))


def jax_greedy(jparams, prompt, n, forward=_jax_forward,
               n_positions=JCFG.n_positions):
    """Reference greedy: the JAX full forward recomputed per token.  The
    tokens are padded to n_positions so one program serves every length:
    the model is causal, so the padding cannot reach the last real
    position's logits."""
    toks, out = list(prompt), []
    for _ in range(n):
        padded = np.zeros((1, n_positions), np.int32)
        padded[0, :len(toks)] = toks
        logits = np.asarray(forward(jparams, jnp.asarray(padded)))
        out.append(int(np.argmax(logits[0, len(toks) - 1])))
        toks.append(out[-1])
    return out


def jax_llama_greedy(jlparams, prompt, n):
    return jax_greedy(jlparams, prompt, n, _jax_llama_forward,
                      JLCFG.max_positions)


def _solo(eng, greedy, vocab):
    try:
        prompt = np.random.default_rng(1).integers(1, vocab, 7).tolist()
        got = eng.generate(prompt, SamplingParams(max_tokens=8))
        assert got == greedy(prompt, 8)
    finally:
        eng.shutdown()


def _concurrent(eng, greedy, vocab):
    try:
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, vocab, rng.integers(3, 20)).tolist()
                   for _ in range(4)]
        streams = [eng.submit(p, SamplingParams(max_tokens=6))
                   for p in prompts]
        outs = [s.tokens() for s in streams]
        for p, o in zip(prompts, outs):
            assert o == greedy(p, 6)
        assert len({t for o in outs for t in o}) > 8     # not a repeat
        st = eng.stats()
        assert st["decode_steps"] < 4 * 6        # batched, not serial
        assert st["compiles"] <= 3 + 3           # bounded bucket shapes
    finally:
        eng.shutdown()


PREEMPT = dict(num_blocks=6, block_size=4, max_model_len=32,
               max_prefill_tokens=16, prefill_len_buckets=(16, 32))


def _preemption(eng, greedy):
    try:
        sp = SamplingParams(max_tokens=12)
        prompts = [[1 + 7 * i, 2, 3] for i in range(3)]
        outs = [s.tokens() for s in [eng.submit(p, sp) for p in prompts]]
        assert eng.stats()["preemptions"] >= 1
        for p, o in zip(prompts, outs):
            assert o == greedy(p, 12)
        assert eng.cache.free_block_count() == 6   # all blocks returned
    finally:
        eng.shutdown()


def test_engine_solo_matches_jax_oracle(jparams):
    _solo(make_engine(jparams), lambda p, n: jax_greedy(jparams, p, n), 100)


def test_engine_concurrent_matches_jax_oracle(jparams):
    _concurrent(make_engine(jparams),
                lambda p, n: jax_greedy(jparams, p, n), 200)


def test_engine_preemption_matches_jax_oracle(jparams):
    _preemption(make_engine(jparams, **PREEMPT),
                lambda p, n: jax_greedy(jparams, p, n))


def test_llama_engine_solo_matches_jax_oracle(jlparams):
    _solo(make_llama_engine(jlparams),
          lambda p, n: jax_llama_greedy(jlparams, p, n), JLCFG.vocab_size)


def test_llama_engine_concurrent_matches_jax_oracle(jlparams):
    _concurrent(make_llama_engine(jlparams),
                lambda p, n: jax_llama_greedy(jlparams, p, n),
                JLCFG.vocab_size)


def test_llama_engine_preemption_matches_jax_oracle(jlparams):
    _preemption(make_llama_engine(jlparams, **PREEMPT),
                lambda p, n: jax_llama_greedy(jlparams, p, n))


def test_oversize_prompt_and_cancel(jparams):
    eng = make_engine(jparams)
    try:
        with pytest.raises(RuntimeError, match="max_prefill_tokens"):
            eng.submit(list(range(60)), SamplingParams(max_tokens=8)).tokens()
        s = eng.submit([1, 2, 3], SamplingParams(max_tokens=40))
        s.cancel()
        eng.generate([4, 5], SamplingParams(max_tokens=2))
        assert eng.cache.free_block_count() == 64
    finally:
        eng.shutdown()


# ------------------------------------------- the Serve deployment's API
POLL_SEQUENCES = [
    ([1, 2, 3, ("__llm_done__", "length")], [(16, 0.01)] * 2),
    ([4, 5, 6, 7, 8], [(2, 0.01)] * 4),
    ([9, ("__llm_err__", "boom")], [(16, 0.01)] * 2),
    ([("__llm_err__", "boom")], [(16, 0.01)]),
    ([], [(16, 0.01)]),
]


@pytest.mark.parametrize("items,polls", POLL_SEQUENCES)
def test_request_stream_poll_matches_reference(items, polls):
    """poll() on the port's RequestStream and the reference's, over the
    same queued items: the same (tokens, done) and the same errors."""
    import queue
    from ray_tpu.serve.llm.engine import RequestStream as JStream
    from ray_tpu_torch.serve.llm.engine import RequestStream as TStream

    def run(cls):
        q = queue.Queue()
        for it in items:
            q.put(it)
        s, out = cls("s", q), []
        for n, timeout in polls:
            try:
                out.append(s.poll(max_items=n, timeout=timeout))
            except RuntimeError as e:
                out.append(("raised", str(e)))
        return out, s.finish_reason

    assert run(TStream) == run(JStream)


def test_max_num_seqs_room_follows_the_reference(jparams):
    """max_num_seqs_room over one request sequence, against the
    reference's own method applied to the same engine state."""
    from ray_tpu.serve.llm.engine import LLMEngine as JEngine
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG, "cpu")
    eng = LLMEngine(tiny_cfg(max_num_seqs=3), tp, device="cpu",
                    model_cfg=TCFG, start=False)     # stepped by hand
    try:
        rooms = [eng.max_num_seqs_room()]
        streams = [eng.submit([1 + i, 2, 3], SamplingParams(max_tokens=3))
                   for i in range(4)]
        while eng.step():
            assert eng.max_num_seqs_room() == JEngine.max_num_seqs_room(eng)
            rooms.append(eng.max_num_seqs_room())
        assert rooms[:4] == [3, 2, 1, 0] and rooms[-1] == 3
        assert min(rooms) == 0
        assert [len(s.tokens()) for s in streams] == [3] * 4
    finally:
        eng.shutdown()


def test_kv_cache_accessors_match_reference():
    """used_block_count / can_alloc / has_seq / seq_ids over the same
    alloc / fork / free sequence on the port's cache and the reference's."""
    from ray_tpu.serve.llm.kv_cache import PagedKVCache as JCache
    t = PagedKVCache(num_blocks=6, n_layer=1, block_size=2, n_kv=1,
                     head_dim=4, device="cpu")
    j = JCache(num_blocks=6, n_layer=1, block_size=2, n_kv=1, head_dim=4)
    try:
        def state(c):
            return (c.used_block_count(), c.free_block_count(),
                    [c.can_alloc(n) for n in range(8)],
                    [c.has_seq(s) for s in "abcd"], sorted(c.seq_ids()))

        steps = [lambda c: c.alloc_seq("a", 3), lambda c: c.fork_seq("a", "b"),
                 lambda c: c.alloc_seq("c", 5), lambda c: c.free_seq("a"),
                 lambda c: c.append_slot("b"), lambda c: c.free_seq("b"),
                 lambda c: c.alloc_seq("d", 1), lambda c: c.free_seq("c")]
        assert state(t) == state(j)
        for step in steps:
            step(t)
            step(j)
            assert state(t) == state(j)
    finally:
        t.close()
        j.close()


# ---------------------------------------------------------- cache units
def test_kv_cache_alloc_refcount_and_pressure():
    c = PagedKVCache(num_blocks=4, n_layer=1, block_size=2, n_kv=1,
                     head_dim=4, device="cpu")
    c.alloc_seq("a", 3)                       # 2 blocks
    assert c.free_block_count() == 2
    c.fork_seq("a", "b")                      # shared, no new blocks
    assert c.free_seq("a") == 0               # still referenced by b
    assert c.free_seq("b") == 2               # last ref frees
    c.alloc_seq("c", 7)                       # 4 blocks: pool full
    with pytest.raises(NoFreeBlocks):
        c.alloc_seq("d", 1)
    blk, off, grew = c.append_slot("c")       # slot 8 fits the last block
    assert (off, grew) == (1, False)
    with pytest.raises(NoFreeBlocks):
        c.append_slot("c")
    c.free_seq("c")
    c.alloc_seq("e", 2)
    _, _, grew = c.append_slot("e")
    assert grew and c.free_block_count() == 2
    c.rollback_slot("e", grew)
    assert c.free_block_count() == 3 and c.fill("e") == 2


def test_kv_cache_device_writes_match_reference_loops():
    """scatter_prefill / write_token land where the reference's per-block
    numpy loops put them."""
    rng = np.random.default_rng(4)
    L, bs, KV, D = 2, 4, 2, 3
    c = PagedKVCache(num_blocks=8, n_layer=L, block_size=bs, n_kv=KV,
                     head_dim=D, device="cpu")
    ref = np.zeros((8, L, 2, bs, KV, D), np.float32)
    table = c.alloc_seq("s", 7)
    ks = rng.standard_normal((L, 16, KV, D)).astype(np.float32)
    vs = rng.standard_normal((L, 16, KV, D)).astype(np.float32)
    c.scatter_prefill("s", torch.from_numpy(ks), torch.from_numpy(vs), 7)
    for i, b in enumerate(table):
        lo, hi = i * bs, min(7, i * bs + bs)
        ref[b, :, 0, :hi - lo] = ks[:, lo:hi]
        ref[b, :, 1, :hi - lo] = vs[:, lo:hi]
    c.alloc_seq("t", 1)
    slots = [c.append_slot("s"), c.append_slot("t")]
    k1 = rng.standard_normal((L, 2, KV, D)).astype(np.float32)
    v1 = rng.standard_normal((L, 2, KV, D)).astype(np.float32)
    c.write_token([s[0] for s in slots], [s[1] for s in slots],
                  torch.from_numpy(k1), torch.from_numpy(v1))
    for i, (b, off, _) in enumerate(slots):
        ref[b, :, 0, off] = k1[:, i]
        ref[b, :, 1, off] = v1[:, i]
    b, off, _ = c.append_slot("t")             # one token, scalar form
    c.write_token(b, off, torch.from_numpy(k1[:, 0]),
                  torch.from_numpy(v1[:, 0]))
    ref[b, :, 0, off], ref[b, :, 1, off] = k1[:, 0], v1[:, 0]
    np.testing.assert_array_equal(c.pool.numpy(), ref)


def test_scheduler_admission_preempt_order():
    s = IterationScheduler(max_num_seqs=2, max_prefill_tokens=8,
                           max_model_len=16)
    with pytest.raises(ValueError):
        s.add(Sequence("x", list(range(9)), SamplingParams()))
    a = Sequence("a", [1, 2], SamplingParams(max_tokens=4))
    b = Sequence("b", [1, 2, 3], SamplingParams(max_tokens=4))
    s.add(a)
    s.add(b)
    assert s.plan(10, lambda n: 1).prefill is a
    s.start_running(a)
    s.start_running(b)
    b.arrival = a.arrival + 1
    assert s.victim() is b
    b.output = [7, 8]
    s.preempt(b)
    assert b.prompt[-2:] == [7, 8] and s.waiting[0] is b
    assert b.generated == 2


# ------------------------------------------------- runner and config rules
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 0),
                                               (1.3, 5)])
def test_sampling_matches_reference(temperature, top_k):
    rng = np.random.default_rng(5)
    sp = SamplingParams(temperature=temperature, top_k=top_k, seed=3)
    for step in range(4):
        logits = rng.standard_normal(300).astype(np.float32)
        assert ModelRunner.sample(logits, sp, step) == \
            JRunner.sample(logits, sp, step)


def test_entry_points_raise_without_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRunner(tiny_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(tiny_cfg())
    eng = LLMEngine(tiny_cfg(), device="cpu", start=False)
    assert eng.cache.pool.device.type == "cpu"
    assert eng.runner.params["wte"].device.type == "cpu"
    eng.shutdown()


def test_kv_cache_defaults_to_the_card(monkeypatch):
    """A pool built directly, with no device, lands on the card; with no
    card that raises rather than dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(num_blocks=2, n_layer=1, block_size=2, n_kv=1,
                     head_dim=4)
    c = PagedKVCache(num_blocks=2, n_layer=1, block_size=2, n_kv=1,
                     head_dim=4, device="cpu")
    assert c.pool.device.type == "cpu"


def test_later_slices_raise_not_implemented(shm_dir):
    """share_weights=True, the reference default, raised until the shm
    weights plane was ported: now the first runner publishes its init
    under the reference's key and a second one attaches to the same
    bytes."""
    assert EngineConfig().share_weights is True      # reference default
    cfg = tiny_cfg(share_weights=True)
    first = ModelRunner(cfg, device="cpu")
    try:
        assert first.weights_key == "gpt2_tiny_s0"
        assert os.path.exists(wmod._seg_path(first.weights_key,
                                             os.getpid()) + ".ready")
        second = ModelRunner(cfg, device="cpu")
        for (path, a), (_, b) in zip(wmod._flatten(first.params),
                                     wmod._flatten(second.params)):
            assert torch.equal(a, b), path
            assert a.data_ptr() != b.data_ptr()
    finally:
        wmod.release(first.weights_key)
    assert not list(shm_dir.iterdir())
    # llama serving is ported: the family resolves to the port's module
    mod, mcfg = resolve_model(tiny_cfg(model="llama:llama3-8b"))
    assert mod is tllama and mcfg == tllama.llama3_8b()
    mod, mcfg = resolve_model(tiny_cfg(model="llama:tiny"))
    assert mod is tllama and mcfg == tllama.tiny()


def test_engine_rejects_uncovered_buckets():
    with pytest.raises(ValueError, match="max_model_len"):
        LLMEngine(tiny_cfg(prefill_len_buckets=(16, 32)), device="cpu")
    with pytest.raises(ValueError, match="max_num_seqs"):
        LLMEngine(tiny_cfg(decode_batch_buckets=(1, 2)), device="cpu")


# ------------------------------------------------------- weights plane
@pytest.fixture
def shm_dir(monkeypatch, tmp_path):
    """The weights plane's directory, private to the test."""
    monkeypatch.setenv("RTT_SHM_DIR", str(tmp_path))
    return tmp_path


def _stamped_init(calls, stamp_offset=0.0):
    """GPT-2 tiny's init plus the call's ordinal: an attach returns the
    PUBLISHED bytes (stamp 1) while a silent re-init carries a later
    stamp.  (The attach calls it on ``meta`` for the tree's shapes, so a
    call counter alone cannot tell the paths apart.)"""
    def init_fn(device):
        calls[0] += 1
        p = tgpt2.init_params(torch.Generator().manual_seed(0), TCFG,
                              device=device)
        stamp = float(calls[0]) + stamp_offset
        return tree_map(lambda x: x + stamp, p)
    return init_fn


def test_weights_shared_through_shm_plane(shm_dir):
    """Port of the reference's stamped-init test
    (tests/test_serve_llm.py::test_weights_shared_through_shm_plane)."""
    key = f"testshare_{os.getpid()}"
    calls = [0]
    init_fn = _stamped_init(calls)
    cpu = torch.device("cpu")
    try:
        a = wmod.publish_or_attach(key, init_fn, cpu)
        b = wmod.publish_or_attach(key, init_fn, cpu)
        base = wmod._seg_path(key, os.getpid())
        assert os.path.exists(base)             # segment published
        assert calls[0] == 2                    # publish, then meta shapes
        for (path, x), (_, y) in zip(wmod._flatten(a), wmod._flatten(b)):
            assert torch.equal(x, y), path
            assert y.device == cpu and y.dtype == torch.float32
        # release() is the graceful-shutdown path; the pid-embedded name
        # makes a SIGKILLed publisher's segment reapable instead
        wmod.release(key)
        assert not os.path.exists(base)
        assert wmod._live_segment(key) is None
    finally:
        wmod.release(key)


_CHILD = """
import sys, torch
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.serve.llm import weights
import dataclasses
cfg = dataclasses.replace(gpt2.tiny(), dtype=torch.float32)

def init_fn(device):
    if device.type != "meta":
        raise RuntimeError("private init: the attach was not taken")
    return gpt2.init_params(torch.Generator(), cfg, device=device)

p = weights.publish_or_attach(sys.argv[1], init_fn, torch.device("cpu"))
torch.save({"wte": p["wte"], "mlp_in": p["blocks"]["mlp_in"]["kernel"]},
           sys.argv[2])
"""


def test_weights_attach_from_a_second_process(shm_dir):
    """A second process attaches to what this one published: its init
    refuses any device but meta, so only the attach can succeed, and it
    holds wte and a block matrix bitwise equal to the publisher's."""
    key = f"testproc_{os.getpid()}"
    calls = [0]
    try:
        pub = wmod.publish_or_attach(key, _stamped_init(calls),
                                     torch.device("cpu"))
        out = shm_dir / "child.pt"
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                              .parent.parent))
        res = subprocess.run([sys.executable, "-c", _CHILD, key, str(out)],
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stderr
        got = torch.load(out)
        assert torch.equal(got["wte"], pub["wte"])
        assert torch.equal(got["mlp_in"], pub["blocks"]["mlp_in"]["kernel"])
    finally:
        wmod.release(key)


def test_reap_orphans_and_stale_lock(shm_dir):
    """A dead publisher's segment and .ready go at the next engine boot's
    sweep; a live one's stay; a lock left by a dead pid is broken by the
    next publisher, which then publishes."""
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    live = os.getppid()
    for pid in (dead.pid, live):
        for sfx in ("", ".ready"):
            (shm_dir / f"rtt_llmw_k.{pid}{sfx}").write_bytes(b"x")
    assert wmod.reap_orphans() == 2
    assert sorted(x.name for x in shm_dir.iterdir()) == \
        [f"rtt_llmw_k.{live}", f"rtt_llmw_k.{live}.ready"]
    for x in shm_dir.iterdir():
        x.unlink()
    key = "stale"
    Path(wmod._lock_path(key)).write_text(str(dead.pid))
    calls = [0]
    try:
        wmod.publish_or_attach(key, _stamped_init(calls),
                               torch.device("cpu"), timeout_s=5.0)
        assert calls[0] == 1
        assert os.path.exists(wmod._seg_path(key, os.getpid()) + ".ready")
        assert not os.path.exists(wmod._lock_path(key))
    finally:
        wmod.release(key)


def test_attach_of_other_shapes_falls_back_with_a_warning(shm_dir, caplog):
    """A segment whose leaves do not match the model's shapes is not
    attached: the caller loads privately and says so."""
    key = f"testmismatch_{os.getpid()}"
    calls = [0]
    try:
        wmod.publish_or_attach(key, _stamped_init(calls),
                               torch.device("cpu"))
        other = dataclasses.replace(TCFG, n_embd=32)
        with caplog.at_level("WARNING", logger=wmod.logger.name):
            p = wmod.publish_or_attach(
                key, lambda d: tgpt2.init_params(torch.Generator(), other,
                                                 device=d),
                torch.device("cpu"))
        assert p["wte"].shape == (other.vocab_size, 32)
        assert "loading privately" in caplog.text
    finally:
        wmod.release(key)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("case", ["solo", "concurrent", "preemption"])
def test_engine_oracles_with_shared_weights(jparams, jlparams, shm_dir,
                                            family, case):
    """The engine oracles with share_weights=True: the JAX weights are
    published under the engine's key, and the engine, given no params,
    attaches to them (a private init would draw other weights and fail
    the oracle)."""
    jp, mcfg, model = ((jparams, TCFG, "gpt2:tiny") if family == "gpt2"
                       else (jlparams, TLCFG, "llama:tiny"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), mcfg, "cpu")
    kw = dict(PREEMPT) if case == "preemption" else {}
    cfg = tiny_cfg(model=model, share_weights=True, **kw)
    key = f"{cfg.model_key()}_s{cfg.seed}"
    wmod.publish_or_attach(key, lambda d: tp, torch.device("cpu"))
    eng = LLMEngine(cfg, device="cpu", model_cfg=mcfg)
    assert eng.runner.weights_key == key
    for (path, a), (_, b) in zip(wmod._flatten(eng.runner.params),
                                 wmod._flatten(tp)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), path
    greedy = (lambda p, n: jax_greedy(jparams, p, n)) if family == "gpt2" \
        else (lambda p, n: jax_llama_greedy(jlparams, p, n))
    vocab = 100 if family == "gpt2" else JLCFG.vocab_size
    if case == "solo":
        _solo(eng, greedy, vocab)
    elif case == "concurrent":
        _concurrent(eng, greedy, 200 if family == "gpt2" else vocab)
    else:
        _preemption(eng, greedy)
    # shutdown released the engine's segment: this process published it
    assert wmod._live_segment(key) is None


# ------------------------------------------------------ metrics and spans
def test_engine_metrics_and_spans(jparams):
    """The engine's rtt_llm_* series and its three spans: a traced
    request under cache pressure (PREEMPT) is prefilled, decoded and
    preempted, and the timeline holds llm.prefill, llm.decode_step and
    llm.preempt, each a child of the submitter's span; the token counter
    agrees with the engine's own counts."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import metrics_catalog as mcat
    from ray_tpu_torch.util import tracing

    def total(name, **tags):
        return sum(s["value"] for s in mcat.get(name).snapshot()
                   if all(s["tags"].get(k) == v for k, v in tags.items()))

    rt.init(num_cpus=1)
    try:
        before = {p: total("rtt_llm_tokens_total", model="gpt2:tiny",
                           phase=p) for p in ("prefill", "decode")}
        pre0 = total("rtt_llm_preemptions_total", model="gpt2:tiny")
        ttft0 = sum(s["value"]["count"] for s in
                    mcat.get("rtt_llm_ttft_seconds").snapshot())
        eng = make_engine(jparams, **PREEMPT)
        prompts = [[1 + 7 * i, 2, 3] for i in range(3)]
        with tracing.trace("llm-test") as root:
            streams = [eng.submit(p, SamplingParams(max_tokens=12))
                       for p in prompts]
        outs = [s.tokens() for s in streams]
        st = eng.stats()
        eng.shutdown()
        assert all(len(o) == 12 for o in outs) and st["preemptions"] >= 1
        got = {p: total("rtt_llm_tokens_total", model="gpt2:tiny",
                        phase=p) - before[p] for p in before}
        # every emitted token is a prefill's first token or a decode's
        assert got["decode"] == st["tokens_out"] - st["prefill_steps"]
        # prefills: the prompts, and each preempted context again
        assert got["prefill"] >= sum(map(len, prompts))
        assert total("rtt_llm_preemptions_total", model="gpt2:tiny") \
            - pre0 == st["preemptions"]
        assert sum(s["value"]["count"] for s in mcat.get(
            "rtt_llm_ttft_seconds").snapshot()) - ttft0 == len(prompts)
        assert {s["tags"]["state"] for s in mcat.get(
            "rtt_llm_kv_blocks").snapshot()} >= {"used", "free"}
        assert mcat.get("rtt_llm_batch_occupancy").snapshot()
        assert mcat.get("rtt_llm_tpot_seconds").snapshot()
        spans = {}
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            spans = {}
            for e in rt.timeline(trace_id=root.trace_id):
                if e.get("name", "").startswith("llm."):
                    spans.setdefault(e["name"], []).append(e)
            if len(spans) == 3:
                break
            time.sleep(0.2)
        assert set(spans) == {"llm.prefill", "llm.decode_step",
                              "llm.preempt"}, set(spans)
        ours = {root.span_id}
        assert all(e["args"]["parent_id"] in ours
                   for evs in spans.values() for e in evs)
    finally:
        rt.shutdown()


# ---------------------------------------------------- serve integration
@pytest.fixture(scope="module")
def serve_llm_cluster(tmp_path_factory):
    """One cluster for the Serve tests below, its object store and the
    weights plane in a directory of its own (never /dev/shm): workers
    take the store's directory from the GCS, the driver's weights plane
    reads RTT_SHM_DIR.  Restores the package logger as it was."""
    import logging

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import rtlog, shm_store
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    d = tmp_path_factory.mktemp("serve_llm_shm")
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


def _toks(chunks):
    return [int(x.strip()) for x in chunks]


def test_serve_llm_streaming_and_stats(serve_llm_cluster):
    """Mirror of the reference's test: streams through the handle, four
    concurrent requests alike, the engine's stats, the HTTP chunked
    path; the replica's engine built on the CPU (``device="cpu"``)."""
    import json
    import urllib.request

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_deployment
    app = llm_deployment(tiny_cfg(share_weights=True), device="cpu").bind()
    h = serve.run(app, name="llm", route_prefix="/llm")
    req = {"prompt": [4, 8, 15], "max_tokens": 6}
    toks = _toks(h.remote(req).result())
    assert len(toks) == 6
    rs = [h.remote(req) for _ in range(4)]
    outs = [_toks(r.result()) for r in rs]
    assert all(o == toks for o in outs)
    st = h.engine_stats.remote().result()
    assert st["prefill_steps"] >= 5 and st["tokens_out"] >= 30
    assert "kv_segment" not in st       # the KV pool lives on the device
    addr = serve.get_http_address()
    r = urllib.request.urlopen(urllib.request.Request(
        f"http://{addr[0]}:{addr[1]}/llm",
        data=json.dumps(req).encode(), method="POST"), timeout=120)
    assert [int(x) for x in r.read().decode().split()] == toks
    serve.delete("llm")


def test_serve_llm_multiplexed_models(serve_llm_cluster):
    """Mirror: one deployment serves two model families, picked per
    request through @serve.multiplexed."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_deployment
    h = serve.run(llm_deployment(tiny_cfg(), device="cpu").bind(),
                  name="llmx", route_prefix="/llmx")
    req = {"prompt": [3, 5, 7], "max_tokens": 5}
    base = _toks(h.remote(req).result())
    other = _toks(h.options(multiplexed_model_id="llama:tiny")
                  .remote(req).result())
    assert len(base) == len(other) == 5
    assert base != other        # different family actually served
    serve.delete("llmx")


def test_naive_baseline_serves(serve_llm_cluster):
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import naive_llm_deployment
    h = serve.run(naive_llm_deployment(tiny_cfg(), device="cpu").bind(),
                  name="llmnaive", route_prefix="/llmnaive")
    req = {"prompt": [4, 8, 15], "max_tokens": 6}
    assert len(_toks(h.remote(req).result())) == 6
    serve.delete("llmnaive")


def test_llm_deployment_streams_the_jax_engines_tokens(
        jparams, serve_llm_cluster, monkeypatch):
    """llm_deployment on gpt2:tiny with the JAX init's weights (published
    by this process through the weights plane; the replica's engine,
    given no params, attaches them) streams exactly the greedy tokens of
    the JAX package's LLMEngine on the same weights, concurrent requests
    included.  Both sides in float32 (the JAX engine's model config is
    swapped for JCFG here)."""
    from ray_tpu.serve.llm import EngineConfig as JEngineConfig
    from ray_tpu.serve.llm import LLMEngine as JLLMEngine
    from ray_tpu.serve.llm import SamplingParams as JSamplingParams
    from ray_tpu.serve.llm import model_runner as jrunner
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_deployment

    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 200, int(n)).tolist()
               for n in rng.integers(3, 20, 5)]
    monkeypatch.setattr(jrunner, "resolve_model", lambda cfg: (jgpt2, JCFG))
    fields = {f.name: getattr(tiny_cfg(), f.name)
              for f in dataclasses.fields(tiny_cfg())}
    jeng = JLLMEngine(JEngineConfig(**fields), params=jparams)
    try:
        want = [s.tokens() for s in [jeng.submit(p, JSamplingParams(
            max_tokens=8)) for p in prompts]]
    finally:
        jeng.shutdown()
    assert len({t for o in want for t in o}) > 8    # not one repeated

    cfg = tiny_cfg(share_weights=True, seed=7)
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG, "cpu")
    key = f"{cfg.model_key()}_s{cfg.seed}"
    wmod.publish_or_attach(key, lambda d: tp, torch.device("cpu"))
    try:
        h = serve.run(llm_deployment(cfg, device="cpu", model_cfg=TCFG)
                      .bind(), name="parity", route_prefix=None)
        rs = [h.remote({"prompt": p, "max_tokens": 8}) for p in prompts]
        assert [_toks(r.result()) for r in rs] == want
        serve.delete("parity")
    finally:
        wmod.release(key)


def test_chaos_sigkill_decode_replica_no_leaked_kv(serve_llm_cluster):
    """Mirror of the reference's chaos case: SIGKILL the replica mid-
    generation.  The in-flight stream fails cleanly (RayServeError, not a
    hang), the controller replaces the replica and new traffic flows.
    The port's KV pool lives on the device and dies with the process, so
    what must not leak is the process and its files: the killed worker
    is gone, and its weights segment in the shm directory is reaped by
    the new replica's engine at boot."""
    import signal

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_deployment
    shm = serve_llm_cluster
    app = llm_deployment(tiny_cfg(share_weights=True, seed=3),
                         device="cpu").bind()
    h = serve.run(app, name="llmchaos", route_prefix="/llmchaos")
    assert len(list(h.remote({"prompt": [1, 2], "max_tokens": 2})
                    .result())) == 2
    victim_pid = h.engine_stats.remote().result()["pid"]
    def its_files():          # rtt_llmw_<key>.<pid>[.ready]
        return [n for n in os.listdir(shm)
                if n.split(".")[1:2] == [str(victim_pid)]]

    assert its_files(), os.listdir(shm)     # its published weights
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
            out = _toks(h.remote({"prompt": [1, 2], "max_tokens": 3})
                        .result(timeout_s=30))
            if len(out) == 3:
                break
        except Exception:  # noqa: BLE001 - replica still restarting
            time.sleep(0.5)
    assert out is not None and len(out) == 3, out
    assert h.engine_stats.remote().result()["pid"] != victim_pid
    with pytest.raises(ProcessLookupError):
        os.kill(victim_pid, 0)
    assert not its_files(), f"the killed replica's files leaked: " \
        f"{its_files()}"
    serve.delete("llmchaos")
