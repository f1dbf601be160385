"""The port's Serve (``ray_tpu_torch.serve``) on its own runtime, held to
the reference's ``tests/test_serve.py`` and to what the card adds.

The reference's nine tests run against the port unchanged in substance
(HTTP and handle, errors, composition, load spread, ``@serve.batch``,
autoscaling, redeploy, streaming, replica death).  Then what the port
adds: a tiny BERT deployment whose logits match the JAX package's
``bert.classify`` (float32, 1e-4 of the largest logit: sums in other
orders), ``num_gpus`` replicas in GPU worker processes, and the
deployments the cluster can never place or start failing with messages
that name what is missing.

Most tests share one cluster of 8 CPUs (``serve_cluster``, restarted if a
test with a cluster of its own ran in between); each ends with
``serve.shutdown()``.  Deployment classes are defined inside the tests
and this module is pickled by value, so replicas never import JAX.
"""

import json
import logging
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from conftest import time_scale
from ray_tpu_torch import serve
from ray_tpu_torch._private import rtlog

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _stop():
    if rt.is_initialized():
        serve.shutdown()
        rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def _shared():
    """Stops the module's last cluster and hands later modules the
    package logger as it was (``init`` configures it for the process)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    yield
    _stop()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


@pytest.fixture
def serve_cluster(_shared):
    if rt.is_initialized() and rt.cluster_resources().get("GPU"):
        _stop()                   # a GPU test's cluster: not the shared one
    if not rt.is_initialized():
        rt.init(num_cpus=8)
    yield
    serve.shutdown()


@pytest.fixture
def gpu_cluster(_shared):
    """A cluster of its own with one (fake) card and room for two GPU
    worker processes on it."""
    _stop()
    rt.init(num_cpus=4, num_gpus=1,
            _system_config={"gpu_workers_per_node": 2})
    yield
    _stop()
    # the override outlives the cluster: later clusters in this process
    # (another module's, under xdist) must get the default pool
    GLOBAL_CONFIG.reset()


def _http(method, url, body=None, timeout=30):
    req = urllib.request.Request(url, data=body, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _base_url():
    host, port = serve.get_http_address()
    return f"http://{host}:{port}"


# ------------------------------------------- the reference's test_serve.py
def test_http_ingress_and_handle(serve_cluster):
    @serve.deployment
    class Echo:
        def __call__(self, request):
            if isinstance(request, serve.Request):
                return {"path": request.path, "q": request.query_params,
                        "body": request.text()}
            return {"direct": request}

        def add(self, a, b):
            return a + b

    handle = serve.run(Echo.bind(), route_prefix="/echo")
    assert handle.remote("hi").result()["direct"] == "hi"
    assert handle.add.remote(2, 3).result() == 5
    status, body = _http("POST", _base_url() + "/echo/sub?x=1", b"payload")
    assert status == 200
    out = json.loads(body)
    assert out["path"] == "/sub" and out["q"] == {"x": "1"}
    assert out["body"] == "payload"
    status, body = _http("GET", _base_url() + "/-/routes")
    assert status == 200 and json.loads(body) == {"/echo": "default#Echo"}


def test_404_and_errors(serve_cluster):
    @serve.deployment
    class Boom:
        def __call__(self, request):
            raise ValueError("kaboom")

    serve.run(Boom.bind(), route_prefix="/boom")
    with pytest.raises(urllib.error.HTTPError) as e:
        _http("GET", _base_url() + "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _http("GET", _base_url() + "/boom")
    assert e.value.code == 500
    assert "kaboom" in e.value.read().decode()


def test_function_deployment_and_composition(serve_cluster):
    @serve.deployment
    def doubler(x):
        return 2 * x

    @serve.deployment
    class Gateway:
        def __init__(self, inner):
            self.inner = inner

        def __call__(self, request):
            x = int(request.query_params.get("x", "0")) \
                if isinstance(request, serve.Request) else int(request)
            return self.inner.remote(x).result()

    handle = serve.run(Gateway.bind(doubler.bind()), route_prefix="/")
    assert handle.remote(21).result() == 42
    status, body = _http("GET", _base_url() + "/?x=5")
    assert status == 200 and json.loads(body) == 10


def test_multiple_replicas_spread_load(serve_cluster):
    @serve.deployment(num_replicas=2, max_ongoing_requests=4)
    class Who:
        def __init__(self):
            import os
            self.pid = os.getpid()

        def __call__(self, request):
            time.sleep(0.05)
            return self.pid

    handle = serve.run(Who.bind(), route_prefix="/who")
    resps = [handle.remote(None) for _ in range(16)]
    pids = {r.result() for r in resps}
    assert len(pids) == 2


def test_serve_batch(serve_cluster):
    @serve.deployment
    class Batcher:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        async def __call__(self, items):
            self.batch_sizes.append(len(items))
            return [i * 10 for i in items]

        def sizes(self):
            return self.batch_sizes

    handle = serve.run(Batcher.bind(), route_prefix=None)
    resps = [handle.remote(i) for i in range(8)]
    assert sorted(r.result() for r in resps) == [i * 10 for i in range(8)]
    assert max(handle.sizes.remote().result()) > 1


def test_autoscaling_up_and_down(serve_cluster):
    @serve.deployment(
        max_ongoing_requests=2,
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=1, max_replicas=3, target_ongoing_requests=1,
            upscale_delay_s=0.2, downscale_delay_s=0.5),
    )
    class Slow:
        def __call__(self, request):
            time.sleep(0.3)
            return "ok"

    handle = serve.run(Slow.bind(), route_prefix=None)
    key = "default#Slow"
    assert serve.status()[key]["target"] == 1

    stop = threading.Event()

    def pound():
        while not stop.is_set():
            try:
                handle.remote(None).result(timeout_s=30)
            except Exception:
                return

    threads = [threading.Thread(target=pound, daemon=True) for _ in range(6)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30 * time_scale()
    while time.monotonic() < deadline:
        if serve.status()[key]["target"] >= 2:
            break
        time.sleep(0.2)
    assert serve.status()[key]["target"] >= 2, serve.status()
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    deadline = time.monotonic() + 30 * time_scale()
    while time.monotonic() < deadline:
        if serve.status()[key]["target"] == 1:
            break
        time.sleep(0.2)
    assert serve.status()[key]["target"] == 1, serve.status()


def test_redeploy_and_delete(serve_cluster):
    @serve.deployment
    class V:
        def __init__(self, version):
            self.v = version

        def __call__(self, request):
            return self.v

    handle = serve.run(V.bind(1), route_prefix="/v")
    assert handle.remote(None).result() == 1
    handle = serve.run(V.bind(2), route_prefix="/v")
    deadline = time.monotonic() + 20 * time_scale()
    while time.monotonic() < deadline:
        if handle.remote(None).result() == 2:
            break
        time.sleep(0.2)
    assert handle.remote(None).result() == 2
    serve.delete("default")
    assert serve.status() == {}


def test_streaming_response_handle_and_http(serve_cluster):
    @serve.deployment
    class Tokens:
        def stream(self, n):
            for i in range(n):
                yield f"tok{i} "

        def __call__(self, request):
            return serve.StreamingResponse(
                (f"c{i}|" for i in range(5)), content_type="text/plain")

    handle = serve.run(Tokens.bind(), route_prefix="/stream")
    got = list(handle.stream.remote(4).result())
    assert got == ["tok0 ", "tok1 ", "tok2 ", "tok3 "]
    status, body = _http("GET", _base_url() + "/stream")
    assert status == 200
    assert body.decode() == "c0|c1|c2|c3|c4|"


def test_replica_death_recovery(serve_cluster):
    @serve.deployment(num_replicas=2, health_check_period_s=0.3)
    class Echo:
        def __call__(self, x):
            return x

    h = serve.run(Echo.bind(), route_prefix="/rk", name="rk")
    assert h.remote(1).result() == 1
    ctrl = rt.get_actor("SERVE_CONTROLLER")
    key = next(k for k in rt.get(ctrl.status.remote()) if k == "rk#Echo")
    tg = rt.get(ctrl.get_deployment_targets.remote(key))
    victim = next(iter(tg["replicas"].values()))
    rt.kill(rt.get_actor(victim), no_restart=True)
    deadline = time.monotonic() + 60 * time_scale()
    while time.monotonic() < deadline:
        st = rt.get(ctrl.status.remote())[key]
        tg = rt.get(ctrl.get_deployment_targets.remote(key))
        if st["ready"] >= 2 and victim not in tg["replicas"].values():
            break
        time.sleep(0.2)
    else:
        raise AssertionError(
            f"replica not replaced: {st} {tg['replicas']}")
    deadline = time.monotonic() + 30 * time_scale()
    while True:
        try:
            assert h.remote(7).result() == 7
            break
        except (rt.exceptions.RayActorError, rt.exceptions.RayServeError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


# ----------------------------------------------------- what the port adds
def test_tiny_bert_deployment_matches_jax_classify(serve_cluster):
    """A BERT deployment in the port (weights: the JAX init of ``tiny``
    with its zero cls head redrawn, carried by ``params_from_numpy``)
    answers handle and HTTP requests with the JAX package's
    ``bert.classify`` logits on the same ids, within 1e-4 of the largest
    logit (float32 both sides).  The JAX side runs here; the replica
    builds its model on the CPU and never imports JAX."""
    from ray_tpu.models import bert as jbert
    import dataclasses
    jcfg = dataclasses.replace(jbert.tiny(), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jax.jit(
        jbert.init_params, static_argnums=1)(jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    for k in ("kernel", "bias"):
        tree["cls"][k] = (0.5 * rng.standard_normal(tree["cls"][k].shape)) \
            .astype(np.float32)
    ids = rng.integers(0, jcfg.vocab_size, (6, 16)).astype(np.int32)
    ref = np.asarray(jax.jit(jbert.classify, static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jcfg))

    @serve.deployment(max_ongoing_requests=4)
    class TinyBert:
        def __init__(self, tree):
            import dataclasses
            import sys
            import torch
            from ray_tpu_torch.models import bert
            from ray_tpu_torch.models.convert import params_from_numpy
            self.jax_loaded = "jax" in sys.modules
            self.cfg = dataclasses.replace(bert.tiny(), dtype=torch.float32)
            self.params = params_from_numpy(tree, self.cfg, "cpu")

        def __call__(self, request):
            import numpy as np
            import torch
            from ray_tpu_torch.models import bert
            ids = request.json()["ids"] if isinstance(
                request, serve.Request) else request
            with torch.no_grad():
                out = bert.classify(self.params, torch.as_tensor(
                    np.asarray(ids, np.int64))[None], self.cfg)
            return out[0].tolist()

        def imports_jax(self):
            import sys
            return self.jax_loaded or "jax" in sys.modules

    h = serve.run(TinyBert.bind(tree), route_prefix="/bert")
    got = np.array([r.result() for r in [h.remote(row.tolist())
                                         for row in ids]], np.float32)
    tol = 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    status, body = _http("POST", _base_url() + "/bert",
                         json.dumps({"ids": ids[0].tolist()}).encode())
    assert status == 200
    np.testing.assert_allclose(json.loads(body), ref[0], rtol=0, atol=tol)
    assert h.imports_jax.remote().result() is False


def test_replicas_start_side_by_side_and_the_controller_answers(
        serve_cluster):
    """A replica's ``__init__`` (a model's load on the card) never holds
    the controller: three replicas that take 4 s each to build are all
    starting at once, and status() answers within 2 s all along (it
    waited on each ``__init__`` in turn under the controller's lock)."""
    @serve.deployment(num_replicas=3)
    class SlowInit:
        def __init__(self):
            time.sleep(4.0)

        def __call__(self, x):
            return x

    out = {}

    def deploy():
        out["h"] = serve.run(SlowInit.bind(), name="slow", route_prefix=None)

    t = threading.Thread(target=deploy)
    t.start()
    together = None
    deadline = time.monotonic() + 60 * time_scale()
    while together is None and time.monotonic() < deadline:
        t1 = time.monotonic()
        st = serve.status().get("slow#SlowInit")
        assert time.monotonic() - t1 < 2.0 * time_scale()
        if st is not None and st["starting"] == 3:
            together = st
        time.sleep(0.05)
    assert together is not None, "three replicas were never starting at once"
    t.join(timeout=120)
    assert not t.is_alive()
    assert serve.status()["slow#SlowInit"]["ready"] == 3
    assert out["h"].remote(5).result() == 5


def test_num_gpus_deployment_without_gpu_fails_naming_it(serve_cluster):
    """A cluster with no "GPU" can never place a num_gpus replica:
    serve.run raises at once with the resource's name, and status()
    carries the same message (no replica is started)."""
    assert "GPU" not in rt.cluster_resources()

    @serve.deployment(ray_actor_options={"num_gpus": 0.25})
    class OnCard:
        def __call__(self, x):
            return x

    t0 = time.monotonic()
    with pytest.raises(rt.exceptions.RayServeError, match="'GPU'"):
        serve.run(OnCard.bind(), name="oncard", route_prefix=None)
    assert time.monotonic() - t0 < 30 * time_scale()
    st = serve.status()["oncard#OnCard"]
    assert st["failed"] and "'GPU'" in st["message"]
    assert st["ready"] == st["starting"] == 0


def test_gpu_replicas_beyond_gpu_workers_per_node_fail_naming_it(
        gpu_cluster):
    """Every GPU replica is a GPU worker process of its own: three of
    them where the cluster spawns two fail at deploy with the flag's
    name; two of them serve, each in a GPU worker that sees the card,
    and a replica without num_gpus runs in a plain worker that sees
    none."""
    @serve.deployment(num_replicas=3,
                      ray_actor_options={"num_gpus": 0.25})
    class Three:
        def __call__(self, x):
            return x

    with pytest.raises(rt.exceptions.RayServeError,
                       match="gpu_workers_per_node"):
        serve.run(Three.bind(), name="three", route_prefix=None)
    st = serve.status()["three#Three"]
    assert st["failed"] and "gpu_workers_per_node" in st["message"]
    serve.delete("three")

    @serve.deployment(num_replicas=2, ray_actor_options={"num_gpus": 0.5})
    class Sees:
        def __call__(self, _):
            import os
            return (os.getpid(), os.environ.get("RTT_GPU_WORKER"),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

    h = serve.run(Sees.bind(), name="sees", route_prefix=None)
    views = set()
    deadline = time.monotonic() + 30 * time_scale()
    while len(views) < 2 and time.monotonic() < deadline:
        views |= {r.result() for r in [h.remote(0) for _ in range(8)]}
    assert len(views) == 2, views
    assert {v[1:] for v in views} == {("1", "0")}
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    plain = serve.run(Sees.options(
        num_replicas=1, ray_actor_options={}).bind(), name="plain",
        route_prefix=None)
    assert plain.remote(0).result()[1:] == (None, "")


def test_model_built_for_the_card_without_num_gpus_reports_it(
        serve_cluster):
    """A replica without num_gpus runs in a plain worker, which sees no
    card: a model built for cuda raises from resolve_device there, the
    deployment never becomes ready, and serve.run reports the error after
    the controller's bounded restarts instead of serving from the CPU."""
    @serve.deployment
    class NeedsCard:
        def __init__(self):
            from ray_tpu_torch._device import resolve_device
            self.dev = resolve_device(None)

        def __call__(self, x):
            return x

    with pytest.raises(rt.exceptions.RayServeError,
                       match="no CUDA device") as ei:
        serve.run(NeedsCard.bind(), name="needs", route_prefix=None,
                  _wait_timeout_s=120 * time_scale())
    assert "deployment failed" in str(ei.value)
    st = serve.status()["needs#NeedsCard"]
    assert st["failed"] and st["ready"] == 0


def test_grpc_options_without_grpcio_name_the_package(serve_cluster,
                                                      monkeypatch):
    """The gRPC proxy imports grpc inside its actor; without the package
    serve.start fails at once, naming it."""
    import importlib.util
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "grpc"
                        else real(name, *a))
    with pytest.raises(ImportError, match="grpcio"):
        serve.start(grpc_options=serve.gRPCOptions(port=0))


def test_serve_control_plane_import_leaves_torch_out():
    """The controller and the proxies are plain workers: importing
    ``ray_tpu_torch.serve`` (what they unpickle) imports neither torch
    nor JAX; only a replica's model does."""
    import subprocess
    out = subprocess.run(
        [sys.executable, "-c", "import sys, ray_tpu_torch.serve; "
         "print('torch' in sys.modules, 'jax' in sys.modules)"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
