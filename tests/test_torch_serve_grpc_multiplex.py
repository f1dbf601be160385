"""The port's gRPC ingress, model multiplexing, ``@serve.ingress`` and
``DAGDriver`` (``ray_tpu_torch.serve``), held to the reference's
``tests/test_serve_grpc_multiplex.py``: its 13 tests against the port on
one shared cluster, the gRPC ones skipped where ``grpcio`` is missing.
Then what the port adds: an engine the multiplex LRU evicts runs its
``__serve_unload__``.

Deployment classes are defined inside the tests and this module is
pickled by value, so replicas never import JAX.
"""

import logging
import os
import sys

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._private import rtlog

os.environ.setdefault("RTT_OBJECT_STORE_MEMORY_MB", "256")
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(scope="module", autouse=True)
def _shared():
    """Stops the module's cluster and hands later modules the package
    logger as it was (``init`` configures it for the process)."""
    log = logging.getLogger("ray_tpu_torch")
    handlers, propagate, level = log.handlers[:], log.propagate, log.level
    yield
    if rt.is_initialized():
        serve.shutdown()
        rt.shutdown()
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.propagate, log.level = propagate, level
    rtlog._stream_configured = False
    rtlog._file_handlers.clear()


@pytest.fixture
def serve_cluster(_shared):
    if not rt.is_initialized():
        rt.init(num_cpus=8)
    yield
    serve.shutdown()


# ------------------------------------------------------------- multiplexing

def test_multiplexed_lru_and_model_id(serve_cluster):
    @serve.deployment(num_replicas=1)
    class Multi:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id}

        async def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            model = await self.get_model(mid)
            return {"model": model["id"], "x": x, "loads": list(self.loads)}

    h = serve.run(Multi.bind(), route_prefix="/multi", name="multi")
    r1 = h.options(multiplexed_model_id="a").remote(1).result()
    assert r1["model"] == "a" and r1["loads"] == ["a"]
    # cache hit: no second load of "a"
    r2 = h.options(multiplexed_model_id="a").remote(2).result()
    assert r2["loads"] == ["a"]
    # fill to capacity, then evict the LRU ("a" is older than "b")
    h.options(multiplexed_model_id="b").remote(3).result()
    r4 = h.options(multiplexed_model_id="c").remote(4).result()
    assert r4["loads"] == ["a", "b", "c"]
    r5 = h.options(multiplexed_model_id="a").remote(5).result()
    assert r5["loads"] == ["a", "b", "c", "a"]   # "a" was evicted, reloads


def test_multiplexed_affinity_routing(serve_cluster):
    @serve.deployment(num_replicas=3)
    class Which:
        def __init__(self):
            import uuid
            self.tag = uuid.uuid4().hex[:6]

        @serve.multiplexed(max_num_models_per_replica=4)
        async def get_model(self, model_id: str):
            return model_id

        async def __call__(self, _):
            await self.get_model(serve.get_multiplexed_model_id())
            return self.tag

    h = serve.run(Which.bind(), route_prefix="/w", name="w")
    # same model id keeps landing on the same replica
    tags = {h.options(multiplexed_model_id="m1").remote(0).result()
            for _ in range(8)}
    assert len(tags) == 1, tags
    # a different model id may pick a different replica, and also sticks
    tags2 = {h.options(multiplexed_model_id="m2").remote(0).result()
             for _ in range(8)}
    assert len(tags2) == 1, tags2


def test_multiplexed_http_header(serve_cluster):
    import json
    import urllib.request

    @serve.deployment(num_replicas=1)
    class M:
        @serve.multiplexed()
        async def get_model(self, model_id: str):
            return model_id

        async def __call__(self, request):
            mid = serve.get_multiplexed_model_id()
            await self.get_model(mid)
            return {"served": mid}

    serve.run(M.bind(), route_prefix="/m", name="m")
    host, port = serve.get_http_address()
    req = urllib.request.Request(
        f"http://{host}:{port}/m", data=b"{}", method="POST",
        headers={"serve_multiplexed_model_id": "ckpt-9"})
    with urllib.request.urlopen(req, timeout=30) as r:
        body = json.loads(r.read())
    assert body["served"] == "ckpt-9"


# ------------------------------------------------------------------- gRPC

def _grpc_call(addr, method, payload, metadata=None, timeout=30):
    import grpc
    with grpc.insecure_channel(f"{addr[0]}:{addr[1]}") as ch:
        fn = ch.unary_unary(method,
                            request_serializer=None,
                            response_deserializer=None)
        return fn(payload, metadata=metadata or [], timeout=timeout)


def test_grpc_ingress_bytes_and_methods(serve_cluster):
    pytest.importorskip("grpc")
    @serve.deployment(num_replicas=1)
    class Svc:
        def __call__(self, data: bytes):
            return b"echo:" + data

        def Upper(self, data: bytes):
            return data.decode().upper()

    serve.run(Svc.bind(), route_prefix="/svc", name="app1",
              grpc_options=serve.gRPCOptions(port=0))
    addr = serve.get_grpc_address()
    assert addr is not None
    # default method -> __call__, raw bytes round-trip
    out = _grpc_call(addr, "/user.Svc/Predict2", b"hi",
                     metadata=[("application", "app1")])
    # Predict2 is not defined on the class -> falls to __call__
    assert out == b"echo:hi"
    # named method dispatch
    out = _grpc_call(addr, "/user.Svc/Upper", b"abc",
                     metadata=[("application", "app1")])
    assert out == b"ABC"
    # single app: metadata optional
    out = _grpc_call(addr, "/user.Svc/Upper", b"xy")
    assert out == b"XY"


def test_grpc_pickle_codec_and_multiplex(serve_cluster):
    pytest.importorskip("grpc")
    import pickle

    @serve.deployment(num_replicas=1)
    class P:
        @serve.multiplexed()
        async def get_model(self, model_id: str):
            return model_id

        async def __call__(self, obj):
            mid = serve.get_multiplexed_model_id()
            await self.get_model(mid)
            return {"sum": sum(obj), "model": mid}

    serve.run(P.bind(), route_prefix="/p", name="papp",
              grpc_options=serve.gRPCOptions(port=0, allow_pickle=True))
    addr = serve.get_grpc_address()
    out = _grpc_call(addr, "/user.P/__call__", pickle.dumps([1, 2, 3]),
                     metadata=[("application", "papp"),
                               ("serve-codec", "pickle"),
                               ("multiplexed_model_id", "mx")])
    assert pickle.loads(out) == {"sum": 6, "model": "mx"}


def test_grpc_pickle_codec_disabled_by_default(serve_cluster):
    """pickle.loads on caller bytes is code execution — the codec must be
    rejected unless the server opted in (r4 advisor, medium)."""
    grpc = pytest.importorskip("grpc")
    import pickle

    @serve.deployment(num_replicas=1)
    class Q:
        def __call__(self, obj):
            return obj

    serve.run(Q.bind(), route_prefix="/q", name="qapp",
              grpc_options=serve.gRPCOptions(port=0))
    addr = serve.get_grpc_address()
    with pytest.raises(grpc.RpcError) as ei:
        _grpc_call(addr, "/user.Q/__call__", pickle.dumps([1]),
                   metadata=[("application", "qapp"),
                             ("serve-codec", "pickle")])
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "allow_pickle" in ei.value.details()
    # the bytes codec still works on the same proxy
    out = _grpc_call(addr, "/user.Q/__call__", b"raw",
                     metadata=[("application", "qapp")])
    assert out == b"raw"


def test_grpc_streaming_rejected_unimplemented(serve_cluster):
    """Streaming results cannot ride a unary gRPC response: expect
    UNIMPLEMENTED and the replica-side stream entry to be freed (r4
    advisor, low)."""
    grpc = pytest.importorskip("grpc")

    @serve.deployment(num_replicas=1)
    class St:
        def __call__(self, _):
            def gen():
                yield b"a"
                yield b"b"
            return gen()

    serve.run(St.bind(), route_prefix="/st", name="stapp",
              grpc_options=serve.gRPCOptions(port=0))
    addr = serve.get_grpc_address()
    with pytest.raises(grpc.RpcError) as ei:
        _grpc_call(addr, "/user.St/__call__", b"x",
                   metadata=[("application", "stapp")])
    assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED
    # HTTP/handle streaming still works against the same deployment
    h = serve.get_deployment_handle("St", "stapp")
    assert list(h.remote(0).result()) == [b"a", b"b"]


def test_grpc_unknown_app_errors(serve_cluster):
    grpc = pytest.importorskip("grpc")

    @serve.deployment(num_replicas=1)
    class A:
        def __call__(self, b):
            return b

    serve.run(A.bind(), route_prefix="/a", name="a1",
              grpc_options=serve.gRPCOptions(port=0))
    serve.run(A.bind(), route_prefix="/b", name="a2")
    addr = serve.get_grpc_address()
    with pytest.raises(grpc.RpcError) as ei:
        _grpc_call(addr, "/user.A/__call__", b"x",
                   metadata=[("application", "nope")])
    assert ei.value.code() == grpc.StatusCode.NOT_FOUND


def test_multiplexed_id_inside_streaming_generator(serve_cluster):
    """Generator bodies execute during stream pulls, not at call time —
    the model id must be re-established around each pull (r4 review
    fix)."""
    @serve.deployment(num_replicas=1)
    class S:
        def __call__(self, _):
            def gen():
                for i in range(3):
                    yield f"{serve.get_multiplexed_model_id()}:{i}"
            return gen()

    h = serve.run(S.bind(), route_prefix="/s", name="s")
    chunks = list(h.options(multiplexed_model_id="g7").remote(0).result())
    assert chunks == ["g7:0", "g7:1", "g7:2"]


# -------------------------------------------------- @serve.ingress (r5)

def test_ingress_routes_http_methods(serve_cluster):
    """FastAPI-style routing (serve/ingress.py): path params, query
    params, request body, 404s — plus the methods stay handle-callable."""
    import json
    import urllib.error
    import urllib.request

    app = serve.HTTPApp()

    @serve.deployment
    @serve.ingress(app)
    class Api:
        def __init__(self):
            self.items = {}

        @app.get("/items/{item_id}")
        def get_item(self, item_id: str):
            return {"id": item_id, "val": self.items.get(item_id)}

        @app.post("/items/{item_id}")
        def put_item(self, item_id: str, request):
            self.items[item_id] = request.json()["val"]
            return {"stored": item_id}

        @app.get("/search")
        def search(self, q="none"):
            return {"q": q}

    serve.run(Api.bind(), route_prefix="/api", name="api")
    host, port = serve.get_http_address()
    base = f"http://{host}:{port}/api"

    req = urllib.request.Request(f"{base}/items/k1", method="POST",
                                 data=json.dumps({"val": 7}).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read())["stored"] == "k1"
    with urllib.request.urlopen(f"{base}/items/k1", timeout=30) as r:
        assert json.loads(r.read()) == {"id": "k1", "val": 7}
    with urllib.request.urlopen(f"{base}/search?q=zz", timeout=30) as r:
        assert json.loads(r.read()) == {"q": "zz"}
    with urllib.request.urlopen(f"{base}/search", timeout=30) as r:
        assert json.loads(r.read()) == {"q": "none"}
    try:
        urllib.request.urlopen(f"{base}/nope", timeout=30)
        raise AssertionError("404 expected")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    # non-HTTP access to the same deployment: direct method via handle
    h = serve.get_deployment_handle("Api", "api")
    assert h.get_item.remote("k1").result() == {"id": "k1", "val": 7}


def test_ingress_composes_with_dag_bind(serve_cluster):
    """The ingress class composes in the bind/DAG graph like any other
    deployment (reference: DAG + ingress in one app)."""
    import json
    import urllib.request

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

    app = serve.HTTPApp()

    @serve.deployment
    @serve.ingress(app)
    class Front:
        def __init__(self, doubler):
            self.doubler = doubler

        @app.get("/double/{n}")
        def double(self, n):
            return {"doubled": self.doubler.remote(int(n)).result()}

    serve.run(Front.bind(Doubler.bind()), route_prefix="/c", name="comp")
    host, port = serve.get_http_address()
    with urllib.request.urlopen(
            f"http://{host}:{port}/c/double/21", timeout=30) as r:
        assert json.loads(r.read()) == {"doubled": 42}


def test_ingress_async_handler_and_percent_decoding(serve_cluster):
    """r5 review fixes: async route handlers are driven to completion,
    and path params arrive percent-DECODED (query params already do)."""
    import json
    import urllib.request

    app = serve.HTTPApp()

    @serve.deployment
    @serve.ingress(app)
    class A:
        @app.get("/echo/{name}")
        async def echo(self, name, request):
            return {"name": name, "q": request.query_params.get("q")}

    serve.run(A.bind(), route_prefix="/ad", name="ad")
    host, port = serve.get_http_address()
    with urllib.request.urlopen(
            f"http://{host}:{port}/ad/echo/a%20b?q=c%20d", timeout=30) as r:
        assert json.loads(r.read()) == {"name": "a b", "q": "c d"}


def test_dag_driver_routes_and_predict(serve_cluster):
    """DAGDriver (serve/drivers.py): one ingress fronting several bound
    sub-graphs — longest-prefix HTTP routing with prefix stripping, plus
    the non-HTTP predict(route, ...) contract."""
    import json
    import urllib.error
    import urllib.request

    @serve.deployment
    class Adder:
        def __call__(self, request_or_x):
            x = (request_or_x.json()["x"]
                 if hasattr(request_or_x, "json") else request_or_x)
            return {"sum": x + 1}

    @serve.deployment
    class Doubler:
        def __call__(self, request_or_x):
            x = (request_or_x.json()["x"]
                 if hasattr(request_or_x, "json") else request_or_x)
            return {"doubled": x * 2}

    from ray_tpu_torch.serve import DAGDriver
    serve.run(DAGDriver.bind({"/add": Adder.bind(),
                              "/double": Doubler.bind()}),
              route_prefix="/g", name="graph")
    host, port = serve.get_http_address()
    base = f"http://{host}:{port}/g"

    req = urllib.request.Request(f"{base}/add", method="POST",
                                 data=json.dumps({"x": 4}).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read()) == {"sum": 5}
    req = urllib.request.Request(f"{base}/double/extra", method="POST",
                                 data=json.dumps({"x": 4}).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read()) == {"doubled": 8}
    try:
        urllib.request.urlopen(f"{base}/nope", timeout=30)
        raise AssertionError("404 expected")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    # non-HTTP: predict through a handle
    h = serve.get_deployment_handle("DAGDriver", "graph")
    assert h.predict.remote("/add", 10).result() == {"sum": 11}
    assert h.predict.remote("double", 10).result() == {"doubled": 20}


# ------------------------------------------------------- what the port adds
def test_multiplex_eviction_runs_the_unload_hook():
    """An engine the LRU evicts runs its ``__serve_unload__`` (awaited
    when it is a coroutine, as the LLM deployment's is): its device
    memory and engine thread go back before the next model loads."""
    import asyncio

    from ray_tpu_torch.serve.multiplex import _MultiplexWrapper

    unloaded = []

    class Engine:
        def __init__(self, mid):
            self.mid = mid

        async def __serve_unload__(self):
            await asyncio.sleep(0)
            unloaded.append(self.mid)

    async def load(owner, mid):
        return Engine(mid)

    w = _MultiplexWrapper(load, max_models=2)

    async def run():
        for mid in ("a", "b", "a", "c", "d"):
            assert (await w.load(None, mid)).mid == mid

    asyncio.run(run())
    assert unloaded == ["b", "a"]
    assert w.model_ids() == ["c", "d"]
    assert [m.mid for m in w.pop_all()] == ["c", "d"]
