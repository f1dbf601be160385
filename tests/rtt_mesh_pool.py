"""A pool of gloo ranks for the port's mesh tests, and the functions the
ranks run.

``RankPool(world)`` spawns ``world`` processes once (a test module's
fixture), each joined to one ``torch.distributed`` gloo domain through a
``TCPStore`` this process hosts on a free port (``port=0``: nothing waits
on a fixed port), on the CPU (``multihost.initialize(device="cpu")``).
``pool.run(fn, *args)`` runs ``fn(*args)`` on every rank and returns the
ranks' results in rank order; a rank that raises fails the call with its
traceback, and the pool is torn down (its peers may be stuck in a
collective).  ``fn`` must be importable by the ranks without JAX: the
rank-side functions live in this module, which imports no JAX.
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

RESULT_TIMEOUT_S = 120.0


def _rank_main(rank: int, world: int, port: int, conn) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist

    from ray_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    try:
        store = dist.TCPStore("127.0.0.1", port, world, False)
        multihost.initialize(f"127.0.0.1:{port}", world, rank,
                             device="cpu", store=store)
        conn.send(("ok", None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        fn, args = msg
        try:
            conn.send(("ok", fn(*args)))
        except BaseException:  # noqa: BLE001 - reported to the parent
            conn.send(("err", traceback.format_exc()))
    multihost.shutdown()


class RankPool:
    """``world`` gloo ranks on the CPU, spawned once."""

    def __init__(self, world: int):
        import multiprocessing as mp

        import torch.distributed as dist
        self.world = world
        self.store = dist.TCPStore("127.0.0.1", 0, world + 1, True,
                                   wait_for_workers=False)
        ctx = mp.get_context("spawn")
        self.conns, self.procs = [], []
        for r in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, args=(
                r, world, self.store.port, child), daemon=True,
                name=f"rtt-rank-{r}")
            p.start()
            self.conns.append(parent)
            self.procs.append(p)
        self._collect("the domain's rendezvous")

    def _collect(self, what: str) -> List[Any]:
        out = []
        for r, c in enumerate(self.conns):
            if not c.poll(RESULT_TIMEOUT_S):
                self.close()
                raise TimeoutError(f"rank {r}: no answer to {what} in "
                                   f"{RESULT_TIMEOUT_S} s")
            status, val = c.recv()
            if status != "ok":
                self.close()
                raise RuntimeError(f"rank {r} failed in {what}:\n{val}")
            out.append(val)
        return out

    def run(self, fn, *args) -> List[Any]:
        for c in self.conns:
            c.send((fn, args))
        return self._collect(getattr(fn, "__name__", str(fn)))

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send(None)
            except (OSError, BrokenPipeError):
                pass
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        self.conns, self.procs = [], []


# ------------------------------------------------------------ rank helpers
def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tree_np(tree: Any) -> Any:
    from ray_tpu_torch.parallel import transforms as tx
    return tx.tree_map(_np, tree)


def _mesh(**axes):
    from ray_tpu_torch.parallel.mesh import Mesh, MeshConfig
    return Mesh(MeshConfig(**axes), device="cpu")


def _grads(loss_fn, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn()
    return list(torch.autograd.grad(loss, leaves))


# --------------------------------------------------- collective matmuls
def rank_collective_matmul(kind: str, n: int, x: np.ndarray,
                           w: np.ndarray) -> Dict[str, Any]:
    """Rank side of the primitives' test: this rank's shards of x and w
    (``kind`` "ag": x split on rows, w on columns; "rs": x on columns,
    w on rows) over a ``tensor`` ring of n (the pool's other ranks on
    ``data``), the output and the gradients of sum(sin(y)) for the ring
    and the ``_reference`` pair."""
    from ray_tpu_torch.ops import collective_matmul as cm
    world = int(torch.distributed.get_world_size())
    mesh = _mesh(data=world // n, tensor=n)
    i = mesh.coords["tensor"]
    X, W = torch.from_numpy(x), torch.from_numpy(w)
    if kind == "ag":
        xl = X.chunk(n, dim=-2)[i].contiguous()
        wl = W.chunk(n, dim=-1)[i].contiguous()
        fns = {"ring": cm.all_gather_matmul,
               "reference": cm.all_gather_matmul_reference}
    else:
        xl = X.chunk(n, dim=-1)[i].contiguous()
        wl = W.chunk(n, dim=-2)[i].contiguous()
        fns = {"ring": cm.matmul_reduce_scatter,
               "reference": cm.matmul_reduce_scatter_reference}
    out = {}
    for name, fn in fns.items():
        a, b = xl.clone(), wl.clone()
        y = fn(a, b, "tensor", n, mesh)
        gx, gw = _grads(lambda: torch.sin(fn(a, b, "tensor", n, mesh)).sum(),
                        [a, b])
        out[name] = {"y": _np(y), "dx": _np(gx), "dw": _np(gw)}
    mesh.destroy()
    return {"tensor": i, **out}


def rank_ring_scan_order(n: int) -> List[int]:
    """The source of each step's resident block: (block value) - (me - s)
    mod n, which must be 0 at every step."""
    from ray_tpu_torch.ops.collective_matmul import ring_scan
    world = int(torch.distributed.get_world_size())
    mesh = _mesh(data=world // n, tensor=n)
    me = mesh.coords["tensor"]

    def body(step, seen, blk):
        seen.append(int(blk.item()) - (me - step) % n)
        return seen

    seen = ring_scan(body, [], torch.tensor(me), axis_name="tensor",
                     axis_size=n, mesh=mesh)
    mesh.destroy()
    return seen


def rank_ring_scan_overlap(n: int) -> List[str]:
    """The order of events in a ring_scan under autograd: each
    permutation issued (``start``) and waited for (``wait``), and body's
    forward and backward at each step (``fwd<s>`` / ``bwd<s>``), through
    the forward and the backward of sum(carry)."""
    from ray_tpu_torch.ops.collective_matmul import ring_scan
    from ray_tpu_torch.util.collective.collective_group import device_group
    world = int(torch.distributed.get_world_size())
    mesh = _mesh(data=world // n, tensor=n)
    log: List[str] = []

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, step):
            ctx.step = step
            log.append(f"fwd{step}")
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            log.append(f"bwd{ctx.step}")
            return g, None

    start, wait = (device_group.DeviceCollectiveGroup.permute_start,
                   device_group._Pending.wait)

    def logged_start(self, *a, **kw):
        log.append("start")
        return start(self, *a, **kw)

    def logged_wait(self):
        log.append("wait")
        return wait(self)

    device_group.DeviceCollectiveGroup.permute_start = logged_start
    device_group._Pending.wait = logged_wait
    try:
        x = torch.full((4,), float(mesh.coords["tensor"] + 1),
                       requires_grad=True)
        out = ring_scan(lambda s, c, blk: c + Mark.apply(blk, s).sum(),
                        torch.zeros(()), x, axis_name="tensor",
                        axis_size=n, mesh=mesh)
        log.append("backward")
        out.backward()
    finally:
        device_group.DeviceCollectiveGroup.permute_start = start
        device_group._Pending.wait = wait
    mesh.destroy()
    return log


# ------------------------------------------------ ring / Ulysses attention
def rank_context_attention(impl: str, n: int, q: np.ndarray, k: np.ndarray,
                           v: np.ndarray) -> Dict[str, Any]:
    """This rank's sequence chunk of ring or Ulysses attention over a
    ``context`` axis of n, and the gradients of sum(sin(out)) w.r.t. its
    chunks of q, k, v."""
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.ops.ulysses import ulysses_attention
    world = int(torch.distributed.get_world_size())
    mesh = _mesh(data=world // n, context=n)
    c = mesh.coords["context"]
    loc = [torch.from_numpy(a).chunk(n, dim=1)[c].contiguous()
           for a in (q, k, v)]

    def attn(q, k, v):
        if impl == "ring":
            return ring_attention(q, k, v, axis_name="context", axis_size=n,
                                  mesh=mesh)
        return ulysses_attention(q, k, v, axis_name="context", mesh=mesh)

    out = attn(*loc)
    grads = _grads(lambda: torch.sin(attn(*loc)).sum(), loc)
    mesh.destroy()
    return {"context": c, "out": _np(out), "grads": [_np(g) for g in grads]}


# ------------------------------------------------------------- pipeline
def _pipe_stage(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i])
    return x


def rank_pipeline(stage_params: Dict[str, np.ndarray], x_micro: np.ndarray,
                  stages: int, remat: bool) -> Dict[str, Any]:
    """``pipeline_apply`` over a ``pipeline`` axis of ``stages`` (the other
    ranks on ``data``): the output (every rank's), and the gradients of
    sum(out²) for this rank's stage and for x by the mesh program's rule
    (summed over the ranks that hold a copy, over the number of ranks)."""
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel.pipeline import pipeline_apply
    world = int(torch.distributed.get_world_size())
    mesh = _mesh(data=world // stages, pipeline=stages)
    s = mesh.coords["pipeline"]
    local = {k: torch.from_numpy(v[s:s + 1]).clone()
             for k, v in stage_params.items()}
    x = torch.from_numpy(x_micro).clone()

    def run():
        return pipeline_apply(_pipe_stage, local, x, mesh=mesh,
                              remat=remat)

    out = run()
    gw, gx = _grads(lambda: (run() ** 2).sum(), [local["w"], x])
    gw = col.psum(gw, "data", mesh)              # a copy on every data rank
    gx = col.psum(gx, ("data", "pipeline"), mesh)  # on every rank
    mesh.destroy()
    return {"stage": s, "out": _np(out), "dw": _np(gw / world),
            "dx": _np(gx / world)}


# ---------------------------------------------------------- device group
def rank_device_group(rows: np.ndarray) -> Dict[str, Any]:
    """The device group's ops over the whole pool, this rank's tensor
    being row ``rank`` of ``rows`` (world, world, ...)."""
    from ray_tpu_torch.util.collective.collective_group.device_group \
        import DeviceCollectiveGroup
    g = DeviceCollectiveGroup.over_domain("test")
    mine = torch.from_numpy(rows[g.rank]).clone()
    out = {"transport": g.transport, "rank": g.rank,
           "allreduce": _np(g.allreduce(mine)),
           "allreduce_max": _np(g.allreduce(mine, "max")),
           "allgather": _np(g.allgather(mine)),
           "reducescatter": _np(g.reducescatter(mine)),
           "alltoall": _np(g.alltoall(mine)),
           "broadcast": _np(g.broadcast(mine, 1))}
    g.barrier()
    return out


def rank_multihost_allreduce(rows: np.ndarray) -> Dict[str, Any]:
    """``multihost.allreduce`` of a tree holding rank r's row r (float32
    and float64, mean and sum): the results, their dtypes, and the
    domain device group it rode (its transport, the legs it timed)."""
    from ray_tpu_torch.parallel import multihost
    r = multihost.process_index()
    mine = torch.from_numpy(rows[r])
    mean = multihost.allreduce({"f": mine, "d": mine.double()}, "mean")
    total = multihost.allreduce([mine], "sum", dtype=torch.float64)
    group = multihost.domain_group(torch.device("cpu"))
    return {"mean": _np(mean["f"]), "mean_dtypes": [str(mean["f"].dtype),
                                                    str(mean["d"].dtype)],
            "sum": _np(total[0]), "transport": group.transport,
            "legs": sorted(multihost.last_allreduce)}


def rank_transport(device: str, requested) -> str:
    """The transport ``choose_transport`` gives for this placement (an
    error's type and message when it raises)."""
    from ray_tpu_torch.util.collective.collective_group.device_group \
        import choose_transport
    try:
        return choose_transport(torch.device(device), requested)
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"


# ------------------------------------------------------------ model meshes
def _family(family: str):
    """(module, rules) of a family, as ``mesh_reference._family``."""
    from ray_tpu_torch.models import gpt2, llama, moe_transformer, resnet
    from ray_tpu_torch.parallel import mesh as mesh_lib
    return {"gpt2": (gpt2, mesh_lib.TRANSFORMER_RULES),
            "llama": (llama, llama.LLAMA_RULES),
            "moe": (moe_transformer, moe_transformer.MOE_TRANSFORMER_RULES),
            "resnet": (resnet, resnet.RESNET_RULES)}[family]


def _program(family: str, axes, cfg_kw: Dict[str, Any], params,
             opt_kw: Dict[str, Any]):
    """(program, cfg, rules) of a tiny ``family`` model over the mesh
    ``axes`` (None: one process) from the global ``params``; float32
    activations unless ``cfg_kw`` names a ``dtype``."""
    import dataclasses

    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.parallel import spmd
    mod, rules = _family(family)
    cfg_kw = dict(cfg_kw)
    cfg = dataclasses.replace(mod.tiny(**cfg_kw.pop("tiny", {})),
                              **{"dtype": torch.float32, **cfg_kw})
    mesh = None if axes is None else mesh_lib.Mesh(
        mesh_lib.MeshConfig(**axes), device="cpu")
    prog = spmd.build_train_program(
        loss_fn=lambda p, b: mod.loss_fn(p, b, cfg),
        init_params_fn=lambda g: params_from_numpy(params, cfg, "cpu"),
        optimizer=spmd.default_optimizer(**opt_kw),
        mesh=mesh if mesh is not None else "cpu", rules=rules)
    return prog, cfg, rules


def rank_mesh_train(family: str, axes: Dict[str, int],
                    cfg_kw: Dict[str, Any], params: Dict[str, Any],
                    batch: Dict[str, np.ndarray], steps: int,
                    opt_kw: Dict[str, Any]) -> Dict[str, Any]:
    """A tiny ``family`` model over the mesh ``axes`` through
    ``spmd.build_train_program``: the step-0 gradients of this rank's
    slices (the program's reduction), then ``steps`` steps' losses and
    grad norms, and this rank's coordinates."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel import transforms as tx
    prog, cfg, rules = _program(family, axes, cfg_kw, params, opt_kw)
    mod, mesh = _family(family)[0], prog.mesh
    state = prog.init_fn(torch.Generator())
    batch = spmd.shard_batch(prog, batch)
    # the step-0 gradients, as the program reduces them
    leaves = tx.tree_leaves(state.params)
    with mesh_lib.ambient_mesh(mesh):
        gs = _grads(lambda: mod.loss_fn(state.params, batch, cfg), leaves)
    for p in leaves:
        p.requires_grad_(False)
    specs = spmd._spec_leaves(mesh_lib.param_specs(state.params, rules))
    it = iter(gs)
    gtree = spmd._mesh_reduce(mesh, specs, tx.tree_map(lambda _: next(it),
                                                       state.params))
    losses, norms = [], []
    for _ in range(steps):
        state, m = prog.step_fn(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    mesh.destroy()
    return {"coords": dict(mesh.coords), "losses": losses, "norms": norms,
            "grads": _tree_np(gtree), "transport": mesh.transport}


def rank_gpt2_train(axes: Dict[str, int], cfg_kw: Dict[str, Any],
                    params: Dict[str, Any], tokens: np.ndarray,
                    steps: int, opt_kw: Dict[str, Any],
                    family: str = "gpt2") -> Dict[str, Any]:
    """``rank_mesh_train`` of a GPT-2 (or Llama) on a token batch."""
    return rank_mesh_train(family, axes, cfg_kw, params,
                           {"tokens": tokens}, steps, opt_kw)


# ------------------------------------------------------- shards and state
def rank_shard_params(axes: Dict[str, int], params: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """This rank's ``shard_params`` slice of a global GPT-2 tree, and the
    tree gathered back (``gather_to_host`` by the specs) and placed again
    (``put_global`` by the specs)."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.parallel import multihost
    from ray_tpu_torch.parallel import transforms as tx
    mesh = _mesh(**axes)
    glob = tx.tree_map(torch.from_numpy, params)
    local = mesh_lib.shard_params(mesh, glob)
    specs = mesh_lib.param_specs(glob)
    back = multihost.gather_to_host(local, specs=specs, mesh=mesh)
    again = multihost.put_global(back, "cpu", specs=specs, mesh=mesh)
    same = all(torch.equal(a, b) for a, b in zip(tx.tree_leaves(again),
                                                 tx.tree_leaves(local)))
    mesh.destroy()
    return {"coords": dict(mesh.coords), "local": _tree_np(local),
            "back": back, "placed_again": same}


def rank_collective_api(rows: np.ndarray) -> Dict[str, Any]:
    """util.collective's API over the ``device`` backend: the domain's
    ranks as one group."""
    from ray_tpu_torch.util import collective as col
    world = int(torch.distributed.get_world_size())
    rank = int(torch.distributed.get_rank())
    col.init_collective_group(world, rank, "device", "api")
    try:
        mine = torch.from_numpy(rows[rank]).clone()
        out = {"allreduce": _np(col.allreduce(mine, "api")),
               "rank": col.get_rank("api"),
               "size": col.get_collective_group_size("api")}
        if rank == 0:
            col.send(mine * 3, 1, "api")
        elif rank == 1:
            out["recv"] = _np(col.recv(0, "api"))
        col.barrier("api")
    finally:
        col.destroy_collective_group("api")
    out["after"] = col.is_group_initialized("api")
    return out


# ------------------------------------------------------- ZeRO-3 and experts
def rank_uneven_gather(w: np.ndarray, x: np.ndarray) -> Dict[str, Any]:
    """A (n, m) weight split over ``fsdp`` = the pool's ranks in ceil
    pieces (the last short, or empty), gathered at use
    (``gather_for_use``) into sum(sin(x @ W)), the global loss on every
    rank: the gathered weight and this rank's piece of the gradient by
    the program's rule (``spmd._mesh_reduce``)."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.parallel import spmd
    world = int(torch.distributed.get_world_size())
    mesh = _mesh(data=1, fsdp=world)
    spec = mesh_lib.P("fsdp", None, shape=w.shape)
    piece = mesh_lib.NamedSharding(mesh, spec).local_slice(
        torch.from_numpy(w)).clone()
    X = torch.from_numpy(x)

    def loss():
        full = mesh_lib.gather_for_use({"w": piece}, {"w": spec}, mesh)["w"]
        return torch.sin(X @ full).sum(), full

    (g,) = _grads(lambda: loss()[0], [piece])
    g = spmd._mesh_reduce(mesh, [spec], [g])[0]
    full = loss()[1]
    mesh.destroy()
    return {"fsdp": mesh.coords["fsdp"], "full": _np(full), "grad": _np(g),
            "piece_rows": piece.shape[0]}


def rank_gathered_alive(axes: Dict[str, int], params: Dict[str, Any],
                        tokens: np.ndarray, remat: bool) -> Dict[str, Any]:
    """ZeRO-3's memory contract: the storage of every buffer
    ``gather_for_use`` makes in one GPT-2 loss forward under grad, held
    by a weak reference (a view keeps a storage alive); after the
    forward returns, the shapes of those still alive (what autograd
    keeps for the backward) and the count made; then after the
    backward."""
    import gc
    import weakref

    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel import transforms as tx
    prog, cfg, _ = _program("gpt2", axes, {"tiny": {"vocab": 128, "seq": 32},
                                           "remat": remat}, params,
                            {"lr": 1e-2})
    mod = _family("gpt2")[0]
    state = prog.init_fn(torch.Generator())
    batch = spmd.shard_batch(prog, {"tokens": tokens})
    made: List[Any] = []
    real = col.all_gather_uneven

    def watched(*a, **kw):
        out = real(*a, **kw)
        made.append((weakref.ref(out.untyped_storage()), tuple(out.shape)))
        return out

    col.all_gather_uneven = watched
    try:
        for p in tx.tree_leaves(state.params):
            p.requires_grad_(True)
        with mesh_lib.ambient_mesh(prog.mesh):
            loss = mod.loss_fn(state.params, batch, cfg)
        gc.collect()
        alive = [shape for r, shape in made if r() is not None]
        n_forward = len(made)
        loss.backward()
        del loss
        gc.collect()
        after = [shape for r, shape in made if r() is not None]
    finally:
        col.all_gather_uneven = real
    prog.mesh.destroy()
    return {"made": n_forward, "alive": alive, "replayed": len(made)
            - n_forward, "alive_after_backward": after}


def rank_moe_ffn(axes: Dict[str, int], x: np.ndarray, router: np.ndarray,
                 w_in: np.ndarray, w_out: np.ndarray, k: int, cf: float
                 ) -> Dict[str, Any]:
    """``moe_ffn`` over the mesh ``axes``: this rank's rows of x (its
    batch coordinate) through its slice of the experts: its output rows,
    the metrics, the dropped set of its tokens, and the gradients of the
    global sum(y²) + 0.01·aux + 0.001·z for the router and its expert
    slices by the program's rule."""
    from ray_tpu_torch.ops import moe as tmoe
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.parallel import spmd
    mesh = _mesh(**axes)
    rows = mesh_lib.NamedSharding(mesh, mesh_lib.batch_spec(mesh.config, 3))
    xs = rows.local_slice(torch.from_numpy(x)).clone()
    specs = [mesh_lib.P(None, None), mesh_lib.P("expert", None, "tensor"),
             mesh_lib.P("expert", "tensor", None)]
    ws = [mesh_lib.NamedSharding(mesh, s).local_slice(
        torch.from_numpy(a)).clone() for s, a in zip(specs,
                                                     (router, w_in, w_out))]
    axes_b = tmoe._token_axes(mesh)
    with mesh_lib.ambient_mesh(mesh):
        y, m = tmoe.moe_ffn(xs, *ws, k=k, capacity_factor=cf)

        def loss():
            y, m = tmoe.moe_ffn(xs, *ws, k=k, capacity_factor=cf)
            return (col.psum((y ** 2).sum(), axes_b, mesh)
                    + 0.01 * m.aux_loss + 0.001 * m.router_z_loss)

        grads = _grads(loss, ws)
        tokens = xs.reshape(-1, xs.shape[-1])
        gates, _, _ = tmoe.topk_router(tokens, ws[0], k)
        n_global = tokens.shape[0] * int(np.prod(
            [mesh.shape[a] for a in axes_b]))
        cap = tmoe.expert_capacity(n_global, router.shape[-1], k, cf)
        route = tmoe._route(mesh, gates, xs.shape[0])
        assigned, _, keep = tmoe._queue_positions(gates, cap, route.prefix)
    grads = spmd._mesh_reduce(mesh, specs, grads)
    mesh.destroy()
    return {"coords": dict(mesh.coords), "y": _np(y),
            "aux": float(m.aux_loss), "z": float(m.router_z_loss),
            "dropped_fraction": float(m.fraction_dropped),
            "dropped": (assigned.any(-1) & ~keep.any(-1)).numpy(),
            "grads": [_np(g) for g in grads]}


def rank_sharded_checkpoint(family: str, axes: Dict[str, int],
                            cfg_kw: Dict[str, Any], params: Dict[str, Any],
                            batch: Dict[str, np.ndarray], steps: int,
                            opt_kw: Dict[str, Any]) -> Dict[str, Any]:
    """``steps`` steps over the mesh, then the state gathered on the host
    by its specs (``gather_to_host``: what Train checkpoints), placed back
    (``put_global``), and the same program's state on one process."""
    from ray_tpu_torch.parallel import multihost
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel import transforms as tx
    out = {}
    for name, where in (("mesh", axes), ("one", None)):
        prog, cfg, rules = _program(family, where, cfg_kw, params, opt_kw)
        state = prog.init_fn(torch.Generator())
        b = spmd.shard_batch(prog, batch)
        for _ in range(steps):
            state, _ = prog.step_fn(state, b)
        if prog.mesh is None:
            out[name] = {"params": _tree_np(state.params),
                         "opt_state": multihost.gather_to_host(
                             state.opt_state)}
            continue
        specs = spmd.state_specs(state, rules)
        host = {k: multihost.gather_to_host(
            getattr(state, k), specs=getattr(specs, k), mesh=prog.mesh)
            for k in ("params", "opt_state")}
        again = multihost.put_global(host["params"], "cpu",
                                     specs=specs.params, mesh=prog.mesh)
        out["placed_again"] = all(torch.equal(a, b) for a, b in zip(
            tx.tree_leaves(again), tx.tree_leaves(state.params)))
        out[name] = host
        prog.mesh.destroy()
    return out


def rank_axis_mesh(axes: Dict[str, int], shared: List[str]
                   ) -> Dict[str, Any]:
    """A mesh over ``axes``: this rank's coordinates and every live axis's
    group (its global ranks); then a (4, 4) leaf whose spec puts the
    axes ``shared`` in one entry (``fsdp`` with another axis: no rule
    table of the reference does) gathered at use over a mesh of two
    ranks on each, its error."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    mesh = _mesh(**axes)
    out = {"coords": dict(mesh.coords),
           "groups": {a: g.ranks for a, g in mesh.groups.items()}}
    mesh.destroy()
    mesh = _mesh(**{a: 2 for a in shared})
    spec = mesh_lib.P(tuple(shared), None, shape=(4, 4))
    try:
        mesh_lib.gather_for_use({"w": torch.zeros(2, 4)}, {"w": spec}, mesh)
        out["error"] = None
    except NotImplementedError as e:
        out["error"] = str(e)
    mesh.destroy()
    return out


# ------------------------------------------------------ the rest of 8b
def rank_attention_heads(axes: Dict[str, int], params: Dict[str, Any],
                         tokens: np.ndarray) -> Dict[str, Any]:
    """Llama tiny in float32 over the mesh ``axes`` without grad, on this
    rank's rows of ``tokens``: the output of every layer's attention on
    this rank (its heads), and its coordinates."""
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel import mesh as mesh_lib
    cfg = dataclasses.replace(llama.tiny(vocab=128, seq=32),
                              dtype=torch.float32, attn_impl="dense")
    mesh = _mesh(**axes)
    local = mesh_lib.shard_params(mesh, params_from_numpy(params, cfg, "cpu"),
                                  llama.LLAMA_RULES)
    seen = []
    real = llama._dense_gqa

    def record(q, k, v, c):
        out = real(q, k, v, c)
        seen.append(_np(out))
        return out

    llama._dense_gqa = record
    try:
        with torch.no_grad(), mesh_lib.ambient_mesh(mesh):
            llama.mesh_hidden(local, mesh_lib.shard_batch_rows(
                mesh, torch.from_numpy(tokens).long()), cfg, mesh)
    finally:
        llama._dense_gqa = real
    mesh.destroy()
    return {"coords": dict(mesh.coords), "attn": seen}


def rank_mesh_hidden(family: str, axes: Optional[Dict[str, int]],
                     cfg_kw: Dict[str, Any], params: Dict[str, Any],
                     tokens: np.ndarray) -> np.ndarray:
    """The final-norm hidden states (float32) of a tiny ``family`` model
    (Llama or MoE) over the mesh ``axes`` (None: one process) without
    grad, on this rank's rows of ``tokens``."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    prog, cfg, _ = _program(family, axes, cfg_kw, params, {})
    mod, mesh = _family(family)[0], prog.mesh
    params = prog.init_fn(torch.Generator()).params
    inp = torch.from_numpy(tokens).long()
    with torch.no_grad(), mesh_lib.ambient_mesh(mesh):
        if mesh is None:
            x = mod._hidden(params, inp, cfg) if family == "llama" else \
                mod.forward_hidden(params, inp, cfg)[0]
        else:
            inp = mesh_lib.shard_batch_rows(mesh, inp)
            x = mod.mesh_hidden(params, inp, cfg, mesh) \
                if family == "llama" else \
                mod.forward_hidden(params, inp, cfg, mesh)[0]
            mesh.destroy()
    return _np(x.float())


def rank_mesh_loss(family: str, axes: Dict[str, int], cfg_kw: Dict[str, Any],
                   params: Dict[str, Any], batch: Dict[str, np.ndarray]
                   ) -> Dict[str, Any]:
    """The loss of a tiny ``family`` model over the mesh ``axes`` on this
    rank's rows, and the gradients of its slices by the program's rule
    (``spmd._mesh_reduce``): one forward and backward, no step."""
    from ray_tpu_torch.parallel import mesh as mesh_lib
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel import transforms as tx
    prog, cfg, rules = _program(family, axes, cfg_kw, params, {})
    mod, mesh = _family(family)[0], prog.mesh
    state = prog.init_fn(torch.Generator())
    b = spmd.shard_batch(prog, batch)
    leaves = tx.tree_leaves(state.params)
    with mesh_lib.ambient_mesh(mesh):
        for p in leaves:
            p.requires_grad_(True)
        loss = mod.loss_fn(state.params, b, cfg)
        gs = list(torch.autograd.grad(loss, leaves))
    specs = spmd._spec_leaves(mesh_lib.param_specs(state.params, rules))
    it = iter(gs)
    grads = spmd._mesh_reduce(mesh, specs, tx.tree_map(lambda _: next(it),
                                                       state.params))
    mesh.destroy()
    return {"coords": dict(mesh.coords), "loss": float(loss.detach()),
            "grads": _tree_np(grads)}
