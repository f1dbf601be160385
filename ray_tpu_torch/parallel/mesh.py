"""Meshes over ranks and sharding rules (port of
``ray_tpu/parallel/mesh.py``).

The reference lays ONE process's devices out as a ``jax.sharding.Mesh``
and lets GSPMD derive every collective.  The port's counterpart is the
PyTorch idiom: one process a rank in a ``torch.distributed`` domain
(``parallel/multihost.py``), the ranks laid out over the same canonical
axes, and the collectives written into the per-rank program
(``parallel/collectives.py``).  ``Mesh(config)``:

- lays the domain's ranks out row-major over ``AXES`` (``pipeline`` and
  ``data`` outermost, ``tensor`` innermost, as the reference's
  ``build_mesh``), and holds this rank's coordinates;
- makes one sub-group an axis of size > 1 (every rank makes every
  sub-group, in the same order: ``dist.new_group`` deadlocks otherwise),
  each a ``DeviceCollectiveGroup`` whose transport follows the ranks'
  placement (``util/collective/collective_group/device_group.py``).

``shard_params`` gives this rank exactly the slice of each leaf that its
coordinates select under the rules (the shard ``NamedSharding`` would
place on the device at those coordinates; a dim that does not divide is
cut in ceil-sized pieces, the last one short).

Specs are tuples, one entry a dim: ``None`` (replicated), an axis name,
or a tuple of axis names (the dim sharded over their product, the first
outermost).

ZeRO-3 over ``fsdp`` (the reference's GSPMD gathers a weight where it is
used): a rank keeps its ``fsdp`` piece of every matrix, and the model
gathers each leaf for use (``gather_for_use``, an autograd all-gather
whose backward reduce-scatters the gradient back onto the piece), inside
each block's checkpointed region, so a block's gathered weights die with
its forward and the backward's replay gathers them again.  The batch
splits over ``("data", "fsdp")``.  Over ``expert`` a rank keeps its
slice of the experts' leading axis (``ops/moe.py`` runs them).

The stacked layer dim over ``pipeline`` without a schedule (Llama and
the MoE transformer: the reference's ``lax.scan`` over a stacked dim
GSPMD splits): stage s keeps layers ``shard_bounds(L, pp, s)``, every
rank runs every layer on its own rows, and ``gather_for_use`` fetches
layer l from its owner at use (``layers_for_use`` gives each layer's
view and specs), again inside the block's checkpointed region.

What each gather's backward leaves, axis by axis (``spmd``'s docstring
has the step's side of the contract):

- ``fsdp``: the all-gather's transpose, a reduce-scatter (in float32,
  rounded once to the leaf's dtype) of every ``fsdp`` rank's gradient
  onto this rank's piece;
- ``pipeline``: the broadcast's transpose, the sum of every ``pipeline``
  rank's gradient of the layer onto its owner (the other stages get
  none).  The ranks of a pipeline line compute the same rows, so that
  sum is ``pp`` times the one-rank gradient, exactly as a ``data``
  copy's is after the step's sum; the step's division by the mesh size
  takes it back out.  Nothing else divides by ``pp``.
``NamedSharding(mesh, spec)`` is the reference's placement of a global
array as a plain holder: ``local_slice`` is this rank's piece.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import re
from dataclasses import dataclass, fields
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ray_tpu_torch.parallel import transforms as tx

AXES = ("data", "fsdp", "pipeline", "context", "seq", "tensor", "expert")
ITEM_8B = "ROADMAP queue A, item 8b"

SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]
Rules = List[Tuple[str, Spec]]


class PartitionSpec(tuple):
    """A leaf's spec as ``param_specs`` and ``spmd.state_specs`` give it:
    a tuple of entries, of its own type so that a tree of specs (with the
    optimizer state's tuples) knows its leaves.  ``shape``: the GLOBAL
    leaf's shape where the spec was made from the global tree
    (``use_specs``), which a gather of a short last piece needs; None
    otherwise.  ``layer``: for one layer's view of a leaf stacked over
    ``pipeline`` (``layers_for_use``), (the global layer, the global
    layer count), which name the stage that owns it; None otherwise."""

    def __new__(cls, *entries: SpecEntry,
                shape: Optional[Tuple[int, ...]] = None,
                layer: Optional[Tuple[int, int]] = None
                ) -> "PartitionSpec":
        self = super().__new__(cls, entries)
        self.shape = None if shape is None else tuple(shape)
        self.layer = layer
        return self

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshConfig:
    """Logical parallelism layout; -1 on one axis absorbs the remaining
    ranks."""
    data: int = -1
    fsdp: int = 1
    pipeline: int = 1
    context: int = 1
    seq: int = 1
    tensor: int = 1
    expert: int = 1

    def as_dict(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    def resolved(self, n_devices: int) -> "MeshConfig":
        sizes = self.as_dict()
        fixed = [v for v in sizes.values() if v != -1]
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        prod = math.prod(fixed)
        if free:
            if n_devices % prod:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[free[0]] = n_devices // prod
        elif prod != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {prod} devices, have {n_devices}")
        return MeshConfig(**sizes)

    @property
    def num_devices(self) -> int:
        """Devices the layout needs (a -1 axis counts as 1)."""
        return math.prod(abs(getattr(self, f.name)) for f in fields(self))

    def batch_axes(self) -> Tuple[str, ...]:
        """Mesh axes the global batch is sharded over."""
        return tuple(a for a in ("data", "fsdp")
                     if self.as_dict()[a] != 1) or ("data",)


# ---------------------------------------------------------------- the mesh
class Mesh:
    """The ranks of the ``torch.distributed`` domain over ``AXES``.

    Outside a domain (one process) it is the one-rank mesh: every axis of
    size 1, no groups, every collective the identity.  ``device``: this
    rank's device (default: the domain's, ``multihost.device()``)."""

    def __init__(self, config: Optional[MeshConfig] = None,
                 device: Any = None):
        from ray_tpu_torch.parallel import multihost
        from ray_tpu_torch.util.collective.collective_group.device_group \
            import DeviceCollectiveGroup, choose_transport
        world = multihost.process_count()
        self.rank = multihost.process_index()
        self.config = (config or MeshConfig()).resolved(world)
        self.shape: Dict[str, int] = self.config.as_dict()
        dims = [self.shape[a] for a in AXES]
        self.coords: Dict[str, int] = dict(zip(
            AXES, (int(c) for c in np.unravel_index(self.rank, dims))))
        self.device = torch.device(device) if device is not None \
            else multihost.device()
        self.transport = choose_transport(self.device) \
            if world > 1 else "local"
        self.groups: Dict[str, DeviceCollectiveGroup] = {}
        grid = np.arange(world).reshape(dims)
        for i, axis in enumerate(AXES):
            if dims[i] == 1:
                continue
            # every line of ranks along this axis, in one order on every rank
            lines = np.moveaxis(grid, i, -1).reshape(-1, dims[i])
            for line in lines:
                g = DeviceCollectiveGroup.new(
                    [int(r) for r in line], self.device, self.transport,
                    name=f"mesh/{axis}")
                if self.rank in line:
                    self.groups[axis] = g

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The sub-group along ``axis`` that holds this rank."""
        return self.groups[axis]

    def collective_seconds(self) -> Dict[str, float]:
        """Seconds spent in every group's collectives since the last
        ``reset_collective_seconds``: device-to-host, the wire, and
        host-to-device."""
        out = {"to_host": 0.0, "wire": 0.0, "to_device": 0.0}
        for g in self.groups.values():
            for k in out:
                out[k] += g.seconds[k]
        return out

    def reset_collective_seconds(self) -> None:
        for g in self.groups.values():
            g.seconds.update(to_host=0.0, wire=0.0, to_device=0.0)

    def destroy(self) -> None:
        """Every rank calls it: the groups go in the axes' order (each
        group's destroy is a barrier of its ranks)."""
        for g in self.groups.values():
            g.destroy()
        self.groups.clear()

    def __repr__(self) -> str:
        live = {a: n for a, n in self.shape.items() if n > 1}
        return (f"Mesh({live or 'one rank'}, rank={self.rank}, "
                f"device={self.device}, transport={self.transport})")


def single_device_mesh(device: Any = None) -> Mesh:
    """The one-rank mesh on ``device`` (outside any domain)."""
    return Mesh(MeshConfig(data=1), device=device)


# ------------------------------------------------------------ ambient mesh
# Lets model code reach the program's mesh (ring and Ulysses attention,
# GPT-2's manual region): spmd.build_train_program sets it around each
# step, as the reference sets it around tracing.  A contextvar, with the
# innermost mesh of the process behind it: the autograd engine runs a
# CUDA backward (and so every checkpointed block's replay) on a device
# thread of its own, which does not see the caller's contextvars.
_AMBIENT_MESH: contextvars.ContextVar[Optional[Mesh]] = \
    contextvars.ContextVar("ray_tpu_torch_ambient_mesh", default=None)
_PROCESS_MESH: List[Optional[Mesh]] = []


def get_ambient_mesh() -> Optional[Mesh]:
    mesh = _AMBIENT_MESH.get()
    if mesh is None and _PROCESS_MESH:
        return _PROCESS_MESH[-1]
    return mesh


@contextlib.contextmanager
def ambient_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    token = _AMBIENT_MESH.set(mesh)
    _PROCESS_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _PROCESS_MESH.pop()
        _AMBIENT_MESH.reset(token)


def live_size(mesh: Optional[Mesh], axis: Optional[str]) -> int:
    """``axis``'s size in ``mesh`` (1 without a mesh or an axis)."""
    if mesh is None or axis is None:
        return 1
    return mesh.shape.get(axis, 1)


# ------------------------------------------------------------------- rules
# (param-path regex, spec) — first match wins.  Paths are "/"-joined
# tree keys, e.g. "blocks/attn_qkv/kernel"; blocks/... leaves are stacked
# on a leading n_layer axis, which maps to ``pipeline``.
TRANSFORMER_RULES: Rules = [
    (r".*wte$", ("tensor", "fsdp")),               # (vocab, embed)
    (r".*wpe$", (None, "fsdp")),                   # (pos, embed)
    (r".*blocks/attn_qkv/kernel$", ("pipeline", "fsdp", None, "tensor")),
    (r".*blocks/attn_qkv/bias$", ("pipeline", None, "tensor")),
    (r".*blocks/attn_out/kernel$", ("pipeline", "tensor", "fsdp")),
    (r".*blocks/attn_out/bias$", ("pipeline", "fsdp")),
    (r".*blocks/mlp_in/kernel$", ("pipeline", "fsdp", "tensor")),
    (r".*blocks/mlp_in/bias$", ("pipeline", "tensor")),
    (r".*blocks/mlp_out/kernel$", ("pipeline", "tensor", "fsdp")),
    (r".*blocks/mlp_out/bias$", ("pipeline", "fsdp")),
    (r".*blocks/(ln_1|ln_2)/(scale|bias)$", ("pipeline", None)),
    # non-stacked variants (single-layer modules)
    (r".*attn_qkv/kernel$", ("fsdp", None, "tensor")),
    (r".*attn_out/kernel$", ("tensor", "fsdp")),
    (r".*mlp_in/kernel$", ("fsdp", "tensor")),
    (r".*mlp_out/kernel$", ("tensor", "fsdp")),
    (r".*(ln_1|ln_2|ln_f)/(scale|bias)$", (None,)),
    (r".*", (None,)),
]

# Logical activation axis → mesh axis (or a tuple of them, or None).
ACTIVATION_RULES: Dict[str, Any] = {
    "batch": ("data", "fsdp"),
    "seq": ("seq", "tensor"),     # the sequence-parallel residual stream
    "seq_attn": "context",        # the sequence through attention
    "heads": "tensor",
    "embed": None,
    "mlp": "tensor",
    "kv": None,
    "vocab": "tensor",
}


def spec_for_path(path: str, rules: Rules) -> Spec:
    for pat, spec in rules:
        if re.fullmatch(pat, path):
            return tuple(spec)
    return (None,)


def _fit(spec: Spec, ndim: int) -> PartitionSpec:
    """A spec trimmed or padded with None to a leaf's rank."""
    return P(*(tuple(spec)[:ndim] + (None,) * (ndim - len(spec))))


def param_specs(params: Any, rules: Rules = TRANSFORMER_RULES,
                extra_leading: Optional[str] = None) -> Any:
    """Tree of specs matching ``params``, each fitted to its leaf's rank;
    ``extra_leading`` prepends an axis to every spec."""
    specs = {path: spec_for_path(path, rules)
             for path, _ in tx.tree_leaves_with_path(params)}

    def leaf(path: str, p: Any) -> Spec:
        spec = specs[path]
        if extra_leading is not None:
            spec = (extra_leading,) + spec
        return _fit(spec, len(p.shape))

    return _map_with_path(leaf, params)


def use_specs(global_params: Any, rules: Rules = TRANSFORMER_RULES) -> Any:
    """``param_specs`` of the GLOBAL tree (meta tensors will do), each
    spec carrying its leaf's global ``shape``: what ``gather_for_use``
    reads to cut a short last piece."""
    return tx.tree_map(lambda p, s: P(*s, shape=p.shape), global_params,
                       param_specs(global_params, rules))


def layer_specs(specs: Any, layer: Optional[int] = None) -> Any:
    """The specs of one layer's view of stacked leaves (``use_specs``'):
    the leading (layer) entry and dim dropped.  ``layer``: the view is
    that global layer's, and a leaf stacked over ``pipeline`` keeps it
    (``PartitionSpec.layer``) for ``gather_for_use``."""
    def leaf(s: PartitionSpec) -> PartitionSpec:
        owned = layer is not None and "pipeline" in entry_axes(s[0])
        if owned and s[0] != "pipeline":
            raise NotImplementedError(
                f"spec {s!r}: pipeline shares its entry with another "
                f"axis ({ITEM_8B})")
        return P(*s[1:], shape=s.shape[1:],
                 layer=(layer, s.shape[0]) if owned else None)

    return tx.tree_map(leaf, specs)


def layer_owner(spec: PartitionSpec, mesh: Mesh) -> Tuple[int, int]:
    """(the ``pipeline`` stage that holds a layer view's layer, the
    layer's row in that stage's piece)."""
    layer, n_layer = spec.layer
    piece = -(-n_layer // mesh.shape["pipeline"])
    return layer // piece, layer % piece


def layers_for_use(blocks: Any, specs: Any, n_layer: int,
                   mesh: Optional[Mesh] = None) -> List[Tuple[Any, Any]]:
    """(this rank's view of layer l, its specs) for every global layer l
    of a stacked tree: a row of each leaf (one ``unbind`` a leaf, whose
    backward is one stack).  Under ``pipeline`` > 1 a leaf stacked over
    it gives its row where this rank's stage owns layer l, and an empty
    ``(0, *row)`` view of its piece elsewhere, which ``gather_for_use``
    fills from the owner."""
    mesh = mesh if mesh is not None else get_ambient_mesh()
    pp = 1 if mesh is None else mesh.shape.get("pipeline", 1)
    rows = tx.tree_map(lambda t: t.unbind(0), blocks)
    out = []
    for layer in range(n_layer):
        lspecs = layer_specs(specs, layer if pp > 1 else None)

        def view(t, r, s, layer=layer):
            if s.layer is None:
                return r[layer]
            stage, row = layer_owner(s, mesh)
            return r[row] if stage == mesh.coords["pipeline"] else t[:0]

        out.append((tx.tree_map(view, blocks, rows, lspecs), lspecs))
    return out


def _map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], f"{prefix}{k}/")
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def entry_axes(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec shards over."""
    return tuple(a for e in spec for a in entry_axes(e))


def shard_bounds(dim: int, n: int, i: int) -> Tuple[int, int]:
    """Piece ``i`` of ``n`` of a dim of ``dim``: ceil-sized pieces, the
    last one short where ``n`` does not divide ``dim``."""
    c = -(-dim // n)
    return min(dim, i * c), min(dim, (i + 1) * c)


def entry_coordinate(mesh: Mesh, entry: SpecEntry) -> Tuple[int, int]:
    """(pieces, this rank's piece) for one spec entry: the product of its
    axes' sizes, and this rank's row-major index over them."""
    n, idx = 1, 0
    for a in entry_axes(entry):
        n, idx = n * mesh.shape[a], idx * mesh.shape[a] + mesh.coords[a]
    return n, idx


def shard_index(shape: Sequence[int], spec: Spec,
                mesh: Mesh) -> Tuple[slice, ...]:
    """The slices of a global array of ``shape`` that this rank's
    coordinates select under ``spec`` (numpy and torch alike)."""
    out = []
    for d, entry in enumerate(_fit(spec, len(shape))):
        n, i = entry_coordinate(mesh, entry)
        lo, hi = shard_bounds(shape[d], n, i) if n > 1 else (0, shape[d])
        out.append(slice(lo, hi))
    return tuple(out)


def local_slice(t: Any, spec: Spec, mesh: Mesh) -> Any:
    """The slice (a view) of a global tensor or array that this rank's
    coordinates select."""
    return t[shard_index(t.shape, spec, mesh)]


class NamedSharding:
    """The reference's ``NamedSharding(mesh, spec)`` as a plain holder:
    a global array placed over the mesh by ``spec``, of which
    ``local_slice`` is this rank's piece (what ``jax.device_put`` puts on
    the device at the rank's coordinates)."""

    def __init__(self, mesh: Mesh, spec: Spec):
        self.mesh, self.spec = mesh, P(*spec)

    def local_slice(self, x: Any) -> Any:
        """This rank's piece of ``x`` (a numpy array or tensor), a view."""
        return local_slice(x, self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def shard_params(mesh: Mesh, params: Any,
                 rules: Rules = TRANSFORMER_RULES) -> Any:
    """This rank's slice of every leaf of a global tree, on the mesh's
    device (a copy: the global tree is left as it is)."""
    specs = param_specs(params, rules)
    return tx.tree_map(
        lambda p, s: local_slice(p, s, mesh).to(mesh.device, copy=True)
        .contiguous(), params, specs)


def replicated_axes(mesh: Mesh, spec: Spec) -> Tuple[str, ...]:
    """The live axes a leaf of ``spec`` is replicated over: its gradient
    is summed over them."""
    sharded = set(spec_axes(spec))
    return tuple(a for a in AXES if mesh.shape[a] > 1 and a not in sharded)


def sharded_axes(mesh: Mesh, spec: Spec) -> Tuple[str, ...]:
    """The live axes a leaf of ``spec`` is split over: its squares are
    summed over them for a global norm."""
    return tuple(a for a in spec_axes(spec) if mesh.shape[a] > 1)


# -------------------------------------------------------------------- batch
def batch_spec(config: MeshConfig, rank: int = 2) -> Spec:
    """The reference's placement of a (batch, seq, ...) array: batch over
    data (+fsdp), sequence over context.  The port's ``shard_batch``
    takes the batch dim alone: the model cuts its own sequence chunk,
    whose next-token targets need the token after it."""
    batch = config.batch_axes()
    axes: List[SpecEntry] = [batch[0] if len(batch) == 1 else batch]
    if rank >= 2:
        axes.append("context" if config.context != 1 else None)
    return P(*axes, *((None,) * (rank - len(axes))))


def local_batch_size(global_batch: int, config: MeshConfig,
                     n_devices: int) -> int:
    cfg = config.resolved(n_devices)
    denom = math.prod(cfg.as_dict()[a] for a in cfg.batch_axes())
    if global_batch % denom:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel degree {denom}")
    return global_batch // denom


def shard_batch_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch: its row-major coordinate over
    the batch axes (``data``, then ``fsdp``)."""
    n, i = entry_coordinate(mesh, mesh.config.batch_axes())
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} not divisible by "
                         f"data-parallel degree {n}")
    lo, hi = shard_bounds(x.shape[0], n, i)
    return x[lo:hi]


# ----------------------------------------------------------- ZeRO-3 gather
def fsdp_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits over ``fsdp`` (None where it does not); the
    axis must be its entry's only one, as in every rule table."""
    for d, entry in enumerate(spec):
        if "fsdp" in entry_axes(entry):
            if entry != "fsdp":
                raise NotImplementedError(
                    f"spec {spec!r}: fsdp shares its entry with another "
                    f"axis ({ITEM_8B})")
            return d
    return None


def gather_for_use(tree: Any, specs: Any, mesh: Optional[Mesh] = None,
                   dtype: Any = None) -> Any:
    """The gathers at use (the module docstring), every leaf in turn:

    - a layer view stacked over ``pipeline`` (``layers_for_use``) is
      broadcast from the stage that owns its layer over the ``pipeline``
      group, cast on the owner first to ``dtype``: one dtype for every
      leaf, or a tree shaped as ``tree`` holding a dtype or None (the
      leaf's own) a leaf.  The model names the dtype its block reads the
      leaf in, so that a leaf it reads in float32 (LayerNorm params, a
      router) crosses in float32, as the reference's gather keeps it;
    - then a leaf whose spec splits a dim over ``fsdp`` is all-gathered
      along it over the ``fsdp`` group (``collectives.all_gather_uneven``:
      each piece padded to the ceil size, gathered, the global dim cut
      back out of the spec's global ``shape``);
    - the others as they are.

    Differentiable: the broadcast's backward sums the ``pipeline`` ranks'
    gradients onto the owner, the all-gather's reduce-scatters the
    gradient of the gathered leaf (summed in float32, rounded once to
    the leaf's dtype) onto this rank's piece.  ``specs`` from
    ``use_specs`` (``layer_specs`` for a layer's view); ``mesh`` None:
    the ambient mesh.  Outside a mesh with ``fsdp`` or ``pipeline`` > 1
    the tree itself."""
    mesh = mesh if mesh is not None else get_ambient_mesh()
    if mesh is None or (mesh.shape.get("fsdp", 1) == 1
                        and mesh.shape.get("pipeline", 1) == 1):
        return tree
    from ray_tpu_torch.parallel import collectives as col

    def leaf(t: torch.Tensor, spec: PartitionSpec,
             dt: Optional[torch.dtype]) -> torch.Tensor:
        if spec.layer is not None and mesh.shape["pipeline"] > 1:
            stage, _ = layer_owner(spec, mesh)
            t = col.broadcast(t, "pipeline", stage,
                              t.shape if stage == mesh.coords["pipeline"]
                              else t.shape[1:], dt or t.dtype, mesh)
        d = fsdp_dim(spec) if mesh.shape["fsdp"] > 1 else None
        if d is None:
            return t
        if spec.shape is None:
            raise ValueError(
                f"gather_for_use: spec {spec!r} has no global shape (make "
                f"the specs with use_specs from the global tree)")
        dim = spec.shape[d]
        return col.all_gather_uneven(t, "fsdp", d, dim,
                                     -(-dim // mesh.shape["fsdp"]), mesh)

    dtypes = dtype if isinstance(dtype, (dict, list)) else \
        tx.tree_map(lambda _: dtype, tree)
    return tx.tree_map(leaf, tree, specs, dtypes)
