"""Sharding rules and the mesh of ranks (port of
``repro/parallel/sharding.py``).

The rules are pure functions over a mesh's axis sizes (a ``{"data": D,
"model": M}`` dict, or a :class:`ServingMesh`): a spec is a tuple with one
entry per dim of the leaf, ``"model"``, ``"data"`` or None (split over that
axis, or whole), and ``()`` means replicated, as ``PartitionSpec()`` does in
the JAX package. ``param_spec`` is the training placement, ``serving_param_spec``
the serving one, ``kv_cache_spec`` the KV pools' (the head axis over
``"model"``).

:class:`ServingMesh` is a data x model grid of the ranks of an initialised
``torch.distributed`` process group: rank ``r < data * model`` sits at data
row ``r // model`` and model column ``r % model``; each model row and each
data column has its own subgroup. The JAX package leaves the collectives to
GSPMD (``constrain`` is a placement hint); here they are explicit calls at
the sites that need them:

  * column-parallel sites (q/k/v/gate/up, and ``lm_head/w`` over the
    vocabulary) hold their output columns, or for SLR factors ``vt``'s
    columns; no collective, but the head gathers its logits;
  * row-parallel sites (o/down) hold their input rows, or ``p``'s rows, and
    wrap them in :class:`RowParallel`, whose products are summed over the
    model row (gathered, then added in model order);
  * the embedding holds its d_model columns (:class:`ShardedEmbedding`); a
    lookup gathers them back;
  * factored S stays whole on every rank (the COO tables are replicated, as
    in the JAX package); each rank applies the block of S in its rows or
    columns (``SLRLinear.block``);
  * the data axis splits the batch rows inside the forward
    (``models/transformer.py``): each data column computes its share of the
    rows, the new K/V rows of every layer are gathered so the pools stay
    replicated over data, as the JAX package's pools are, and the logits are
    gathered at the end;
  * MoE experts split on their E axis (``experts`` role): rank ``j`` of a
    model row holds experts ``[j E/m, (j+1) E/m)`` and ``models/moe.py``
    sums the ranks' per-pair outputs over the row.

Training under a mesh (``data = N``, ``model = 1``) splits the batch by
``batch_shardings``' rule instead: a rank takes ``n / N`` rows where N
divides them, else the whole batch (:class:`BatchShard`), and the train step
averages the gradients over the data column (``all_reduce_data``).

Leaves the JAX placement splits but a rank reads whole (the norm scales,
``down_bias``: GSPMD gathers them again at every use) are held whole.

**Backend rule.** NCCL where each rank has a card of its own, gloo where the
ranks share one card or run on the CPU (``pick_backend``), chosen before the
group starts. Under gloo, collectives on CUDA tensors are staged through host
memory (``ServingMesh.collectives`` says which path is taken).
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..models.layers import apply_weight
from ..tree import replace_by_path, tree_leaves_with_path, tree_map

__all__ = [
    "param_spec",
    "serving_param_spec",
    "kv_cache_spec",
    "parse_mesh_spec",
    "pick_backend",
    "ServingMesh",
    "RowSplit",
    "RowParallel",
    "ColumnGather",
    "ShardedEmbedding",
    "current_mesh",
    "serving_leaves",
    "dp_axes",
    "dp_size",
    "batch_shardings",
    "BatchSharding",
    "BatchShard",
    "LocalRows",
]


# --------------------------------------------------------- parameter rules --

# (path regex) -> logical spec for the trailing dims; leading stacked dims are
# unsharded (None). First match wins. The JAX package's table, unchanged.
_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    (r"experts/(gate|up|w1|w3)$", ("model", "data", None)),
    (r"experts/(down|w2)$", ("model", "data", None)),
    (r"router$", (None, None)),
    (r"(^|/)(q|k|v)$", ("data", "model")),
    (r"(^|/)o$", ("model", "data")),
    (r"(gate|up)$", ("data", "model")),
    (r"down$", ("model", "data")),
    (r"in_proj$", ("data", "model")),
    (r"out_proj$", ("model", "data")),
    (r"(x_proj|dt_proj)$", ("data", "model")),
    (r"embedding$", (None, "model")),
    (r"lm_head/w$", (None, "model")),
    (r".*", ("data", "model")),
]

# SLRLinear fields holding index-addressed sparse tables: replicated
_SLR_TABLE_FIELDS = frozenset({"s_coo", "s_bsr", "s_stack"})


def _sizes(mesh) -> dict[str, int]:
    """Axis sizes of a ServingMesh or of a ``{axis: size}`` mapping."""
    return dict(mesh.shape) if isinstance(mesh, ServingMesh) else dict(mesh)


def _rule_tail(name: str) -> tuple[str | None, ...]:
    for pat, logical in _RULES:
        if re.search(pat, name):
            return logical
    return ("data", "model")


def _resolve_tail(shape: tuple[int, ...], tail: tuple[str | None, ...],
                  sizes: Mapping[str, int], *, drop_data: bool = False) -> tuple:
    """A logical tail against the axis sizes: leading stacked dims whole, an
    axis the mesh lacks or that does not divide its dim dropped, ``"data"``
    dropped under ``drop_data`` (serving keeps weights whole over data)."""
    full = (None,) * (len(shape) - len(tail)) + tuple(tail)
    out = []
    for dim, ax in zip(shape, full):
        if ax is None or (drop_data and ax == "data") or ax not in sizes:
            out.append(None)
            continue
        out.append(ax if dim % sizes[ax] == 0 else None)
    return tuple(out)


def param_spec(name: str, shape: tuple[int, ...], mesh) -> tuple:
    """The training placement of a parameter leaf, by path and shape."""
    if len(shape) < 2:
        return ()
    return _resolve_tail(tuple(shape), _rule_tail(name), _sizes(mesh))


def serving_param_spec(name: str, shape: tuple[int, ...], mesh) -> tuple:
    """The serving placement of one leaf, dense or a field of an
    ``SLRLinear``: weights split over ``"model"`` only; ``p`` takes the dense
    weight's row axis and ``vt`` its column axis (the rank dim is never
    split); sparse tables are replicated."""
    sizes = _sizes(mesh)
    parts = name.split("/")
    last = parts[-1]
    if last in ("p", "vt") and len(parts) > 1:
        if len(shape) < 2:
            return ()
        row, col = _rule_tail("/".join(parts[:-1]))[-2:]
        sub = (row, None) if last == "p" else (None, col)
        return _resolve_tail(tuple(shape), sub, sizes, drop_data=True)
    if any(f in parts for f in _SLR_TABLE_FIELDS):
        return ()
    if len(shape) < 2:
        return ()
    return _resolve_tail(tuple(shape), _rule_tail(name), sizes, drop_data=True)


def kv_cache_spec(shape: tuple[int, ...], mesh) -> tuple:
    """The placement of one KV cache leaf: 5-D payload and scale pools
    ((L, pages, H, bs, D) or (L, B, H, S, D)) split the head axis over
    ``"model"`` when it divides; block tables and lengths are replicated."""
    m = _sizes(mesh).get("model", 1)
    if len(shape) == 5 and m > 1 and shape[2] % m == 0:
        return (None, None, "model", None, None)
    return ()


def serving_leaves(tree: Any):
    """(name, tensor) of every leaf of a serving parameter tree, descending
    into deployed weights (``SLRLinear``'s ``p``, ``vt`` and table fields, a
    COO matrix's ``values`` and ``idx``); names are the JAX package's
    ``path_str`` paths."""
    def walk(name, obj):
        if isinstance(obj, torch.Tensor):
            yield name, obj
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                yield from walk(f"{name}/{f.name}", getattr(obj, f.name))

    for path, leaf in tree_leaves_with_path(tree):
        yield from walk("/".join(str(p) for p in path), leaf)


# ------------------------------------------------------------ mesh specs --


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """``"model=N,data=M"`` -> axis sizes (missing axes are 1). Pure string
    validation: no process group is touched."""
    sizes = {"data": 1, "model": 1}
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        key, eq, val = tok.partition("=")
        key = key.strip()
        if not eq or key not in sizes:
            raise ValueError(f"mesh={spec!r} must be comma-separated axis=N terms with axis "
                             f"in ('data', 'model'); got {tok!r}")
        try:
            n = int(val)
        except ValueError:
            n = 0
        if n < 1:
            raise ValueError(f"mesh={spec!r}: size for {key!r} must be a positive int")
        sizes[key] = n
    return sizes


def pick_backend(world_size: int, device) -> str:
    """NCCL when every rank can have a card of its own, else gloo (ranks that
    share one card, or the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


# the ``with mesh:`` stack (the JAX package's ``with mesh:`` context)
_ACTIVE: list["ServingMesh"] = []
# (data, model) -> (default group, mesh over it): a grid's subgroups are made
# once per group (``new_group`` is collective over every rank), then reused;
# holding the group keeps a later group from being mistaken for it
_MESHES: dict[tuple[int, int], tuple] = {}


def current_mesh() -> "ServingMesh | None":
    """The mesh of the innermost ``with mesh:`` block, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class ServingMesh:
    """The ("data", "model") grid of ranks for serving, with its rules and
    collectives. Build it through :meth:`create` or :meth:`from_spec` on
    every rank of the group, in the same order (subgroups are collective to
    make); a rank outside the grid (``member`` False) only takes part in
    that. Used as a context manager it is the forward's ``current_mesh()``.
    """

    AXES = ("data", "model")

    def __init__(self, data: int, model: int):
        self.data = data
        self.model = model
        initialised = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if initialised else 1
        self.rank = dist.get_rank() if initialised else 0
        self.backend = dist.get_backend() if initialised else None
        self.member = self.rank < data * model
        self.data_index = self.rank // model if self.member else None
        self.model_index = self.rank % model if self.member else None
        self._model_group = self._data_group = self._mesh_group = None
        if self.world > 1:
            for d in range(data if model > 1 else 0):
                g = dist.new_group([d * model + j for j in range(model)])
                if self.data_index == d:
                    self._model_group = g
            for j in range(model if data > 1 else 0):
                g = dist.new_group([d * model + j for d in range(data)])
                if self.model_index == j:
                    self._data_group = g
            need = data * model
            self._mesh_group = dist.new_group(list(range(need))) if need < self.world \
                else dist.group.WORLD

    @classmethod
    def create(cls, *, data: int = 1, model: int = 1) -> "ServingMesh":
        """The mesh over the first ``data * model`` ranks of the default
        group (one rank and no group when both are 1)."""
        need = data * model
        initialised = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialised else 1
        if need > world:
            raise ValueError(f"mesh data*model={need} exceeds the {world} available "
                             f"device(s) (ranks of the process group)")
        world_group = dist.group.WORLD if initialised else None
        cached = _MESHES.get((data, model))
        if cached is None or cached[0] is not world_group:
            cached = _MESHES[data, model] = (world_group, cls(data, model))
        return cached[1]

    @classmethod
    def from_spec(cls, spec: str) -> "ServingMesh":
        sizes = parse_mesh_spec(spec)
        return cls.create(data=sizes["data"], model=sizes["model"])

    # ------------------------------------------------------------ topology --

    @property
    def model_size(self) -> int:
        return self.model

    @property
    def data_size(self) -> int:
        return self.data

    @property
    def num_devices(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    def describe(self) -> dict:
        """JSON-safe topology record (``engine_provenance``)."""
        return {"axis_names": list(self.AXES), "shape": self.shape,
                "num_devices": self.num_devices}

    @property
    def collectives(self) -> str:
        """The collective path: the backend, and for gloo that CUDA tensors
        are staged through host memory."""
        if self.backend is None:
            return "none (one rank)"
        if self.backend == "gloo":
            return "gloo (CUDA tensors staged through host memory)"
        return self.backend

    # ------------------------------------------------------------ shardings --

    def params_shardings(self, tree: Any) -> dict[str, tuple]:
        """``serving_param_spec`` of every leaf, by name."""
        return {name: serving_param_spec(name, tuple(t.shape), self)
                for name, t in serving_leaves(tree)}

    def cache_shardings(self, cache) -> dict[str, tuple]:
        """``kv_cache_spec`` of every tensor field of a KV cache, by field."""
        return {f: kv_cache_spec(tuple(getattr(cache, f).shape), self)
                for f in cache._fields if isinstance(getattr(cache, f), torch.Tensor)}

    def local_cfg(self, cfg):
        """The arch config this rank runs: ``1/model`` of the query and KV
        heads (whole GQA groups)."""
        if self.model == 1:
            return cfg
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // self.model,
                                   num_kv_heads=cfg.num_kv_heads // self.model)

    def _bounds(self, n: int) -> tuple[int, int]:
        per = n // self.model
        return self.model_index * per, (self.model_index + 1) * per

    def local_tree(self, tree: Any, placed: dict[int, Any] | None = None) -> Any:
        """This rank's pieces of a full serving tree (dense or factored
        format). ``placed`` maps ``id(leaf)`` to a piece already made: a leaf
        shared by several tiers is sliced once and reused. Every piece lands
        on the device of the tree's embedding: a tree whose other leaves are
        held on the host (memory-mapped from ``torch.load(mmap=True)``)
        copies only this rank's pieces to the card."""
        if self.model == 1:
            return tree
        placed = {} if placed is None else placed
        emb = tree.get("embed", {}).get("embedding") if isinstance(tree, Mapping) else None
        device = getattr(emb, "device", None)

        def one(path, leaf):
            key = id(leaf)
            if key not in placed:
                piece = self._local_leaf("/".join(str(p) for p in path), leaf)
                if device is not None:
                    piece = tree_map(lambda t: t.to(device), piece)
                placed[key] = piece
            return placed[key]

        return replace_by_path(tree, one)

    def _local_leaf(self, name: str, leaf):
        from ..serving.slr_params import SLRLinear

        role = _role(name)
        if role is None:
            return leaf
        if isinstance(leaf, SLRLinear):
            if leaf.fuse or leaf.s_bsr is not None or leaf.s_stack is not None:
                raise ValueError(f"{name}: block-CSC tables cannot split over the model axis")
            return self._local_slr(name, leaf, role)
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(f"{name}: {type(leaf).__name__} cannot split over the model axis")
        spec = serving_param_spec(name, tuple(leaf.shape), self)
        if "model" not in spec:
            return leaf
        dim = spec.index("model")
        lo, hi = self._bounds(leaf.shape[dim])
        piece = _owned(leaf.narrow(dim, lo, hi - lo))
        if role == "row":
            return RowParallel(piece, self)
        if role == "head":
            return ColumnGather(piece, self)
        if role == "embedding":
            return ShardedEmbedding(piece, self, lo, hi)
        return piece

    def _local_slr(self, name: str, lin, role: str):
        n, m = lin.shape
        stack = (lin.ndim - 2) * (1,)
        spec = serving_param_spec(name, stack + (n, m), self)
        if "model" not in spec:
            return lin
        if role == "row":
            lo, hi = self._bounds(n)
            p = None if lin.p is None else _owned(lin.p.narrow(-2, lo, hi - lo))
            local = dataclasses.replace(lin, p=p, shape=(hi - lo, m), block=(lo, hi, 0, m))
            return RowParallel(local, self)
        lo, hi = self._bounds(m)
        vt = None if lin.vt is None else _owned(lin.vt.narrow(-1, lo, hi - lo))
        local = dataclasses.replace(lin, vt=vt, shape=(n, hi - lo), block=(0, n, lo, hi))
        return ColumnGather(local, self) if role == "head" else local

    def place_tiers(self, trees: list) -> list:
        """Every tier's local tree over ONE set of pieces: leaves shared
        across tiers (by identity) are sliced once per rank and reused."""
        placed: dict[int, Any] = {}
        return [self.local_tree(t, placed) for t in trees]

    # ---------------------------------------------------------- collectives --

    def _staged(self, x: torch.Tensor, op):
        if self.backend == "gloo" and x.is_cuda:
            return op(x.cpu()).to(x.device)
        return op(x.contiguous())

    def _sum_in_order(self, x: torch.Tensor, group, size: int) -> torch.Tensor:
        def op(t):
            parts = [torch.empty_like(t) for _ in range(size)]
            dist.all_gather(parts, t, group=group)
            return functools.reduce(torch.add, parts)

        return self._staged(x, op)

    def all_reduce_data(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over the data column, gathered and added in data order
        (the same bits on every rank): the data-parallel gradient sum."""
        if self.data == 1:
            return x
        return self._sum_in_order(x, self._data_group, self.data)

    def all_reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over the model row (the row-parallel product's partials),
        added in model order after an all-gather: the same bits on every
        rank whatever the backend's reduction order, and on gloo half the
        sequential hops of its all-reduce (PERF.md §6)."""
        if self.model == 1:
            return x
        return self._sum_in_order(x, self._model_group, self.model)

    def _gather(self, x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
        def op(t):
            parts = [torch.empty_like(t) for _ in range(size)]
            dist.all_gather(parts, t, group=group)
            return torch.cat(parts, dim=dim)

        return self._staged(x, op)

    def all_gather_model(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """x's pieces of the model row, concatenated along ``dim`` in model
        order."""
        if self.model == 1:
            return x
        return self._gather(x, dim, self._model_group, self.model)

    def all_gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """x's pieces of the data column, concatenated along ``dim`` in data
        order."""
        if self.data == 1:
            return x
        return self._gather(x, dim, self._data_group, self.data)

    def row_split(self, n: int) -> "RowSplit | None":
        """This rank's share of a batch of ``n`` rows in the forward (None
        without a data axis)."""
        return RowSplit(self, n) if self.data > 1 else None

    def barrier(self) -> None:
        """Every rank of the grid waits for the others."""
        if self._mesh_group is not None:
            dist.barrier(group=self._mesh_group)

    def gather_object(self, obj) -> list:
        """``obj`` of every rank of the grid, in rank order."""
        if self._mesh_group is None:
            return [obj]
        out = [None] * self.num_devices
        dist.all_gather_object(out, obj, group=self._mesh_group)
        return out

    # -------------------------------------------------------------- context --

    def __enter__(self) -> "ServingMesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def _role(name: str) -> str | None:
    """How this rank's compute consumes a split leaf: ``column`` (its output
    columns), ``row`` (its input rows, partials summed), ``head`` (vocabulary
    columns, logits gathered), ``embedding`` (d_model columns, lookups
    gathered), ``experts`` (the E axis, no wrapper: ``models/moe.py`` sums
    the ranks' outputs), or None (held whole)."""
    if re.search(r"(^|/)experts/(gate|up|down|w1|w2|w3)$", name):
        return "experts"
    if re.search(r"(^|/)(o|down)$", name):
        return "row"
    if re.search(r"(^|/)lm_head/w$", name):
        return "head"
    if re.search(r"(^|/)embedding$", name):
        return "embedding"
    if re.search(r"(^|/)(q|k|v|gate|up)(_bias)?$", name):
        return "column"
    return None


def _owned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of a slice, so the full tensor is not kept alive."""
    return torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)


def _at_layer(w, layer: int):
    return w.at_layer(layer) if hasattr(w, "at_layer") else w[layer]


@dataclasses.dataclass(eq=False)
class RowParallel:
    """A row-parallel site (o, down): this rank's input rows of the weight
    (a tensor or an ``SLRLinear``); the products are summed over the model
    row."""

    w: Any
    mesh: ServingMesh

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce_model(apply_weight(x, self.w))

    def at_layer(self, layer: int) -> "RowParallel":
        return RowParallel(_at_layer(self.w, layer), self.mesh)


@dataclasses.dataclass(eq=False)
class ColumnGather:
    """The output head split over the vocabulary: this rank's columns, the
    logits gathered over the model row (the sampler sees them whole)."""

    w: Any
    mesh: ServingMesh

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather_model(apply_weight(x, self.w), dim=-1)


@dataclasses.dataclass(eq=False)
class ShardedEmbedding:
    """The embedding's d_model columns ``lo:hi`` of this rank: a lookup
    gathers the columns over the model row; ``.T`` (a tied head) is
    row-parallel over them."""

    table: torch.Tensor
    mesh: ServingMesh
    lo: int
    hi: int

    def __getitem__(self, tokens) -> torch.Tensor:
        return self.mesh.all_gather_model(self.table[tokens], dim=-1)

    @property
    def T(self):
        return _TiedHead(self)

    @property
    def device(self) -> torch.device:
        return self.table.device


class _TiedHead:
    __slots__ = ("emb",)

    def __init__(self, emb: ShardedEmbedding):
        self.emb = emb

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        e = self.emb
        return e.mesh.all_reduce_model(x[..., e.lo:e.hi] @ e.table.T)


class RowSplit:
    """A data column's share of a batch of ``n`` rows: ``ceil(n / data)``
    rows from ``data_index * ceil(n / data)``, the ones past ``n`` repeating
    row ``n - 1`` (computed and dropped). ``gather`` concatenates the
    column's shares and drops them."""

    # the rows are a share of a batch spread over the data column (the MoE's
    # capacity and load-balance statistics then combine the column's)
    spread = True

    def __init__(self, mesh: ServingMesh, n: int):
        self.mesh, self.n = mesh, n
        per = -(-n // mesh.data_size)
        start = mesh.data_index * per
        self.idx = np.minimum(np.arange(start, start + per), n - 1)
        self.real = np.arange(start, start + per) < n
        self._dev: dict = {}

    def live(self, device) -> torch.Tensor:
        """(rows,) bool: False on the rows repeating row ``n - 1``."""
        key = ("live", device)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.real).to(device)
        return self._dev[key]

    def _index(self, device) -> torch.Tensor:
        if device not in self._dev:
            self._dev[device] = torch.from_numpy(self.idx).to(device)
        return self._dev[device]

    def take(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of t (rows along ``dim``)."""
        return t.index_select(dim, self._index(t.device))

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's rows of t, in row order (the inverse of ``take``)."""
        return self.mesh.all_gather_data(t, dim).narrow(dim, 0, self.n)


class BatchShard:
    """A data rank's rows of a global training batch of ``n`` rows, by
    ``batch_shardings``' rule: rows ``[i n/N, (i+1) n/N)`` of data rank i
    where N divides n, else all n on every rank. :meth:`select` cuts a
    global batch leaf. The train step passes it to the forward (``rows=``)
    where a :class:`RowSplit` would stand: the step has already cut the
    batch, so ``take`` and ``gather`` are the identity, and ``spread`` tells
    the MoE to combine its statistics over the data column."""

    def __init__(self, mesh: ServingMesh, n: int):
        self.mesh, self.n = mesh, n
        dp = mesh.data_size
        self.spread = dp > 1 and n % dp == 0
        per = n // dp if self.spread else n
        self.lo = mesh.data_index * per if self.spread else 0
        self.hi = self.lo + per

    def select(self, t, dim: int = 0):
        """This rank's rows of a global batch leaf (a tensor or an array)."""
        if not self.spread:
            return t
        if isinstance(t, torch.Tensor):
            return t.narrow(dim, self.lo, self.hi - self.lo)
        return np.take(np.asarray(t), np.arange(self.lo, self.hi), axis=dim)

    def take(self, t, dim: int = 0):
        return t

    def gather(self, t, dim: int = 0):
        return t

    def live(self, device) -> torch.Tensor:
        return torch.ones(self.hi - self.lo, dtype=torch.bool, device=device)


class LocalRows(dict):
    """A batch holding only this rank's rows of a global batch of ``n`` rows
    (``DevicePrefetcher(shardings=...)`` yields these; the train step takes
    them as they are)."""

    def __init__(self, leaves: dict, n: int):
        super().__init__(leaves)
        self.n = n


# ------------------------------------------------- training batch placement --


def dp_axes(mesh) -> tuple[str, ...] | None:
    """The batch-carrying axes of the mesh (the port's meshes have no pod
    axis: ``("data",)``)."""
    return ("data",) if "data" in _sizes(mesh) else None


def dp_size(mesh) -> int:
    return int(_sizes(mesh).get("data", 1))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The placement of one batch leaf: ``spec`` (``("data", None, ...)``,
    the leading dim split over data, or all None, whole) over ``mesh``."""

    mesh: ServingMesh
    spec: tuple

    def take(self, leaf):
        """This rank's rows of a global batch leaf."""
        if self.spec[0] is None:
            return leaf
        return BatchShard(self.mesh, leaf.shape[0]).select(leaf)


def batch_shardings(specs: dict, mesh: ServingMesh) -> dict:
    """Leading-dim (batch) placements for a dict of batch leaves (anything
    with ``.shape``): over data where the data size divides the rows, else
    whole, as in the JAX package."""
    dpn = dp_size(mesh)
    out = {}
    for k, v in specs.items():
        ax0 = "data" if v.shape[0] % dpn == 0 else None
        out[k] = BatchSharding(mesh, (ax0,) + (None,) * (len(v.shape) - 1))
    return out
