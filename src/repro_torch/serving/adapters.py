"""Multi-tenant adapter serving: one shared base, N registered (L + S)
adapters (port of ``repro/serving/adapters.py``).

SALAAD's factored deployment is a LoRA-style delta over a shared base: the
per-tenant ``(P, Vt, S)`` tables sit at the selected linear sites and every
other leaf is the base's. One pool of serving hardware therefore serves many
fine-tunes, with the adapter picked per request.

``AdapterRegistry``
    Host-side bookkeeping of the adapters registered over one base
    :class:`~repro_torch.serving.deployed.DeployedModel`. The base defines the
    site schema (its ``SLRLinear`` leaves, or the matmul leaves in the
    ``dense`` format); an adapter must equal the base at every other leaf.

``AdapterizedLinear``
    One pooled site: every pool row's tables stacked on a leading axis (rank
    padded to a common MAXR, sparse tables to a common MAXB or COO cap, which
    is exact: zero rank columns and dead slots add nothing), plus ``sel``,
    which the bank stamps per program call. Stacked fused sites flatten
    (adapter, layer) into one leading axis of A * L rows. Two modes:

      * ``batched`` (fused format): ``sel`` is the (S,) slot -> pool-row map
        on the device and ONE ``kernels.ops.slr_matmul_multi`` launch per site
        serves slots that run different adapters; the kernel reads the map;
      * ``grouped`` (dense, factored or fused): ``sel`` is one pool row (a
        host int), the engine runs one program per distinct adapter, and each
        site runs exactly the single-tenant tier's op on that row's tables.

``AdapterBank``
    A one-tier :class:`~repro_torch.serving.elastic.ModelBank` whose tier is
    the pooled tree. It owns a device pool of ``max_resident`` rows with LRU
    residency: ``acquire`` copies a non-resident adapter's tables into one
    pool row IN PLACE (pool shapes are fixed at :meth:`materialize`, so a
    bound tree sees the swap and nothing is reallocated), ``pin``/``unpin``
    keep streaming adapters resident, and ``bind`` stamps ``sel`` into every
    pooled site for one program call (one upload of the row map per call).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core import sparse
from ..core.selection import path_str
from ..kernels import ops
from ..kernels.slr_matmul import BsrStack
from ..tree import replace_by_path, tree_leaves_with_path, tree_map
from .deployed import _LINEAR_KEYS, DeployedModel
from .elastic import ModelBank, Tier
from .slr_params import SLRLinear

__all__ = ["AdapterBank", "AdapterError", "AdapterRegistry", "AdapterizedLinear",
           "adapterize"]


class AdapterError(RuntimeError):
    """Adapter lifecycle violation (unknown id, unregister while streaming,
    a registration after materialize that exceeds the pool's padded dims)."""


# ------------------------------------------------------------ pooled site ---


@dataclass
class AdapterizedLinear:
    """One pooled linear site; duck-typed like ``SLRLinear`` for the model
    walk (``at_layer``, ``apply``)."""

    w: torch.Tensor | None            # dense fmt: (A, [L,] n, m)
    p: torch.Tensor | None            # (A*L | A, n, MAXR) fused; (A, [L,] n, MAXR) factored
    vt: torch.Tensor | None
    s_coo: sparse.CooMatrix | None    # factored fmt: values/idx (A, [L,] cap)
    s_stack: BsrStack | None          # fused fmt: leading A*L (stacked) or A
    shape: tuple[int, int]
    fmt: str                          # 'dense' | 'factored' | 'fused'
    mode: str                         # 'batched' | 'grouped'
    stacked: bool                     # site lives inside the layer stack
    layers: int                       # L (1 for unstacked sites)
    sel: torch.Tensor | int | None = None   # stamped by AdapterBank.bind per call

    def at_layer(self, layer: int) -> "_AdapterLayerView":
        """Layer ``layer`` of a stacked site; the tables stay whole."""
        if not self.stacked:
            raise ValueError("at_layer on an unstacked pooled site")
        return _AdapterLayerView(self, layer)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Unstacked sites (e.g. a selected LM head) apply directly."""
        return self._apply(x, None)

    def _apply(self, x: torch.Tensor, layer: int | None) -> torch.Tensor:
        if self.sel is None:
            raise RuntimeError("AdapterBank.bind() must run before every program call")
        if self.mode == "grouped":
            return self._apply_grouped(x, layer)
        return self._apply_batched(x, layer)

    def _apply_batched(self, x: torch.Tensor, layer: int | None) -> torch.Tensor:
        # fused only: one per-slot kernel pass over (B, T, K), never flattened
        # across slots; the layer rides as a launch scalar
        if x.dim() != 3:
            raise ValueError(f"batched adapter sites take (B, T, K), got {tuple(x.shape)}")
        layers, lid = (self.layers, layer) if self.stacked else (1, 0)
        return ops.slr_matmul_multi(x.contiguous(), self.p, self.vt, self.s_stack, self.sel,
                                    layers, lid)

    def _apply_grouped(self, x: torch.Tensor, layer: int | None) -> torch.Tensor:
        # one adapter per program call: index the pool on the host and run
        # the single-tenant tier's op (the bitwise-parity path)
        a = int(self.sel)

        def idx(t):
            if t is None:
                return None
            t = t[a]
            return t if layer is None else t[layer]

        if self.fmt == "dense":
            return x @ idx(self.w)
        if self.fmt == "factored":
            coo = None
            if self.s_coo is not None:
                coo = sparse.CooMatrix(idx(self.s_coo.values), idx(self.s_coo.idx),
                                       self.s_coo.shape)
            return SLRLinear(p=idx(self.p), vt=idx(self.vt), s_coo=coo,
                             shape=self.shape).apply(x)
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        if self.stacked:
            y = ops.slr_matmul_stacked(flat, self.p, self.vt, self.s_stack,
                                       a * self.layers + layer)
        else:
            bsr = None if self.s_stack is None else self.s_stack.at_layer(a)
            y = ops.slr_matmul(flat, idx(self.p), idx(self.vt), bsr)
        return y.reshape(*x.shape[:-1], self.shape[1])


class _AdapterLayerView:
    """Layer ``layer`` of a stacked pooled site."""

    __slots__ = ("lin", "layer")

    def __init__(self, lin: AdapterizedLinear, layer: int):
        self.lin = lin
        self.layer = layer

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin._apply(x, self.layer)


def _is_pool_key(path: tuple) -> bool:
    return bool(path) and path[-1] in _LINEAR_KEYS


def adapterize(base: DeployedModel, model: DeployedModel) -> DeployedModel:
    """A fine-tuned deployment as a registrable adapter: the model's tree with
    every NON-SITE leaf replaced by the base's (SALAAD may select non-linear
    blocks such as the embedding, which deploy dense and differ per
    fine-tune; a multi-tenant bank shares them). Parity is defined against
    the returned model: it is what the bank serves."""
    if model.fmt != base.fmt:
        raise AdapterError(f"adapter fmt {model.fmt!r} != base fmt {base.fmt!r}")

    def merge(path, b, m):
        if isinstance(b, dict):
            if not isinstance(m, dict) or set(b) != set(m):
                raise AdapterError(f"adapter tree differs from the base at {path_str(path)}")
            return {k: merge(path + (k,), b[k], m[k]) for k in b}
        if base.fmt == "dense":
            return m if _is_pool_key(path) else b
        return m if isinstance(m, SLRLinear) else b

    return DeployedModel(model.cfg, merge((), base.params, model.params), model.fmt)


def _leaves_equal(a, b) -> bool:
    if a is b:
        return True
    return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b.to(a.device)))


def _leaf_dims(lin: SLRLinear) -> tuple[int, int, int, int | None]:
    """(live rank, BSR MAXB, COO cap, block size) of one SLRLinear."""
    r = 0 if lin.p is None else lin.p.shape[-1]
    maxb, bs = 0, None
    tab = lin.s_stack if lin.s_stack is not None else lin.s_bsr
    if tab is not None:
        maxb, bs = tab.rows.shape[-1], tab.block_size
    cap = 0 if lin.s_coo is None else lin.s_coo.values.shape[-1]
    return r, maxb, cap, bs


def _leading_dim(lin: SLRLinear) -> int:
    for part in (lin.p, lin.s_coo and lin.s_coo.values, lin.s_stack and lin.s_stack.counts):
        if part is not None:
            return part.shape[0]
    raise AdapterError(f"cannot infer the layer count of {lin}")


def _tensor_bytes(tree: Any) -> int:
    total = 0

    def add(t: torch.Tensor) -> torch.Tensor:
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    tree_map(add, tree)
    return total


# -------------------------------------------------------------- site spec ---


class _Site:
    """Padding schema and pool construction of ONE per-adapter site: ``observe``
    takes the max padded dims over the adapters registered before
    ``freeze``; ``pad`` turns one adapter's leaf into pool-row tables on the
    pool's device; ``build`` makes the pooled site and ``set_row`` swaps one
    row in place."""

    def __init__(self, key: str, base_leaf, fmt: str, mode: str, device: torch.device):
        self.key = key
        self.fmt = fmt
        self.mode = mode
        self.device = device
        if fmt == "dense":
            self.shape = tuple(base_leaf.shape[-2:])
            self.stacked = base_leaf.dim() == 3
            self.layers = base_leaf.shape[0] if self.stacked else 1
            self.dtype = base_leaf.dtype
        else:
            if not isinstance(base_leaf, SLRLinear):
                raise AdapterError(f"site {key}: expected an SLRLinear, got "
                                   f"{type(base_leaf).__name__}")
            self.shape = base_leaf.shape
            self.stacked = base_leaf.ndim == 3
            self.layers = _leading_dim(base_leaf) if self.stacked else 1
        self.maxr = self.maxb = self.cap = 0
        self.block_size: int | None = None
        self.any_sparse = False
        self.frozen = False
        # pool dtypes follow the adapters' own tables: an upcast would change
        # the products against the single-tenant path
        self.p_dtype = torch.float32
        self.s_dtype = torch.float32

    def check(self, leaf):
        """Validate one adapter's leaf against the schema; after ``freeze``
        its padded dims must fit the pool."""
        if self.fmt == "dense":
            want = (self.layers, *self.shape) if self.stacked else self.shape
            if tuple(leaf.shape) != tuple(want):
                raise AdapterError(f"site {self.key}: shape {tuple(leaf.shape)} != {want}")
            return
        if not isinstance(leaf, SLRLinear):
            raise AdapterError(f"site {self.key}: expected an SLRLinear, got "
                               f"{type(leaf).__name__}")
        if tuple(leaf.shape) != tuple(self.shape) or (leaf.ndim == 3) != self.stacked:
            raise AdapterError(f"site {self.key}: shape {leaf.shape} != {self.shape}")
        r, maxb, cap, bs = _leaf_dims(leaf)
        if bs is not None and self.block_size is not None and bs != self.block_size:
            raise AdapterError(f"site {self.key}: BSR block size {bs} != {self.block_size}")
        if self.frozen and (r > self.maxr or maxb > self.maxb or cap > self.cap):
            raise AdapterError(
                f"site {self.key}: adapter dims (r={r}, maxb={maxb}, cap={cap}) exceed the "
                f"frozen pool (r={self.maxr}, maxb={self.maxb}, cap={self.cap}); build the "
                "AdapterBank with this adapter registered up front")

    def observe(self, leaf):
        self.check(leaf)
        if self.fmt == "dense":
            return
        r, maxb, cap, bs = _leaf_dims(leaf)
        self.maxr = max(self.maxr, r)
        self.maxb = max(self.maxb, maxb)
        self.cap = max(self.cap, cap)
        if bs is not None:
            self.block_size = bs
        self.any_sparse = self.any_sparse or maxb > 0 or cap > 0
        if leaf.p is not None:
            self.p_dtype = leaf.p.dtype
        tab = leaf.s_stack if leaf.s_stack is not None else leaf.s_bsr
        if tab is not None:
            self.s_dtype = tab.vals.dtype
        elif leaf.s_coo is not None:
            self.s_dtype = leaf.s_coo.values.dtype

    def freeze(self):
        self.frozen = True

    def pad(self, leaf) -> dict[str, torch.Tensor]:
        """One adapter's leaf (``None``: an unoccupied row) as zero-padded
        pool-row tables on the pool's device."""
        if leaf is not None:
            self.check(leaf)
        n, m = self.shape
        lead = (self.layers,) if self.stacked else ()
        dev = self.device

        def zeros(shape, dtype):
            return torch.zeros((*lead, *shape), dtype=dtype, device=dev)

        if self.fmt == "dense":
            return {"w": zeros((n, m), self.dtype) if leaf is None
                    else leaf.to(dev, self.dtype)}
        out = {}
        if self.maxr:
            p, vt = zeros((n, self.maxr), self.p_dtype), zeros((self.maxr, m), self.p_dtype)
            if leaf is not None and leaf.p is not None:
                r = leaf.p.shape[-1]
                p[..., :r] = leaf.p
                vt[..., :r, :] = leaf.vt
            out["p"], out["vt"] = p, vt
        if self.fmt == "factored" and self.any_sparse:
            vals = zeros((self.cap,), self.s_dtype)
            idx = torch.full((*lead, self.cap), -1, dtype=torch.int32, device=dev)
            if leaf is not None and leaf.s_coo is not None:
                c = leaf.s_coo.values.shape[-1]
                vals[..., :c] = leaf.s_coo.values
                idx[..., :c] = leaf.s_coo.idx
            out["coo_vals"], out["coo_idx"] = vals, idx
        if self.fmt == "fused" and self.any_sparse:
            bs = self.block_size
            jb = -(-m // bs)
            counts = zeros((jb,), torch.int32)
            rows = zeros((jb, self.maxb), torch.int32)
            vals = zeros((jb, self.maxb, bs, bs), self.s_dtype)
            tab = None if leaf is None else (leaf.s_stack if self.stacked else leaf.s_bsr)
            if tab is not None:
                b = tab.rows.shape[-1]
                counts[...] = tab.counts
                rows[..., :b] = tab.rows
                vals[..., :b, :, :] = tab.vals
            out["counts"], out["rows"], out["vals"] = counts, rows, vals
        return out

    @property
    def _flat(self) -> bool:
        # fused pools flatten (adapter, layer) -> one leading A*L axis so the
        # kernels index row sel * L + layer directly
        return self.fmt == "fused" and self.stacked

    def build(self, row_leaves: list) -> AdapterizedLinear:
        """The pooled site over ``len(row_leaves)`` rows (``None`` rows hold
        zero tables and are never selected)."""
        tables = [self.pad(leaf) for leaf in row_leaves]

        def pool(field):
            if field not in tables[0]:
                return None
            stacked = torch.stack([t[field] for t in tables])
            return stacked.flatten(0, 1) if self._flat else stacked

        kw = dict(w=None, p=None, vt=None, s_coo=None, s_stack=None, shape=self.shape,
                  fmt=self.fmt, mode=self.mode, stacked=self.stacked, layers=self.layers)
        if self.fmt == "dense":
            kw["w"] = pool("w")
        else:
            kw["p"], kw["vt"] = pool("p"), pool("vt")
            if self.fmt == "factored" and self.any_sparse:
                kw["s_coo"] = sparse.CooMatrix(pool("coo_vals"), pool("coo_idx"), self.shape)
            if self.fmt == "fused" and self.any_sparse:
                kw["s_stack"] = BsrStack(pool("counts"), pool("rows"), pool("vals"),
                                         self.shape, self.block_size, empty=False)
        return AdapterizedLinear(**kw)

    def set_row(self, lin: AdapterizedLinear, row: int, leaf):
        """Copy one adapter's tables into pool row ``row`` in place, on the
        current stream: a later call that reads the row runs after the copy."""
        t = self.pad(leaf)
        span = slice(row * self.layers, (row + 1) * self.layers) if self._flat else row
        pools = {"w": lin.w, "p": lin.p, "vt": lin.vt}
        if lin.s_coo is not None:
            pools.update(coo_vals=lin.s_coo.values, coo_idx=lin.s_coo.idx)
        if lin.s_stack is not None:
            pools.update(counts=lin.s_stack.counts, rows=lin.s_stack.rows,
                         vals=lin.s_stack.vals)
        for field, pool in pools.items():
            if pool is not None:
                pool[span].copy_(t[field])


# --------------------------------------------------------------- registry ---


class AdapterRegistry:
    """Host-side adapter lifecycle over one shared base ``DeployedModel``.

    The per-adapter sites are the base's ``SLRLinear`` leaves (``factored``
    and ``fused``) or its matmul leaves ``q/k/v/o/gate/up/down/w``
    (``dense``); adapters must equal the base at every other leaf, so the
    shared base is stored once."""

    def __init__(self, base: DeployedModel):
        if not isinstance(base, DeployedModel):
            raise TypeError(f"base must be a DeployedModel, got {type(base)!r}")
        if base.fmt not in ("dense", "factored", "fused"):
            raise AdapterError(
                f"AdapterRegistry does not support fmt={base.fmt!r} (the 'bsr' unrolled "
                "format has per-matrix tables that cannot be pooled; deploy adapters as "
                "'fused' instead)")
        self.base = base
        self.fmt = base.fmt
        self.base_leaves = {path_str(p): v for p, v in tree_leaves_with_path(base.params)}
        self._site_paths = [
            path_str(p) for p, leaf in tree_leaves_with_path(base.params)
            if (_is_pool_key(p) if self.fmt == "dense" else isinstance(leaf, SLRLinear))]
        if not self._site_paths:
            raise AdapterError("base model has no per-adapter sites")
        self._adapters: OrderedDict[int, dict[str, Any]] = OrderedDict()
        self._names: dict[int, str] = {}
        self._next = 0

    def _extract(self, model: DeployedModel) -> dict[str, Any]:
        """Split one adapter into its site leaves, validating the shared rest."""
        if model.fmt != self.fmt:
            raise AdapterError(f"adapter fmt {model.fmt!r} != bank fmt {self.fmt!r}")
        sites = {}
        site_set = set(self._site_paths)
        for path, leaf in tree_leaves_with_path(model.params):
            key = path_str(path)
            if key in site_set:
                sites[key] = leaf
                continue
            ref = self.base_leaves.get(key)
            if ref is None or isinstance(leaf, SLRLinear) or not _leaves_equal(leaf, ref):
                raise AdapterError(
                    f"adapter differs from the base at non-site leaf {key}: only the SLR "
                    "linear sites may vary per adapter (same block selection as the base)")
        missing = [k for k in self._site_paths if k not in sites]
        if missing:
            raise AdapterError(f"adapter missing site leaves: {missing}")
        return sites

    def register(self, model: DeployedModel, name: str | None = None) -> int:
        sites = self._extract(model)
        aid = self._next
        self._next += 1
        self._adapters[aid] = sites
        self._names[aid] = name or f"adapter{aid}"
        return aid

    def unregister(self, aid: int):
        if aid not in self._adapters:
            raise AdapterError(f"unknown adapter id {aid}")
        del self._adapters[aid]
        del self._names[aid]

    def __contains__(self, aid) -> bool:
        return aid in self._adapters

    def __len__(self) -> int:
        return len(self._adapters)

    @property
    def ids(self) -> list[int]:
        return list(self._adapters)

    def name(self, aid: int) -> str:
        return self._names[aid]

    def sites(self, aid: int) -> dict[str, Any]:
        return self._adapters[aid]

    @property
    def site_paths(self) -> list[str]:
        return list(self._site_paths)


# ------------------------------------------------------------------- bank ---


class AdapterBank(ModelBank):
    """N registered (L + S) adapters over one shared base, served as ONE
    single-tier bank: engines read the pooled tree as tier 0 and bind each
    program call's adapter selection through :meth:`bind`.

    ``max_resident`` caps the device pool; the other registered adapters
    swap in LRU-first on demand (``acquire``). Pool shapes freeze at
    :meth:`materialize` (the engine calls it with
    ``EngineConfig.max_resident_adapters``)."""

    def __init__(self, base: DeployedModel, adapters=(), names=None, *,
                 max_resident: int | None = None, mode: str | None = None):
        self.registry = AdapterRegistry(base)
        names = list(names) if names is not None else [None] * len(adapters)
        if len(names) != len(adapters):
            raise ValueError(f"{len(adapters)} adapter(s) but {len(names)} name(s)")
        for model, name in zip(adapters, names):
            self.registry.register(model, name=name)
        if mode is None:
            mode = "batched" if base.fmt == "fused" else "grouped"
        if mode not in ("batched", "grouped"):
            raise ValueError(f"unknown adapter mode {mode!r}")
        if mode == "batched" and base.fmt != "fused":
            raise AdapterError(f"batched adapter mode needs the 'fused' format (one "
                               f"multi-adapter kernel); fmt={base.fmt!r} serves grouped")
        self.mode = mode
        self._max_resident = max_resident
        self._sites: list[_Site] = []
        self._pooled: dict[str, AdapterizedLinear] = {}
        self._device_tree = None
        self._pool_device: torch.device | None = None
        self._bytes = 0
        self._rows: list[int | None] = []
        self._row_of: dict[int, int] = {}
        self._pins: dict[int, int] = {}
        self._lru: OrderedDict[int, None] = OrderedDict()
        self.swaps = 0
        super().__init__(base.cfg, [base])

    # ------------------------------------------------------------ access ---

    @property
    def materialized(self) -> bool:
        return self._device_tree is not None

    @property
    def capacity(self) -> int:
        return len(self._rows)

    @property
    def default_adapter(self) -> int:
        ids = self.registry.ids
        if not ids:
            raise AdapterError("no adapters registered")
        return ids[0]

    @property
    def resident(self) -> list[int]:
        return [aid for aid in self._rows if aid is not None]

    # ------------------------------------------------------- materialize ---

    def materialize(self, max_resident: int | None = None) -> "AdapterBank":
        """Freeze the padded pool shapes and build the device pool, on the
        base's device. Idempotent for a matching capacity."""
        cap = max_resident or self._max_resident or len(self.registry)
        if self.materialized:
            if cap != self.capacity:
                raise AdapterError(f"bank already materialized with max_resident="
                                   f"{self.capacity}, re-requested {cap}")
            return self
        if len(self.registry) == 0:
            raise AdapterError("register at least one adapter first")
        if cap < 1:
            raise ValueError(f"max_resident must be >= 1, got {cap}")
        self._max_resident = cap
        base = self.registry.base
        device = next(t.device for _, t in tree_leaves_with_path(base.params)
                      if isinstance(t, torch.Tensor))
        self._pool_device = device
        for key in self.registry.site_paths:
            site = _Site(key, self.registry.base_leaves[key], self.registry.fmt, self.mode,
                         device)
            for aid in self.registry.ids:
                site.observe(self.registry.sites(aid)[key])
            site.freeze()
            if site.fmt != "dense" and not site.maxr and not site.any_sparse:
                # every adapter's tables here are empty (e.g. an all-zero SLR
                # state): the site is zero for all tenants, keep the base leaf
                continue
            self._sites.append(site)

        residents = self.registry.ids[:cap]
        self._rows = residents + [None] * (cap - len(residents))
        self._row_of = {aid: i for i, aid in enumerate(residents)}
        self._lru = OrderedDict((aid, None) for aid in residents)
        site_by_key = {s.key: s for s in self._sites}

        def build_leaf(path, leaf):
            site = site_by_key.get(path_str(path))
            if site is None:
                return leaf
            lin = site.build([None if aid is None else self.registry.sites(aid)[site.key]
                              for aid in self._rows])
            self._pooled[site.key] = lin
            return lin

        self._device_tree = replace_by_path(base.params, build_leaf)
        self._bytes = _tensor_bytes(self._device_tree)   # before any bind stamps sel
        model = DeployedModel(self.cfg, self._device_tree, fmt=self.registry.fmt)
        self._tiers = [Tier(index=0, name="adapters", keep=None, model=model,
                            param_bytes=self._bytes)]
        return self

    # --------------------------------------------------------- residency ---

    def acquire(self, aid: int) -> tuple[int | None, bool]:
        """Pool row of ``aid``, swapping its tables in if it is not resident
        (LRU victim among unpinned rows). Returns ``(row, swapped)``;
        ``(None, False)`` means every row is pinned: keep the request queued."""
        if aid not in self.registry:
            raise AdapterError(f"unknown adapter id {aid}")
        if not self.materialized:
            raise AdapterError("materialize() the bank first")
        row = self._row_of.get(aid)
        if row is not None:
            self._lru.move_to_end(aid)
            return row, False
        row = self._victim_row()
        if row is None:
            return None, False
        old = self._rows[row]
        if old is not None:
            del self._row_of[old]
            self._lru.pop(old, None)
        sites = self.registry.sites(aid)
        for site in self._sites:
            site.set_row(self._pooled[site.key], row, sites[site.key])
        self._rows[row] = aid
        self._row_of[aid] = row
        self._lru[aid] = None
        self.swaps += 1
        return row, True

    def _victim_row(self) -> int | None:
        for i, aid in enumerate(self._rows):
            if aid is None:
                return i
        for aid in self._lru:   # least recent first
            if not self._pins.get(aid):
                return self._row_of[aid]
        return None

    def pin(self, aid: int):
        self._pins[aid] = self._pins.get(aid, 0) + 1

    def unpin(self, aid: int):
        n = self._pins.get(aid, 0) - 1
        if n <= 0:
            self._pins.pop(aid, None)
        else:
            self._pins[aid] = n

    # --------------------------------------------------------- lifecycle ---

    def register(self, model: DeployedModel, name: str | None = None) -> int:
        """Register an adapter (resident on demand); after materialize its
        padded dims must fit the frozen pool."""
        if self.materialized:
            sites = self.registry._extract(model)
            for site in self._sites:
                site.check(sites[site.key])
        return self.registry.register(model, name=name)

    def unregister(self, aid: int):
        """Remove an adapter; ``AdapterError`` while any slot streams with it."""
        if self._pins.get(aid):
            raise AdapterError(f"adapter {aid} is streaming on {self._pins[aid]} slot(s); "
                               "drain it before unregistering")
        self.registry.unregister(aid)
        row = self._row_of.pop(aid, None)
        if row is not None:
            self._rows[row] = None
            self._lru.pop(aid, None)

    # -------------------------------------------------------------- bind ---

    def bind(self, sel) -> Any:
        """The pooled tree with ``sel`` stamped into every pooled site for ONE
        program call: an (S,) slot -> pool-row map, uploaded once (batched),
        or one pool row (grouped). The stamp is in place, so a tree bound
        earlier follows the latest bind."""
        if not self.materialized:
            raise AdapterError("materialize() the bank first")
        if self.mode == "grouped":
            sel = int(sel)
        else:
            sel = torch.tensor(np.asarray(sel), dtype=torch.int32, device=self._pool_device)
        for lin in self._pooled.values():
            lin.sel = sel
        return self._device_tree

    # -------------------------------------------------------- accounting ---

    def adapter_report(self) -> dict:
        return {
            "fmt": self.registry.fmt,
            "mode": self.mode,
            "registered": len(self.registry),
            "capacity": self.capacity,
            "resident": self.resident,
            "swaps": self.swaps,
            "pool_bytes": self._bytes,
            "sites": len(self._sites),
        }

    def report(self) -> dict:
        out = super().report()
        out["adapters"] = self.adapter_report()
        return out
