"""Batched serving engines: continuous batching over a bank of budget tiers
(port of ``repro/serving/engine.py``: ``ServingEngine``,
``PagedServingEngine`` and ``ReferenceEngine``).

Two batched engines share one scheduler skeleton, the base class's ``step``:
admit queued requests (earliest deadline first), refresh each slot's
effective tier, advance mid-prefill slots, grow pages, then one decode per
active tier over the shared cache, each masked to that tier's slots. Every
tier of a :class:`~repro_torch.serving.elastic.ModelBank` serves over the one
cache: it carries no tier.

``ServingEngine`` is slot-padded: a decode batch of ``max_slots`` rows over
one contiguous cache in which every slot reserves ``max_len`` positions, with
per-slot ``(max_slots,)`` lengths. Admission prefills each tier group in one
no-cache forward over a length bucket (the flash attention kernel under
``kernel_impl='pallas'``) and copies the rows into the slots; decode inserts
each row's token at its own length and attends by masked einsum (no kernel,
as in the JAX package). Padded prefill rows and inactive slots never reach a
write outside the cache: the prefill copies only the group's rows (the host
knows them), and ``models/attention.py::contiguous_insert`` drops positions
past the buffer without a host sync.

``PagedServingEngine`` subclasses it and overrides the hooks: KV lives in a
fixed pool of ``num_blocks`` pages of ``block_size`` tokens
(``models.transformer.PagedKVCache``) that a host-side
:class:`BlockAllocator` hands to slots on demand. With the prefix cache on,
matching full prompt pages attach read-only and only the suffix is
prefilled; a hit whose first write lands inside an attached page copies that
page first (copy-on-write, one page-copy kernel call per tick). Under
``tier_policy='pressure'`` the tier controller downshifts the serving tier
from the pool's free (and reclaimable) pages before any eviction;
``prefill_chunk`` advances mid-prefill slots one chunk per tick; a dry pool
evicts a victim back to the queue (it resumes by re-prefilling, or by
reattaching the pages it published). Without ``prefill_chunk`` an admission
prefills the whole prompt in one no-cache forward and scatters whole pages.

Tokens are greedy, or with ``greedy=False`` sampled at ``temperature`` by
Gumbel-max on the device (``_sample``): the noise is a pure function of
``(seed, engine step, salt, slot id, vocab index)`` (``keyed_uniform``, a
counter-based integer hash), so a slot's stream does not depend on the batch
or its row order, and decode (salt 0), prefill and chunk ends (salt 1) and
the speculative engine's draft steps (``2 + i``) and verify (``2 + k``) never
share noise. ``kv_dtype='int8'`` stores quantized pages with per-(position,
head) scales (``serving/kv_quant.py``), paged engine only.
``serving/speculative.py`` subclasses the paged engine.

Multi-tenant adapters (``serving/adapters.py``): an engine built on an
:class:`~repro_torch.serving.adapters.AdapterBank` with
``EngineConfig(adapters=True)`` serves N registered (L + S) adapters over one
shared base. A request picks its adapter at ``submit``; admission pins it
into the bank's device pool (an LRU swap when it is not resident). In
``batched`` mode one program call serves slots that run different adapters
(the per-slot SLR kernel reads the slot -> pool-row map on the device); in
``grouped`` mode the engine runs one call per (tier, pool row). With the
prefix cache on, each adapter has its own radix index over the one shared
allocator.

Observability (``serving/telemetry.py``, ``serving/trace.py``): every engine
keeps an :class:`~repro_torch.serving.telemetry.EngineTelemetry` registry
(``EngineConfig(telemetry=True)``, the default; False makes every hook a
no-op) and, with ``trace=True`` or ``start_trace()``, a request tracer. The
counters (evictions, tier switches, downshift ticks, prefix-cache events,
adapter swaps and tokens) are read-only views over the registry. Each program
call (``prefill[{bucket}]``, ``decode``, ``chunk[{width}]``,
``page_copy[{n}]``) is timed with its host fetch, and the retrace detector
counts the kernels' launch-plan builds in it (``kernels/ops.py::
plan_builds``). No hook touches the device: streams are bit-identical with
telemetry and tracing on or off.

``ReferenceEngine`` is the JAX package's per-slot, per-token engine over a
contiguous float32 cache (one decode call and one host sync per slot per
token, prompts fed token by token): the serving path of the ssm, hybrid
and encdec families, whose caches have no per-slot lengths, and the
measured baseline for the others. It keeps the same registry. Features it cannot give raise
:class:`EngineCapabilityError` at construction, with its ``capabilities()``
in the message.

Tensor- and data-parallel serving (``parallel/sharding.py``): with
``EngineConfig(mesh="model=N,data=M")`` the batched engines run on every rank
of a ``torch.distributed`` grid of N x M ranks, each rank constructing the
engine on the same bank and config and driving the same requests. Each rank
holds ``1/N`` of the heads (its KV pools, ``self.cfg``'s head counts) and its
slices of the linear sites (``ServingMesh.place_tiers``: every tier over one
set of pieces); block tables, lengths and the sparse tables are whole on
every rank, so the host scheduler (allocator, prefix cache, tier policy,
speculation) sees no mesh. Each data column computes its share of the rows;
logits are gathered, so every rank samples the same tokens. The validations
are the JAX package's (``_resolve_serving_mesh``). An MoE's experts split
over the model axis where it divides their count (``models/moe.py``); each
rank's drop counter counts its own experts' pairs of the rows it serves.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels import ops
from ..kernels.paged_attention import takes_pages
from ..models import model as model_lib
from ..models import transformer as transformer_lib
from ..models.moe import DropCounter
from ..parallel.sharding import ServingMesh, parse_mesh_spec
from .adapters import AdapterBank, AdapterError
from .deployed import DeployedModel
from .elastic import ModelBank, TierController, TierControllerConfig
from .prefix_cache import PrefixCache
from .telemetry import EngineTelemetry, NullTelemetry
from .trace import RequestTracer

__all__ = ["Request", "RequestRejected", "EngineCapabilityError", "EngineConfig",
           "BlockAllocator", "ServingEngine", "PagedServingEngine", "ReferenceEngine",
           "BATCHED_FAMILIES", "check_mesh",
           "keyed_uniform", "unit_interval", "gumbel_argmax", "decode_emitted_tokens"]

BATCHED_FAMILIES = ("dense", "moe", "vlm")   # cache families with per-slot lengths

# internal timestamps use the monotonic clock; only Request.deadline is a
# wall-clock value handed in by the caller
_now = time.monotonic

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
_EVICT_POLICIES = ("longest_remaining", "lru")


class RequestRejected(ValueError):
    """Raised by ``submit`` when a request can never be served by this engine
    (too long for the cache, larger than the whole page pool, pinned to a
    tier the bank does not have, or naming an adapter it does not serve)."""


class EngineCapabilityError(RequestRejected):
    """A feature (quantized or bf16 KV, chunked prefill, the pressure tier
    policy, the prefix cache, speculation, adapters) was requested of an
    engine that cannot give it. A ``RequestRejected``, so callers handle both
    through one error path."""


def _capability_error(engine_cls, family: str, missing: list[str]) -> EngineCapabilityError:
    """An :class:`EngineCapabilityError` carrying the engine's
    ``capabilities()``, so a caller sees which features it lacks."""
    caps = engine_cls.capabilities()
    return EngineCapabilityError(
        f"family {family!r} serves through {engine_cls.__name__}; requested "
        f"feature(s) unavailable: {', '.join(missing)}. Engine capabilities: "
        f"{json.dumps(caps, sort_keys=True)}")


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    token_times: list[float] = field(default_factory=list)
    deadline: float | None = None    # absolute WALL-CLOCK SLO deadline
    tier: int = 0                    # requested bank tier (0 = largest)
    evictions: int = 0
    requeued_at: float = 0.0
    prefill_emitted: int = 0         # tokens emitted by prefill/chunk programs
    adapter: int | None = None       # AdapterBank adapter id (multi-tenant serving)


@dataclass
class EngineConfig:
    max_slots: int = 4
    max_len: int = 256
    eos_token: int | None = None
    min_bucket: int = 8
    block_size: int = 16
    num_blocks: int | None = None    # page pool; None = max_slots * max_len worth
    kv_dtype: str = "float32"
    evict_policy: str = "longest_remaining"
    decode_reserve: int | None = None  # decode headroom (tokens) to admit; None = one block
    prefill_chunk: int | None = None   # block-aligned prefill chunk; None = one-shot
    prefix_cache: bool = False         # radix prompt cache over shared pages
    prefix_min_hit_pages: int = 1      # smallest match worth attaching
    default_tier: int = 0              # bank tier of submit(tier=None)
    tier_policy: str = "static"        # static | pressure (downshift before evicting)
    tier_target_free: float = 0.25     # pressure setpoint: free-page fraction
    tier_gain: float = 4.0             # controller integral gain (tiers per unit error)
    tier_ema: float = 0.5              # smoothing of the free-fraction signal
    greedy: bool = True
    temperature: float = 1.0           # used when greedy=False (on-device sampling)
    seed: int = 0                      # keys the sampler's noise
    # speculative engine only (serving/speculative.py):
    spec_k: int = 0                    # draft tokens per tick; 0 = speculation off
    spec_adaptive: bool = False        # adapt k from the observed acceptance rate
    spec_draft_mode: str = "auto"      # auto | parallel | sequential
    spec_draft_kv_dtype: str = "bfloat16"  # the draft's own page pools
    spec_target_tier: int = 0          # bank tier that verifies
    spec_draft_tier: int = -1          # bank tier that drafts (-1 = cheapest)
    # observability (serving/telemetry.py, serving/trace.py), host-side only:
    telemetry: bool = True             # metrics registry, program timing, retrace
    #                                    detection; False: every hook is a no-op
    trace: bool = False                # per-request span tracer (engine.tracer)
    # tensor- and data-parallel serving (parallel/sharding.ServingMesh): a
    # spec string like "model=2,data=1", kept a string so the config stays
    # JSON-safe; the engine builds the mesh over the process group
    mesh: str | None = None
    adapters: bool = False             # serve an AdapterBank (serving/adapters.py)
    max_resident_adapters: int | None = None  # device adapter-pool rows; None = all

    def __post_init__(self):
        for name in ("max_slots", "max_len", "block_size", "min_bucket"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name}={v!r} must be a positive int")
        if self.num_blocks is not None and self.num_blocks < 1:
            raise ValueError(f"num_blocks={self.num_blocks} must be positive (or None "
                             "for a max_slots * max_len worth of pages)")
        if self.kv_dtype not in _KV_DTYPES and self.kv_dtype != "int8":
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}; expected one of "
                             f"{sorted(_KV_DTYPES) + ['int8']}")
        if self.evict_policy not in _EVICT_POLICIES:
            raise ValueError(f"unknown evict_policy {self.evict_policy!r}; "
                             f"expected one of {_EVICT_POLICIES}")
        if self.decode_reserve is not None and self.decode_reserve < 1:
            raise ValueError(f"decode_reserve={self.decode_reserve} must be positive "
                             "(or None for one block)")
        if self.prefill_chunk is not None and (
                self.prefill_chunk < 1 or self.prefill_chunk % self.block_size):
            raise ValueError(f"prefill_chunk={self.prefill_chunk} must be a positive "
                             f"multiple of block_size={self.block_size} (chunks scatter "
                             "whole pages)")
        if not isinstance(self.prefix_min_hit_pages, int) or self.prefix_min_hit_pages < 1:
            raise ValueError(f"prefix_min_hit_pages={self.prefix_min_hit_pages!r} must be "
                             "a positive int (a zero-page hit is not a hit)")
        if self.tier_policy not in ("static", "pressure"):
            raise ValueError(f"unknown tier_policy {self.tier_policy!r}; expected "
                             "'static' or 'pressure'")
        if not 0.0 < self.tier_target_free < 1.0:
            raise ValueError(f"tier_target_free={self.tier_target_free} outside (0, 1)")
        if self.tier_gain <= 0:
            raise ValueError(f"tier_gain={self.tier_gain} must be positive")
        if not 0.0 <= self.tier_ema < 1.0:
            raise ValueError(f"tier_ema={self.tier_ema} outside [0, 1)")
        if self.spec_k < 0:
            raise ValueError(f"spec_k={self.spec_k} must be >= 0")
        if self.spec_draft_mode not in ("auto", "parallel", "sequential"):
            raise ValueError(f"unknown spec_draft_mode {self.spec_draft_mode!r}; expected "
                             "auto | parallel | sequential")
        if self.spec_draft_kv_dtype not in _KV_DTYPES and self.spec_draft_kv_dtype != "int8":
            raise ValueError(f"unknown spec_draft_kv_dtype {self.spec_draft_kv_dtype!r}; "
                             f"expected one of {sorted(_KV_DTYPES) + ['int8']}")
        if self.max_resident_adapters is not None:
            if not isinstance(self.max_resident_adapters, int) \
                    or self.max_resident_adapters < 1:
                raise ValueError(f"max_resident_adapters={self.max_resident_adapters!r} must "
                                 "be a positive int (at least one adapter resident)")
            if not self.adapters:
                raise ValueError("max_resident_adapters sizes the AdapterBank device pool "
                                 "and needs adapters=True")
        if self.mesh is not None:
            if not isinstance(self.mesh, str):
                raise ValueError(f"mesh={self.mesh!r} must be a spec string like "
                                 "'model=2,data=1' (or None for single-device)")
            parse_mesh_spec(self.mesh)      # format only; the engine checks the rest


def decode_emitted_tokens(done: list[Request]) -> int:
    """Tokens these requests emitted from decode steps: every (re-)admission
    that completes its prefill emits one token from the prefill or chunk
    program (``Request.prefill_emitted``), the rest come from decode calls
    (the launcher's ``tokens_per_step``)."""
    return sum(len(r.out_tokens) - r.prefill_emitted for r in done)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for x in [0, 2**32) held in int64, without
    overflowing int64: c is applied in two 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift, multiply; the "lowbias32"
    constants) on int64 tensors holding values in [0, 2**32): the shifts are
    logical because the values are non-negative."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keyed_uniform(key: tuple[int, ...], rows: torch.Tensor, n: int) -> torch.Tensor:
    """Uniforms in (0, 1), float32, shape ``(len(rows), n)``: entry (i, j) is
    a pure function of ``key`` (host integers, e.g. seed, step, salt), the
    row id ``rows[i]`` (a slot id) and the column j (a vocab index or a
    draft position). A counter-based hash in int64 tensor ops on ``rows``'s
    device - no generator state, no host sync - mapped by ``unit_interval``,
    so the bits are the same on the CPU and the card and do not depend on
    the batch or its order."""
    h = 0x9E3779B9
    for part in key:
        h = _mix32(h ^ (int(part) & _M32))     # host integers: no tensor, no sync
    r = _mix32((rows.long() & _M32) ^ h)
    cols = _mix32(torch.arange(n, device=rows.device, dtype=torch.int64) + 0x632BE5AB)
    u = _mix32(_mix32(r[:, None] ^ cols[None, :]) ^ (r[:, None] >> 7))
    return unit_interval(u)


def unit_interval(bits: torch.Tensor) -> torch.Tensor:
    """32-bit hashes (int64 holding [0, 2**32)) -> float32 uniforms in (0, 1):
    the top 23 bits, centred, ``((b >> 9) + 0.5) / 2**23``. Every step is
    exact in float32 (24 significant bits), so the largest value is
    ``1 - 2**-24`` and the smallest ``2**-24``: ``-log(-log(u))`` is finite
    for every hash. (24 bits would round the top hash's ``+ 0.5`` up to
    1.0, an infinite Gumbel draw.)"""
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def gumbel_argmax(logits: torch.Tensor, temperature: float, key: tuple[int, ...],
                  rows: torch.Tensor) -> torch.Tensor:
    """One draw per row from ``softmax(logits / temperature)``: Gumbel-max
    with the row's keyed noise. logits (R, V) -> (R,) int64."""
    u = keyed_uniform(key, rows, logits.shape[-1])
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + g, dim=-1)


def page_pools(cfg, kv_dtype: str, field: str) -> tuple[torch.dtype, bool]:
    """``(dtype, quantized)`` of the page pools for ``kv_dtype``: int8 pages
    hold f32 activations' KV, quantized (JAX: dtype float32, quantized).
    Under ``kernel_impl='pallas'`` float pages the paged kernels do not take
    (``takes_pages``) are refused by name; int8 pages take the dequantizing
    gather, as in the JAX package."""
    quantized = kv_dtype == "int8"
    dtype = torch.float32 if quantized else _KV_DTYPES[kv_dtype]
    if cfg.kernel_impl == "pallas" and not quantized and not takes_pages(cfg.param_dtype,
                                                                          dtype):
        raise TypeError(f"kernel_impl='pallas' with {field}={kv_dtype!r}: the paged kernels "
                        f"take pages of the model's dtype ({cfg.param_dtype}), or bfloat16 "
                        "pages under a float32 model")
    return dtype, quantized


def _prompt_rows(tokens: np.ndarray, lengths: np.ndarray, slot_ids: np.ndarray,
                 max_slots: int) -> np.ndarray:
    """The (B, T) rows of a one-shot prefill that carry a prompt: each
    group row's first ``lengths`` positions (padded rows carry
    ``slot_ids == max_slots``)."""
    real = np.arange(tokens.shape[1])[None, :] < lengths[:, None]
    return real & (slot_ids < max_slots)[:, None]


def _validate_request(prompt: list[int], max_new_tokens: int, max_len: int):
    if len(prompt) < 1:
        raise RequestRejected("empty prompt")
    if len(prompt) + max_new_tokens > max_len:
        raise RequestRejected(f"prompt({len(prompt)}) + max_new({max_new_tokens}) "
                              f"exceeds cache capacity {max_len}")


def _resolve_engine_args(name: str, model, ecfg) -> tuple[ModelBank, EngineConfig]:
    """``Engine(bank, ecfg)``; a bare ``DeployedModel`` is wrapped as a
    one-tier bank."""
    if isinstance(model, DeployedModel):
        model = ModelBank.single(model.cfg, model)
    if not isinstance(model, ModelBank):
        raise TypeError(f"{name} expects a ModelBank (serving.elastic) or a "
                        f"DeployedModel, got {type(model).__name__}")
    if ecfg is not None and not isinstance(ecfg, EngineConfig):
        raise TypeError(f"{name}(bank, ecfg): ecfg must be an EngineConfig, got "
                        f"{type(ecfg).__name__}")
    return model, ecfg if ecfg is not None else EngineConfig()


def _bank_tier_state(bank: ModelBank, ecfg: EngineConfig) -> tuple[list, int]:
    """Per-tier parameter trees and the validated default tier, shared by
    both engines' constructors."""
    try:
        default = bank.resolve(ecfg.default_tier)
    except ValueError as e:
        raise ValueError(f"default_tier: {e}") from None
    return [t.params for t in bank], default


def _resolve_request_tier(bank: ModelBank, default: int, tier: int | None) -> int:
    """Validated bank tier of a request (None = the engine's default); a tier
    the bank does not have is ``RequestRejected``."""
    if tier is None:
        return default
    try:
        return bank.resolve(tier)
    except ValueError as e:
        raise RequestRejected(str(e)) from None


def _kv_pool_device_bytes(cache, mesh: ServingMesh | None = None) -> dict[str, int]:
    """KV payload bytes per device (pools and int8 scale pools: the cache's
    5-D tensors), the number behind the ``serve_kv_pool_device_bytes``
    gauge. Under a mesh every rank's own pools, keyed ``rank{r}:{device}``
    (a collective over the grid)."""
    per_dev: dict[str, int] = {}
    for leaf in cache:
        if isinstance(leaf, torch.Tensor) and leaf.dim() == 5:
            key = str(leaf.device)
            per_dev[key] = per_dev.get(key, 0) + leaf.numel() * leaf.element_size()
    if mesh is None:
        return per_dev
    return {f"rank{r}:{dev}": n for r, mine in enumerate(mesh.gather_object(per_dev))
            for dev, n in mine.items()}


def check_mesh(spec: str, cfg, fmts) -> dict[str, int]:
    """The checks of a mesh spec that need no process group, as in the JAX
    package: the model axis must divide both head counts (the KV pools and
    the paged kernels split the head axis), and the block-CSC formats
    (``fmts``: the tiers' formats) cannot split over it. An MoE's experts
    split over it where it divides their count (``models/moe.py``), and are
    served whole on every rank where it does not. Returns the axis sizes;
    the launcher calls it before it starts any rank."""
    sizes = parse_mesh_spec(spec)
    m = sizes["model"]
    if m > 1:
        heads = cfg.num_heads
        kv_heads = cfg.num_kv_heads or heads
        for fname, h in (("num_heads", heads), ("num_kv_heads", kv_heads)):
            if not h or h % m:
                raise ValueError(f"mesh={spec!r}: model axis size {m} must divide "
                                 f"{fname}={h} (KV pools and paged attention shard the "
                                 "head axis)")
        for fmt in fmts:
            if fmt in ("bsr", "fused"):
                raise ValueError(f"mesh={spec!r}: deployment format {fmt!r} cannot shard "
                                 "over the model axis (its block-CSC grid is indexed "
                                 "globally by the kernels); serve 'dense' or 'factored' tiers "
                                 "under a mesh")
    return sizes


def _resolve_serving_mesh(ecfg: EngineConfig, cfg, bank: ModelBank) -> ServingMesh | None:
    """The ServingMesh of ``ecfg.mesh`` (None = unsharded): the grid over
    the process group (a spec larger than the group raises first, as in the
    JAX package), then ``check_mesh``; this rank must lie in the grid."""
    if ecfg.mesh is None:
        return None
    smesh = ServingMesh.from_spec(ecfg.mesh)
    check_mesh(ecfg.mesh, cfg, [getattr(t.model, "fmt", "dense") for t in bank])
    if not smesh.member:
        raise ValueError(f"mesh={ecfg.mesh!r}: rank {smesh.rank} lies outside the "
                         f"{smesh.num_devices}-rank grid")
    return smesh


class ServingEngine:
    """Continuously batched, slot-padded engine: ``max_slots`` rows over one
    contiguous cache of ``max_len`` positions per slot with per-slot lengths,
    serving every tier of a :class:`ModelBank` on the device its weights
    live on. The base class of the paged engine, which overrides its hooks
    (``_admit``, ``_retire``, ``_release``, ``_pre_decode``,
    ``_prefill_progress``, ``_device_cache``, ``_update_tier_shift``,
    ``_update_gauges``)."""

    _speculative = False   # only serving.speculative.SpeculativeEngine drafts
    _chunked = False       # only PagedServingEngine prefills chunk by chunk
    _paged = False         # only PagedServingEngine has a page pool

    def __init__(self, model: ModelBank | DeployedModel, ecfg: EngineConfig | None = None):
        bank, ecfg = _resolve_engine_args(type(self).__name__, model, ecfg)
        self._init_common(bank, ecfg)
        if ecfg.kv_dtype == "int8":
            raise ValueError("int8 KV needs the paged engine (PagedServingEngine stores "
                             "quantized pages); the contiguous engine serves float caches")
        self.cache = model_lib.init_cache(self.cfg, ecfg.max_slots, ecfg.max_len,
                                          dtype=_KV_DTYPES[ecfg.kv_dtype], device=self.device,
                                          per_slot=True)
        self._place_cache()

    @classmethod
    def capabilities(cls) -> dict:
        """Which families this engine serves, its KV layout and features."""
        return {
            "engine": cls.__name__,
            "families": list(BATCHED_FAMILIES),
            "kv": "contiguous",
            "features": {
                "kv_dtype": ["float32", "bfloat16"],
                "continuous_batching": True,
                "deadlines_edf": True,
                "chunked_prefill": False,
                "eviction_resume": False,
                "speculative": False,
                "elastic_tiers": True,
                "tier_pressure_controller": False,
                "prefix_caching": False,
                "tensor_parallel": True,
                "multi_tenant_adapters": True,
            },
        }

    def _init_common(self, bank: ModelBank, ecfg: EngineConfig):
        """The state every batched engine shares, after refusing what this
        engine cannot give (the JAX package's errors and messages)."""
        cfg = bank.cfg
        if cfg.family not in BATCHED_FAMILIES:
            raise ValueError(f"batched engine needs a KV-cache family, got {cfg.family!r}; "
                             "use ReferenceEngine for ssm/hybrid/encdec")
        caps = json.dumps(self.capabilities(), sort_keys=True)
        if ecfg.spec_k and not self._speculative:
            raise EngineCapabilityError(
                f"{type(self).__name__} does not speculate (spec_k={ecfg.spec_k} requested); "
                f"use SpeculativeEngine. Engine capabilities: {caps}")
        if ecfg.prefill_chunk is not None and not self._chunked:
            raise EngineCapabilityError(
                f"{type(self).__name__} prefills in one shot (prefill_chunk="
                f"{ecfg.prefill_chunk} requested); chunked prefill needs the paged engine. "
                f"Engine capabilities: {caps}")
        if ecfg.prefix_cache and not self._paged:
            raise EngineCapabilityError(
                f"{type(self).__name__} has no page pool to share (prefix_cache=True "
                "requested); the radix prompt cache needs the paged engine. Engine "
                f"capabilities: {caps}")
        if ecfg.tier_policy == "pressure" and not self._paged:
            raise EngineCapabilityError(
                f"{type(self).__name__} has no page pool to feel pressure from "
                "(tier_policy='pressure' requested); the tier controller needs the paged "
                f"engine. Engine capabilities: {caps}")
        # neither a silently ignored AdapterBank nor a flag with no pool
        self._adapters: AdapterBank | None = bank if isinstance(bank, AdapterBank) else None
        if ecfg.adapters != (self._adapters is not None):
            raise ValueError("adapters=True needs an AdapterBank (serving.adapters) as the "
                             "engine's bank, and an AdapterBank needs adapters=True; got "
                             f"adapters={ecfg.adapters} with {type(bank).__name__}")
        if self._adapters is not None:
            if ecfg.mesh is not None:
                raise ValueError(f"mesh={ecfg.mesh!r} + adapters is unsupported: the pooled "
                                 "adapter tables are indexed per slot by the kernels, which "
                                 "no axis partition can split; serve adapters unsharded")
            if self._speculative:
                raise EngineCapabilityError("SpeculativeEngine does not serve AdapterBanks "
                                            "(draft and verify would each need a pool); use "
                                            "PagedServingEngine")
            self._adapters.materialize(ecfg.max_resident_adapters)
        self.cfg, self.ecfg, self.bank = cfg, ecfg, bank
        self._tier_params, self._default_tier = _bank_tier_state(bank, ecfg)
        # every tier over ONE set of this rank's pieces; the rank runs 1/N of
        # the heads, so its arch config (and its KV pools) say so
        self.mesh = _resolve_serving_mesh(ecfg, cfg, bank)
        if self.mesh is not None:
            self._tier_params = self.mesh.place_tiers(self._tier_params)
            self.cfg = self.mesh.local_cfg(cfg)
        self.params = self._tier_params[self._default_tier]
        self.device = self.params["embed"]["embedding"].device
        # effective tier per slot (requested tier + controller downshift)
        self._slot_tier = np.zeros(ecfg.max_slots, np.int64)
        # multi-tenant: pool row per slot (batched calls bind this map as it
        # is, so an idle slot keeps a valid row) and the adapter each slot
        # pinned (unpinned when the slot releases)
        self._slot_pool = np.zeros(ecfg.max_slots, np.int32)
        self._slot_adapter: dict[int, int] = {}
        self._tier_shift = 0
        self.tier_controller: TierController | None = None
        self._queue: list[Request] = []
        self._active: dict[int, Request] = {}
        # slot -> tokens prefilled so far: a slot here is mid-prefill (the
        # chunked paged engine only) and does not decode
        self._progress: dict[int, int] = {}
        self._uid = 0
        self._steps = 0
        self._last_token = np.zeros(ecfg.max_slots, np.int64)
        self.decode_calls = 0
        self.prefill_calls = 0
        # the registry every counter reads, and the optional tracer
        self.metrics = (EngineTelemetry if ecfg.telemetry else NullTelemetry)(
            type(self).__name__)
        if self._adapters is not None:
            self.metrics.set_resident_adapters(len(self._adapters.resident))
        self.tracer: RequestTracer | None = None
        if ecfg.trace:
            self.start_trace()
        # an MoE model's capacity drops, counted when the caller sets a
        # moe.DropCounter here; each call marks the rows it serves
        self.moe_drops: DropCounter | None = None

    # ----------------------------------------------------- observability ---

    def start_trace(self, tracer: RequestTracer | None = None) -> RequestTracer:
        """Attach a per-request span tracer; later activity records slot-track
        spans and program-track slices. Returns it (``save_chrome(path)``,
        ``save_jsonl(path)``)."""
        self.tracer = tracer if tracer is not None else RequestTracer(type(self).__name__)
        self.metrics.tracer = self.tracer
        return self.tracer

    # counters: read-only views over the registry (0 with telemetry off)

    @property
    def evictions(self) -> int:
        return int(self.metrics.counter_value(self.metrics.evictions))

    @property
    def tier_switches(self) -> int:
        return int(self.metrics.counter_value(self.metrics.tier_switches))

    @property
    def downshift_ticks(self) -> int:
        return int(self.metrics.counter_value(self.metrics.downshift_ticks))

    @property
    def adapter_swaps(self) -> int:
        """Pool rows swapped in at admission."""
        return int(self.metrics.counter_value(self.metrics.adapter_swaps))

    @property
    def adapter_tokens(self) -> dict[int, int]:
        """Emitted tokens by adapter id."""
        return {int(key.split(",")[1]): int(n)
                for key, n in self.metrics.adapter_tokens.snapshot().items()}

    @property
    def resident_adapters(self) -> int:
        return int(self.metrics.resident_adapters.value(self.metrics.engine))

    def stats_snapshot(self) -> dict:
        """Scheduler counters plus the registry's snapshot; the launcher's
        summary reads it, the Prometheus exporter serves the same registry."""
        return {"engine": type(self).__name__, "steps": self._steps,
                "decode_calls": self.decode_calls, "prefill_calls": self.prefill_calls,
                "jit_retraces": self.metrics.retraces(), "metrics": self.metrics.snapshot()}

    # ------------------------------------------------------------ intake ---

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               deadline: float | None = None, tier: int | None = None,
               submitted_at: float | None = None, adapter: int | None = None) -> int:
        """Enqueue a request; ``adapter`` picks a registered AdapterBank
        adapter (None = the bank's default; rejected on plain banks)."""
        try:
            self._validate(prompt, max_new_tokens)
            tier = self._resolve_tier(tier)
            adapter = self._resolve_adapter(adapter)
        except RequestRejected:
            self.metrics.on_reject()
            raise
        self._uid += 1
        self._queue.append(Request(
            self._uid, list(prompt), max_new_tokens, deadline=deadline, tier=tier,
            submitted_at=_now() if submitted_at is None else submitted_at, adapter=adapter))
        self.metrics.on_submit()
        return self._uid

    def _validate(self, prompt: list[int], max_new_tokens: int):
        _validate_request(prompt, max_new_tokens, self.ecfg.max_len)

    def _resolve_tier(self, tier: int | None) -> int:
        """The validated bank tier of a request (None = the default tier)."""
        return _resolve_request_tier(self.bank, self._default_tier, tier)

    def _resolve_adapter(self, adapter: int | None) -> int | None:
        """Validated adapter id (None = the bank's default). An adapter
        unregistered after submit is caught at admission: the request then
        finishes rejected."""
        if self._adapters is None:
            if adapter is not None:
                raise RequestRejected(f"adapter={adapter} needs an AdapterBank engine "
                                      "(serving.adapters); this engine serves a plain "
                                      "ModelBank")
            return None
        aid = self._adapters.default_adapter if adapter is None else adapter
        if aid not in self._adapters.registry:
            raise RequestRejected(f"unknown adapter id {aid}")
        return aid

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def _order_queue(self):
        """Earliest deadline first; then evicted requests, then FIFO."""
        self._queue.sort(key=lambda r: (r.deadline is None, r.deadline or 0.0,
                                        -r.evictions, r.uid))

    # ------------------------------------------------------------- tiers ---

    def _effective_tier(self, req: Request) -> int:
        """Requested tier plus the controller's downshift, clamped to the
        cheap end of the bank."""
        return min(req.tier + self._tier_shift, len(self._tier_params) - 1)

    def _update_tier_shift(self):
        """Hook: the paged engine integrates page pressure here."""

    def _refresh_slot_tiers(self):
        """Recompute each active slot's effective tier: host bookkeeping only,
        the KV cache carries no tier."""
        for slot, req in self._active.items():
            eff = self._effective_tier(req)
            if eff != self._slot_tier[slot]:
                self.metrics.inc(self.metrics.tier_switches)
                if self.tracer is not None:
                    self.tracer.instant(slot, "tier_switch", uid=req.uid,
                                        frm=int(self._slot_tier[slot]), to=eff)
                self._slot_tier[slot] = eff

    def _tier_groups(self, slots) -> list[tuple]:
        """Slots grouped by program key, ascending: the effective tier,
        widened in grouped adapter mode to ``(tier, pool row)`` so that every
        call serves ONE adapter. Batched adapter mode keeps the tier key: one
        call covers slots of different adapters."""
        grouped = self._adapters is not None and self._adapters.mode == "grouped"
        groups: dict = {}
        for s in slots:
            key = (int(self._slot_tier[s]), int(self._slot_pool[s])) if grouped \
                else int(self._slot_tier[s])
            groups.setdefault(key, []).append(s)
        return sorted(groups.items())

    # ---------------------------------------------------------- adapters ---

    def _adapter_admit(self, req: Request, done: list[Request]) -> tuple[str, int | None]:
        """Acquire and pin ``req``'s adapter in the device pool: ``("ok",
        row)`` (row None on plain banks); ``("busy", None)`` when every pool
        row is pinned by a streaming slot (keep it queued); ``("gone", None)``
        when the adapter was unregistered after submit (it finishes
        rejected)."""
        if self._adapters is None:
            return "ok", None
        try:
            row, swapped = self._adapters.acquire(req.adapter)
        except AdapterError:
            req.done = True
            req.finished_at = _now()
            self.metrics.on_reject()
            done.append(req)
            return "gone", None
        if row is None:
            return "busy", None
        if swapped:
            self.metrics.inc(self.metrics.adapter_swaps)
        self._adapters.pin(req.adapter)
        self.metrics.set_resident_adapters(len(self._adapters.resident))
        return "ok", row

    def _call_params(self, key, rows=None):
        """The parameter tree for ONE program call: the tier's tree on plain
        banks; on an AdapterBank a fresh ``bind`` of the pool - a grouped key
        carries its pool row, batched calls bind ``rows`` (slot-indexed for
        decode and chunk calls, group-indexed for one-shot prefill)."""
        if self._adapters is None:
            return self._tier_params[key]
        if isinstance(key, tuple):
            return self._adapters.bind(key[1])
        return self._adapters.bind(rows)

    # ----------------------------------------------------- device programs ---

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _drops(self, real: np.ndarray) -> DropCounter | None:
        """``moe_drops`` with ``real`` (the call's (B, T) served rows) marked."""
        if self.moe_drops is not None:
            self.moe_drops.real = self._to_dev(real)
        return self.moe_drops

    def _device_cache(self):
        """Hook: the paged engine pushes host block-table updates here."""
        return self.cache

    def _place_cache(self):
        """Record the KV pool's bytes per device, one entry per rank under a
        mesh (the gauge is set once: the pools' shapes are fixed for the
        engine's life)."""
        if self.metrics.enabled:
            self.metrics.set_pool_device_bytes(_kv_pool_device_bytes(self.cache, self.mesh))

    def _sample(self, logits: torch.Tensor, salt: int, slots=None) -> torch.Tensor:
        """Greedy or temperature sampling on the device; logits (R, vocab).
        ``slots`` are the rows' slot ids (default: the row index, as decode
        and chunk rows are slot-indexed). ``salt`` separates the streams that
        can sample in one tick (decode 0; prefill and chunk ends 1; the
        speculative engine's draft steps 2 + i and verify 2 + k)."""
        if self.ecfg.greedy or self.ecfg.temperature <= 0:
            return logits.argmax(-1)
        if slots is None:
            slots = torch.arange(logits.shape[0], device=logits.device)
        return gumbel_argmax(logits, self.ecfg.temperature,
                             (self.ecfg.seed, self._steps, salt), slots)

    def _decode(self, key, tokens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One decode over all slots with ``key``'s parameters; the next token
        of every row (host)."""
        cache = self._device_cache()
        logits, new = model_lib.decode_step(self._call_params(key, self._slot_pool),
                                            self._to_dev(tokens), cache, self.cfg,
                                            drops=self._drops(active[:, None]))
        # only active slots advance; inactive slots wrote a junk row at their
        # frozen position (paged: unmapped pages drop it), which the next real
        # insert overwrites
        length = torch.where(self._to_dev(active), new.length, cache.length)
        self.cache = new._replace(length=length)
        self.decode_calls += 1
        return self._sample(logits[:, -1], salt=0).cpu().numpy()

    def _prefill_call(self, key, tokens, lengths, slot_ids, rows) -> np.ndarray:
        """One-shot prefill of one tier group (rows 0.. of the batch; padded
        rows carry ``slot_ids == max_slots``): a no-cache forward building a
        cache of the engine's dtype, whose group rows are copied into their
        slots with their lengths. The group's rows are known on the host, so
        no padded row reaches a write. ``rows`` is the group-indexed pool-row
        map (batched adapter mode). Returns each row's first token (host)."""
        logits, pcache = model_lib.prefill(
            self._call_params(key, rows), {"tokens": self._to_dev(tokens)}, self.cfg,
            max_len=self.ecfg.max_len, cache_dtype=self.cache.k.dtype,
            drops=self._drops(_prompt_rows(tokens, lengths, slot_ids, self.ecfg.max_slots)))
        group = np.nonzero(slot_ids < self.ecfg.max_slots)[0]
        src = self._to_dev(group)
        dst = self._to_dev(slot_ids[group].astype(np.int64))
        self.cache.k[:, dst] = pcache.k[:, src]
        self.cache.v[:, dst] = pcache.v[:, src]
        self.cache.length[dst] = self._to_dev(lengths[group])
        self.prefill_calls += 1
        rows_ = torch.arange(len(lengths), device=self.device)
        last = logits[rows_, self._to_dev((lengths - 1).astype(np.int64))]
        return self._sample(last, salt=1,
                            slots=self._to_dev(slot_ids.astype(np.int64))).cpu().numpy()

    # ------------------------------------------------------------- steps ---

    def _bucket(self, n: int) -> int:
        b = self.ecfg.min_bucket
        while b < n:
            b *= 2
        return min(b, self.ecfg.max_len)

    def _admit(self, free: list[int], done: list[Request]):
        """Admit as many queued requests as there are free slots (earliest
        deadline first), then one prefill per effective tier over a length
        bucket."""
        take = min(len(free), len(self._queue))
        if not take:
            return
        self._order_queue()
        reqs = [self._queue.pop(0) for _ in range(take)]
        s = self.ecfg.max_slots
        now = _now()
        admitted: list[int] = []
        requeue: list[Request] = []
        for req in reqs:
            astat, arow = self._adapter_admit(req, done)
            if astat == "gone":
                continue
            if astat == "busy":          # every pool row pinned: retry next tick
                requeue.append(req)
                continue
            slot = free.pop()
            self.metrics.on_admit(req, slot, now, prefill_tokens=len(req.prompt))
            req.admitted_at = now
            self._active[slot] = req
            self._slot_tier[slot] = self._effective_tier(req)
            if arow is not None:
                self._slot_pool[slot] = arow
                self._slot_adapter[slot] = req.adapter
            if self.tracer is not None:
                self.tracer.request_begin(slot, req.uid, t=now, tier=req.tier)
                self.tracer.begin_span(slot, "prefill", t=now, tokens=len(req.prompt))
            admitted.append(slot)
        self._queue[:0] = requeue
        for key, slots in self._tier_groups(admitted):
            group = [(slot, self._active[slot]) for slot in slots]
            bucket = self._bucket(max(len(r.prompt) for _, r in group))
            tokens = np.zeros((s, bucket), np.int32)
            lengths = np.ones((s,), np.int32)      # padded rows: 1 valid token
            slot_ids = np.full((s,), s, np.int32)  # padded rows: no slot
            rows = np.zeros((s,), np.int32)        # group-indexed pool rows
            for i, (slot, req) in enumerate(group):
                tokens[i, : len(req.prompt)] = req.prompt
                lengths[i] = len(req.prompt)
                slot_ids[i] = slot
                rows[i] = self._slot_pool[slot]
            with self.metrics.measure_program(f"prefill[{bucket}]", key,
                                              traces=ops.plan_builds):
                firsts = self._prefill_call(key, tokens, lengths, slot_ids, rows)
            for i, (slot, req) in enumerate(group):
                req.prefill_emitted += 1
                self._record(slot, req, int(firsts[i]), free, done)

    def _record(self, slot: int, req: Request, tok: int, free: list[int],
                done: list[Request]):
        now = _now()
        req.out_tokens.append(tok)
        req.token_times.append(now)
        first = req.first_token_at == 0.0
        if first:
            req.first_token_at = now
        # the one emission point: serve_tokens_total{kind="emitted"} counts
        # each generated token once, however often eviction re-prefills it
        self.metrics.on_token(req, now, first)
        if self._adapters is not None:
            self.metrics.inc(self.metrics.adapter_tokens, 1, str(req.adapter))
        tr = self.tracer
        if tr is not None and tr.has_open(slot, "prefill"):
            # the prefill (or resume) just yielded its token: close its span
            # and open the decode envelope
            tr.end_span(slot, "prefill", t=now)
            if first:
                tr.instant(slot, "first_token", t=now, uid=req.uid)
            tr.begin_span(slot, "decode", t=now, uid=req.uid)
        self._last_token[slot] = tok
        if len(req.out_tokens) >= req.max_new_tokens or (
                self.ecfg.eos_token is not None and tok == self.ecfg.eos_token):
            req.done = True
            req.finished_at = now
            self.metrics.on_finish()
            if tr is not None:
                if tr.has_open(slot, "decode"):
                    tr.end_span(slot, "decode", t=now)
                tr.request_end(slot, req.uid, t=now, tokens=len(req.out_tokens),
                               evictions=req.evictions)
            done.append(req)
            self._retire(slot, req)
            del self._active[slot]
            free.append(slot)
            self._release(slot)

    def _retire(self, slot: int, req: Request):
        """Hook: the prefix-caching paged engine publishes the slot's full
        pages here (on finish and on eviction), before ``_release``."""

    def _release(self, slot: int):
        """Hook extended by the paged engine (it returns the slot's pages);
        the base unpins the slot's adapter, so LRU residency can swap it out
        once no slot streams it."""
        if self._adapters is not None:
            aid = self._slot_adapter.pop(slot, None)
            if aid is not None:
                self._adapters.unpin(aid)

    def _pre_decode(self, free: list[int], done: list[Request]):
        """Hook: the paged engine grows page allocations and evicts here."""

    def _prefill_progress(self, free: list[int], done: list[Request]):
        """Hook: the chunked paged engine advances mid-prefill slots by one
        chunk here."""

    @torch.no_grad()
    def step(self) -> list[Request]:
        """One engine tick: admit, refresh effective tiers (the pressure
        controller first: downshift comes before any eviction), advance
        mid-prefill slots, then one decode per active tier. Returns the
        requests that finished in it."""
        with self.metrics.measure_tick(), self._mesh_scope():
            done = self._step_inner()
            self._update_gauges()
        return done

    def _mesh_scope(self):
        """The mesh as the forward's ``current_mesh()`` for one tick; a null
        context when unsharded."""
        return self.mesh if self.mesh is not None else contextlib.nullcontext()

    def _step_inner(self) -> list[Request]:
        done: list[Request] = []
        s = self.ecfg.max_slots
        self._steps += 1
        free = [x for x in range(s) if x not in self._active]
        self._admit(free, done)
        if not self._active:
            return done
        self._update_tier_shift()
        self._refresh_slot_tiers()
        self._prefill_progress(free, done)
        self._pre_decode(free, done)
        active = np.zeros((s,), bool)
        for slot in self._active:
            if slot not in self._progress:
                active[slot] = True
        if active.any():
            self._decode_tick(active, free, done)
        return done

    def _update_gauges(self):
        """End-of-tick queue and slot gauges, host counters only (the paged
        engine adds the pool's); nothing is computed with telemetry off."""
        if not self.metrics.enabled:
            return
        self.metrics.set_pool(queue=len(self._queue), active=len(self._active),
                              shift=self._tier_shift)
        if self._adapters is not None:
            self.metrics.set_resident_adapters(len(self._adapters.resident))

    def _decode_tick(self, active: np.ndarray, free: list[int], done: list[Request]):
        """One decode per active tier over the shared cache, each masked to
        that tier's slots (the speculative engine replaces this with its
        draft and k-wide verify)."""
        s = self.ecfg.max_slots
        tokens = np.zeros((s, 1), np.int32)
        decode_slots = [int(x) for x in np.nonzero(active)[0]]
        for slot in decode_slots:
            tokens[slot, 0] = self._last_token[slot]
        out = np.zeros((s,), np.int64)
        for key, slots in self._tier_groups(decode_slots):
            mask = np.zeros((s,), bool)
            mask[slots] = True
            with self.metrics.measure_program("decode", key, traces=ops.plan_builds):
                toks = self._decode(key, tokens, mask)     # one host sync per tier
            out[slots] = toks[slots]
        for slot, req in list(self._active.items()):
            if slot not in self._progress:
                self._record(slot, req, int(out[slot]), free, done)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive everything to completion."""
        done: list[Request] = []
        steps = 0
        while self.has_work and steps < max_steps:
            steps += 1
            done.extend(self.step())
        return done


class BlockAllocator:
    """Host-side ref-counted allocator over a fixed pool of KV pages.

    Pages are interchangeable, so there is no external fragmentation. ``alloc``
    grants pages at refcount 1 (all or nothing), ``share`` adds a holder,
    ``release`` drops one and returns pages reaching zero, ``free`` only
    accepts exclusive pages. Every mutation validates its whole argument list
    before touching state, so free + distinct-owned always equals the pool.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self._refs: dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def _validate_owned(self, pages: list[int], verb: str):
        bad = sorted({p for p in pages if p not in self._refs})
        if bad:
            raise ValueError(f"{verb} page(s) {bad} that are not allocated")
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate page(s) in {verb} list {sorted(pages)}")

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: list[int]):
        self._validate_owned(pages, "sharing")
        for p in pages:
            self._refs[p] += 1

    def release(self, pages: list[int]) -> list[int]:
        self._validate_owned(pages, "releasing")
        freed = []
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                freed.append(p)
        return freed

    def free(self, pages: list[int]):
        self._validate_owned(pages, "free")
        shared = sorted({p for p in pages if self._refs[p] != 1})
        if shared:
            raise ValueError(f"freeing shared page(s) {shared} (refcount > 1); drop "
                             "references with release() instead")
        for p in pages:
            del self._refs[p]
        self._free.extend(pages)


class PagedServingEngine(ServingEngine):
    """Continuously batched engine over a block-paged KV cache: serving
    memory is ``num_blocks * block_size`` tokens shared by all slots.
    Admission happens whenever a slot and enough free pages exist, decode
    allocations grow one page at a time, and a dry pool evicts a victim back
    to the queue; ``prefill_chunk``, ``prefix_cache`` and
    ``tier_policy='pressure'`` as the module docstring says."""

    _chunked = True
    _paged = True
    _write_window = 1      # KV positions one decode tick writes per slot

    def __init__(self, model: ModelBank | DeployedModel, ecfg: EngineConfig | None = None):
        bank, ecfg = _resolve_engine_args(type(self).__name__, model, ecfg)
        self._init_common(bank, ecfg)
        kv_dtype, quantized = page_pools(self.cfg, ecfg.kv_dtype, "kv_dtype")
        bs = ecfg.block_size
        self._bs = bs
        self._max_len = -(-ecfg.max_len // bs) * bs
        self._nb_slot = self._max_len // bs
        self.num_blocks = ecfg.num_blocks or ecfg.max_slots * self._nb_slot
        self.allocator = BlockAllocator(self.num_blocks)
        self._chunk = None if ecfg.prefill_chunk is None \
            else min(ecfg.prefill_chunk, self._max_len)
        self.cache = model_lib.init_paged_cache(self.cfg, ecfg.max_slots, self.num_blocks, bs,
                                                self._nb_slot, dtype=kv_dtype,
                                                device=self.device, quantized=quantized)
        self._table = np.full((ecfg.max_slots, self._nb_slot), self.num_blocks, np.int32)
        self._table_dirty = False
        self._pages: dict[int, list[int]] = {}
        self._ptarget: dict[int, int] = {}
        # slot -> device length to set before the next program: a prefix-hit
        # admission's length is stale until its first chunk runs, and junk
        # rows other programs write meanwhile must not land in shared pages
        self._len_reset: dict[int, int] = {}
        if ecfg.tier_policy == "pressure":
            self.tier_controller = TierController(len(bank), TierControllerConfig(
                target_free_frac=ecfg.tier_target_free, gain=ecfg.tier_gain,
                ema=ecfg.tier_ema))
        # prefix sharing; multi-tenant serving keeps one radix index PER
        # ADAPTER (cached KV depends on its weights), created on first use,
        # all holding references in the one shared allocator
        self._prefix = PrefixCache(self.allocator, bs) \
            if ecfg.prefix_cache and self._adapters is None else None
        self._prefix_caches: dict[int, PrefixCache] = {}
        self.chunk_calls = 0
        self._place_cache()

    @classmethod
    def capabilities(cls) -> dict:
        caps = ServingEngine.capabilities.__func__(cls)
        caps["kv"] = "paged"
        caps["features"].update(kv_dtype=["float32", "bfloat16", "int8"], chunked_prefill=True,
                                eviction_resume=True, tier_pressure_controller=True,
                                prefix_caching=True)
        return caps

    def stats_snapshot(self) -> dict:
        return {**super().stats_snapshot(), "chunk_calls": self.chunk_calls}

    # prefix-cache counters: read-only views over the registry

    @property
    def prefix_lookups(self) -> int:
        return int(self.metrics.counter_value(self.metrics.prefix, "lookups"))

    @property
    def prefix_hits(self) -> int:
        return int(self.metrics.counter_value(self.metrics.prefix, "hits"))

    @property
    def prefix_hit_tokens(self) -> int:
        """Prompt tokens served from the index instead of prefill compute."""
        return int(self.metrics.counter_value(self.metrics.tokens, "prefix_hit"))

    @property
    def cow_copies(self) -> int:
        """Pages privatized by copy-on-write."""
        return int(self.metrics.counter_value(self.metrics.prefix, "cow_copies"))

    @property
    def reattached_pages(self) -> int:
        """Pages evicted slots got back on resume."""
        return int(self.metrics.counter_value(self.metrics.prefix, "reattached_pages"))

    def _validate(self, prompt: list[int], max_new_tokens: int):
        super()._validate(prompt, max_new_tokens)
        need = -(-(len(prompt) + max_new_tokens) // self._bs)
        if need > self.num_blocks:
            raise RequestRejected(f"request needs {need} KV pages but the whole pool "
                                  f"holds {self.num_blocks}")

    def _update_gauges(self):
        if not self.metrics.enabled:
            return
        super()._update_gauges()
        # the index's O(1) page count, not reclaimable_pages (a tree walk)
        self.metrics.set_pool(free=self.allocator.free_blocks,
                              cached=sum(pc.pages for pc in self._all_prefixes()))

    def _update_tier_shift(self):
        """Integrate page pressure into the downshift before anyone can be
        evicted. Index-only cached pages count as free: one ``reclaim``
        away from the pool."""
        if self.tier_controller is None:
            return
        free_like = self.allocator.free_blocks + sum(
            pc.reclaimable_pages for pc in self._all_prefixes())
        self._tier_shift = self.tier_controller.update(free_like / self.num_blocks)
        if self._tier_shift > 0:
            self.metrics.inc(self.metrics.downshift_ticks)

    def _prefix_of(self, aid: int | None) -> PrefixCache | None:
        """The radix index serving adapter ``aid``: the shared one on plain
        banks, one per adapter under multi-tenant serving. None with the
        cache off."""
        if not self.ecfg.prefix_cache:
            return None
        if self._adapters is None:
            return self._prefix
        pc = self._prefix_caches.get(aid)
        if pc is None:
            pc = self._prefix_caches[aid] = PrefixCache(self.allocator, self._bs)
        return pc

    def _all_prefixes(self) -> list[PrefixCache]:
        if self._prefix is not None:
            return [self._prefix]
        return list(self._prefix_caches.values())

    # ----------------------------------------------------- device programs ---

    def _device_cache(self):
        if self._table_dirty:
            self.cache.block_table.copy_(torch.from_numpy(self._table))
            self._table_dirty = False
        if self._len_reset:
            slots = np.fromiter(self._len_reset, np.int64)
            vals = np.fromiter(self._len_reset.values(), np.int32)
            self.cache.length[self._to_dev(slots)] = self._to_dev(vals)
            self._len_reset.clear()
        return self.cache

    def _chunk_target(self, params, tokens, counts, starts):
        """The device body of a chunk over all slots (the speculative engine
        runs it for its target too): rows with counts > 0 reset their length
        to the host-tracked progress (a fresh slot may inherit a stale device
        length) and insert there; rows with counts == 0 keep their length and
        write junk past it that is never attended. Returns the next token of
        each row (meaningful where a prompt ends; salt 1, the one-shot
        prefill's key) and the pre-chunk lengths."""
        cache = self._device_cache()
        counts_d = self._to_dev(counts)
        n0 = torch.where(counts_d > 0, self._to_dev(starts), cache.length)
        logits, self.cache = model_lib.chunk_prefill_step(
            params, self._to_dev(tokens), counts_d, cache._replace(length=n0), self.cfg,
            drops=self._drops(np.arange(tokens.shape[1])[None, :] < counts[:, None]))
        self.chunk_calls += 1
        last = torch.from_numpy(np.maximum(counts - 1, 0).astype(np.int64)).to(self.device)
        rows = torch.arange(len(counts), device=self.device)
        return self._sample(logits[rows, last], salt=1), n0

    def _chunk_call(self, key, tokens, counts, starts) -> np.ndarray:
        """One chunk over all slots (``_chunk_target``); the caller times it
        as ``chunk[{width}]``."""
        tok, _ = self._chunk_target(self._call_params(key, self._slot_pool), tokens, counts,
                                    starts)
        return tok.cpu().numpy()

    def _prefill_call(self, key, tokens, lengths, slot_ids, page_map, rows) -> np.ndarray:
        """One-shot prefill of admitted prompts: no-cache forward, whole
        prompt pages scattered into the pool; padded rows drop. ``rows`` is
        the group-indexed pool-row map (batched adapter mode)."""
        cache = self._device_cache()
        logits, kvs = model_lib._forward(
            self._call_params(key, rows), {"tokens": self._to_dev(tokens)}, self.cfg,
            collect_kv=True,
            drops=self._drops(_prompt_rows(tokens, lengths, slot_ids, self.ecfg.max_slots)))
        transformer_lib.scatter_prefill_pages(cache, kvs, self._to_dev(page_map))
        keep = slot_ids < self.ecfg.max_slots
        cache.length[self._to_dev(slot_ids[keep].astype(np.int64))] = \
            self._to_dev(lengths[keep])
        self.prefill_calls += 1
        rows = torch.arange(len(lengths), device=self.device)
        last = logits[rows, self._to_dev((lengths - 1).astype(np.int64))]
        return self._sample(last, salt=1,
                            slots=self._to_dev(slot_ids.astype(np.int64))).cpu().numpy()

    def _cow_copy(self, pairs: list[tuple[int, int]]):
        """One page-copy call per pool for this tick's copy-on-write pairs
        (the block table is already remapped host-side), padded to a power of
        two with (0, 0) identity pairs as in the JAX engine."""
        n = 1
        while n < len(pairs):
            n *= 2
        pad = pairs + [(0, 0)] * (n - len(pairs))
        src = self._to_dev(np.array([p for p, _ in pad], np.int32))
        dst = self._to_dev(np.array([q for _, q in pad], np.int32))
        with self.metrics.measure_program(f"page_copy[{n}]"):
            self._apply_cow(src, dst)

    def _apply_cow(self, src: torch.Tensor, dst: torch.Tensor):
        """The device copies of copy-on-write (the speculative engine also
        copies its draft pools here: they ride the same page ids)."""
        transformer_lib.copy_cache_pages(self.cache, src, dst)

    # ------------------------------------------------------------- steps ---

    def _bucket(self, n: int) -> int:
        b = super()._bucket(n)
        return min(-(-max(b, self._bs) // self._bs) * self._bs, self._max_len)

    def _alloc(self, n: int) -> list[int] | None:
        """Pool allocation with the prefix cache as the reclaim tail: when the
        free list cannot cover ``n``, index-only cached pages are reclaimed
        LRU first, before any caller evicts a live slot."""
        pages = self.allocator.alloc(n)
        if pages is None:
            # every adapter's index, those of unregistered adapters too: that
            # is how their orphaned pages drain
            for pc in self._all_prefixes():
                pc.reclaim(n - self.allocator.free_blocks)
                if self.allocator.free_blocks >= n:
                    break
            pages = self.allocator.alloc(n)
        return pages

    def _match(self, req: Request, ptoks: list[int]) -> tuple[list[int], int]:
        """Prefix-cache lookup at admission: the attachable hit pages and the
        position ``s0`` prefill resumes at (0 without a hit), in the index of
        the request's adapter."""
        pc = self._prefix_of(req.adapter)
        if pc is None:
            return [], 0
        self.metrics.prefix_event("lookups")
        plen = len(ptoks)
        hit = pc.match(ptoks)
        if len(hit) < self.ecfg.prefix_min_hit_pages:
            return [], 0
        # the last prompt position is always recomputed - its logits give the
        # first token - so a fully cached prompt resumes at plen - 1 inside its
        # final hit page
        s0 = min(len(hit) * self._bs, plen - 1)
        if self._chunk is not None and plen > self._chunk:
            # chunk-aligned, so the chunked state machine starts at the hit
            # boundary and never rewrites a hit page
            s0 = s0 // self._chunk * self._chunk
        hit = hit[: -(-s0 // self._bs)]
        return (hit, s0) if hit else ([], 0)

    def _admit(self, free: list[int], done: list[Request]):
        """Admit every queued request that a free slot + free pages cover.

        With the prefix cache, matching full pages attach read-only and only
        the unmatched suffix is prefilled, through the chunk program (the one
        program that starts at an offset). A fully cached prompt resumes at
        ``plen - 1`` inside its final hit page: that page is privatized by one
        batched copy before any program runs. Chunked mode reserves the first
        chunk's pages and hands the slot to ``_prefill_progress``; one-shot
        mode prefills here, one call per tier."""
        if not self._queue or not free:
            return
        self._order_queue()
        reserve = self.ecfg.decode_reserve or self._bs
        admitted: list[tuple[int, Request, list[int], int, int]] = []
        cow_pairs: list[tuple[int, int]] = []
        while self._queue and free:
            req = self._queue[0]
            astat, arow = self._adapter_admit(req, done)
            if astat == "gone":          # unregistered after submit: finished rejected
                self._queue.pop(0)
                continue
            if astat == "busy":          # every pool row pinned: retry next tick
                break
            ptoks = req.prompt + req.out_tokens      # evicted requests resume
            plen = len(ptoks)
            hit, s0 = self._match(req, ptoks)
            if self._chunk is not None and plen - s0 > self._chunk:
                want = s0 + self._chunk  # first chunk only; the rest reserves as it goes
            else:
                remaining = max(req.max_new_tokens - len(req.out_tokens), 1)
                want = plen + min(max(reserve, 1), remaining)
            blocks = min(-(-want // self._bs), self._nb_slot)
            cow = bool(hit) and s0 % self._bs != 0   # the first write lands in hit[-1]
            if hit:
                # pin the hit first: _alloc may reclaim index-only pages
                self.allocator.share(hit)
            fresh = self._alloc(max(blocks - len(hit), 0) + (1 if cow else 0))
            if fresh is None:
                if hit:
                    self.allocator.release(hit)
                if self._adapters is not None:      # undo the admission pin
                    self._adapters.unpin(req.adapter)
                break                   # pool full: stay queued
            pages = list(hit)
            if cow:
                copy = fresh.pop()
                cow_pairs.append((pages[-1], copy))
                self.allocator.release([pages[-1]])  # the index keeps its own ref
                pages[-1] = copy
                self.metrics.prefix_event("cow_copies")
            pages += fresh
            self._queue.pop(0)
            slot = free.pop()
            now = _now()
            # prefill_compute: the suffix this admission runs through a
            # program (the hit share is never recomputed)
            self.metrics.on_admit(req, slot, now, prefill_tokens=plen - s0, hit_tokens=s0)
            req.admitted_at = now
            self._active[slot] = req
            self._slot_tier[slot] = self._effective_tier(req)
            if arow is not None:
                self._slot_pool[slot] = arow
                self._slot_adapter[slot] = req.adapter
            self._pages[slot] = pages
            self._table[slot, : len(pages)] = pages
            self._table_dirty = True
            tr = self.tracer
            if tr is not None:
                tr.request_begin(slot, req.uid, t=now, tier=req.tier,
                                 resume=bool(req.evictions))
                tr.begin_span(slot, "prefill", t=now, tokens=plen - s0)
                if hit:
                    tr.instant(slot, "prefix_hit", t=now, pages=len(hit), tokens=s0)
                if cow:
                    tr.instant(slot, "cow", t=now)
            if hit:
                self.metrics.prefix_event("hits")
                if req.evictions:
                    self.metrics.prefix_event("reattached_pages", len(hit))
                self._len_reset[slot] = s0
            admitted.append((slot, req, pages, plen, s0))
        if not admitted:
            return
        if cow_pairs:
            self._cow_copy(cow_pairs)
        if self._chunk is not None:
            # mid-prefill at the hit boundary; this tick's _prefill_progress
            # runs the first unmatched chunk
            for slot, _, _, plen, s0 in admitted:
                self._progress[slot] = s0
                self._ptarget[slot] = plen
            return
        s = self.ecfg.max_slots
        whole = {slot: (req, pages, plen) for slot, req, pages, plen, s0 in admitted if s0 == 0}
        for key, slots in self._tier_groups(whole):
            bucket = self._bucket(max(whole[x][2] for x in slots))
            tokens = np.zeros((s, bucket), np.int32)
            lengths = np.ones((s,), np.int32)
            slot_ids = np.full((s,), s, np.int32)
            page_map = np.full((s, bucket // self._bs), self.num_blocks, np.int32)
            rows = np.zeros((s,), np.int32)      # group-indexed pool rows
            for i, slot in enumerate(slots):
                req, pages, plen = whole[slot]
                tokens[i, :plen] = req.prompt + req.out_tokens
                lengths[i] = plen
                slot_ids[i] = slot
                rows[i] = self._slot_pool[slot]
                nblk = -(-plen // self._bs)
                page_map[i, :nblk] = pages[:nblk]
            with self.metrics.measure_program(f"prefill[{bucket}]", key,
                                              traces=ops.plan_builds):
                firsts = self._prefill_call(key, tokens, lengths, slot_ids, page_map, rows)
            for i, slot in enumerate(slots):
                req = whole[slot][0]
                req.prefill_emitted += 1
                self._record(slot, req, int(firsts[i]), free, done)
        # prefix hits prefill only their suffix, through the chunk program
        hits = {slot: (req, plen, s0) for slot, req, _, plen, s0 in admitted if s0 > 0}
        for key, slots in self._tier_groups(hits):
            width = self._bucket(max(hits[x][1] - hits[x][2] for x in slots))
            tokens = np.zeros((s, width), np.int32)
            counts = np.zeros((s,), np.int32)
            starts = np.zeros((s,), np.int32)
            for slot in slots:
                req, plen, s0 = hits[slot]
                tokens[slot, : plen - s0] = (req.prompt + req.out_tokens)[s0:]
                counts[slot] = plen - s0
                starts[slot] = s0
            with self.metrics.measure_program(f"chunk[{width}]", key, traces=ops.plan_builds):
                firsts = self._chunk_call(key, tokens, counts, starts)
            for slot in slots:
                req = hits[slot][0]
                req.prefill_emitted += 1
                self._record(slot, req, int(firsts[slot]), free, done)

    def _grow(self, slot: int, need: int) -> bool:
        """Allocate pages one at a time until the slot holds ``need``."""
        while len(self._pages[slot]) < need:
            page = self._alloc(1)
            if page is None:
                return False
            self._table[slot, len(self._pages[slot])] = page[0]
            self._pages[slot].append(page[0])
            self._table_dirty = True
        return True

    def _prefill_progress(self, free: list[int], done: list[Request]):
        """Advance every mid-prefill slot by ONE chunk, one call per active
        tier. A slot whose chunk cannot get pages stalls at its last
        completed chunk (prefill growth never evicts); if EVERY active slot is
        a stalled prefill, the least-progressed one is evicted and the
        survivors take its pages within this tick."""
        if not self._progress:
            return
        reserve = self.ecfg.decode_reserve or self._bs
        while True:
            ready: list[int] = []
            stalled: list[int] = []
            for slot in sorted(self._progress):
                req = self._active[slot]
                p, target = self._progress[slot], self._ptarget[slot]
                c = min(self._chunk, target - p)
                if p + c >= target:      # final chunk: also reserve decode headroom
                    remaining = max(req.max_new_tokens - len(req.out_tokens), 1)
                    want = target + min(max(reserve, 1), remaining)
                else:
                    want = p + c
                need = min(-(-want // self._bs), self._nb_slot)
                (ready if self._grow(slot, need) else stalled).append(slot)
            if ready or not stalled:
                break
            if not all(s in self._progress for s in self._active):
                return   # a decoder is running and will free pages: stall
            self._evict(min(stalled, key=lambda s: (self._progress[s], s)), free)
        if not ready:
            return
        s = self.ecfg.max_slots
        for key, slots in self._tier_groups(ready):
            tokens = np.zeros((s, self._chunk), np.int32)
            counts = np.zeros((s,), np.int32)
            starts = np.zeros((s,), np.int32)
            for slot in slots:
                req = self._active[slot]
                p = self._progress[slot]
                c = min(self._chunk, self._ptarget[slot] - p)
                tokens[slot, :c] = (req.prompt + req.out_tokens)[p : p + c]
                counts[slot] = c
                starts[slot] = p
            t0 = _now()
            with self.metrics.measure_program(f"chunk[{self._chunk}]", key,
                                              traces=ops.plan_builds):
                firsts = self._chunk_call(key, tokens, counts, starts)
            if self.tracer is not None:
                t1 = _now()
                for slot in slots:
                    if slot in self._active:
                        self.tracer.begin_span(slot, "prefill_chunk", t=t0,
                                               start=int(starts[slot]),
                                               tokens=int(counts[slot]))
                        self.tracer.end_span(slot, "prefill_chunk", t=t1)
            for slot in slots:
                req = self._active.get(slot)
                if req is None:
                    continue
                self._progress[slot] += int(counts[slot])
                if self._progress[slot] >= self._ptarget[slot]:
                    del self._progress[slot]
                    del self._ptarget[slot]
                    req.prefill_emitted += 1
                    self._record(slot, req, int(firsts[slot]), free, done)

    def _pre_decode(self, free: list[int], done: list[Request]):
        """Grow each decode-phase slot's pages to cover this tick's KV writes
        (the latest token lands at len(prompt) + len(out) - 1; the speculative
        engine widens the window, ``_write_window``, to its k positions);
        evict when the pool is dry."""
        for slot in list(self._active):
            req = self._active.get(slot)
            if req is None or slot in self._progress:
                continue
            write_pos = len(req.prompt) + len(req.out_tokens) - 1 + (self._write_window - 1)
            need = min(write_pos // self._bs + 1, self._nb_slot)
            while slot in self._active and not self._grow(slot, need):
                victim = self._choose_victim()
                if victim is None:
                    break
                self._evict(victim, free)

    def _choose_victim(self) -> int | None:
        if not self._active:
            return None
        if self.ecfg.evict_policy == "lru":
            return min(self._active, key=lambda s: (self._active[s].admitted_at, s))
        return max(self._active, key=lambda s: (
            self._active[s].max_new_tokens - len(self._active[s].out_tokens), s))

    def _evict(self, slot: int, free: list[int]):
        """Return the slot's pages and re-queue its request; it resumes by
        re-prefilling prompt + generated tokens (or reattaching the pages it
        published to the prefix cache)."""
        req = self._active.pop(slot)
        req.evictions += 1
        req.requeued_at = _now()
        self.metrics.on_evict()
        tr = self.tracer
        if tr is not None:
            now = req.requeued_at
            for name in ("decode", "prefill"):
                while tr.has_open(slot, name):
                    tr.end_span(slot, name, t=now, aborted=True)
            tr.instant(slot, "evicted", t=now, uid=req.uid)
            tr.end_span(slot, "request", t=now, uid=req.uid, evicted=True)
        self._retire(slot, req)
        self._release(slot)
        self._queue.append(req)
        free.append(slot)

    def _retire(self, slot: int, req: Request):
        """Publish the slot's full written pages into the prefix cache of the
        request's adapter (on finish and on eviction); their references
        transfer to the index, so ``_release`` then frees only the exclusive
        tail."""
        pc = self._prefix_of(req.adapter)
        if pc is None:
            return
        pages = self._pages.get(slot)
        if not pages:
            return
        ptoks = req.prompt + req.out_tokens
        written = self._progress.get(slot, len(ptoks) - 1)
        n_full = min(written // self._bs, len(pages))
        if n_full <= 0:
            return
        pc.publish(ptoks, pages[:n_full])
        del pages[:n_full]

    def _release(self, slot: int):
        super()._release(slot)      # unpin the slot's adapter
        pages = self._pages.pop(slot, None)
        if pages:
            # release, not free: attached pages fall back to the index
            self.allocator.release(pages)
        self._table[slot, :] = self.num_blocks
        self._table_dirty = True
        self._len_reset.pop(slot, None)
        self._progress.pop(slot, None)
        self._ptarget.pop(slot, None)


# -------------------------------------------------------------- reference ---


class ReferenceEngine:
    """The per-slot, per-token engine (port of the JAX package's
    ``ReferenceEngine``): a contiguous float32 cache for ``max_slots`` rows,
    a per-slot view of it for every decode call (each cache tensor's batch
    axis ``CACHE_BATCH_AXIS`` narrowed to the slot, the length set to the
    slot's own) and a write-back, one ``decode_step`` call and one host sync
    per slot per token. Prompts are fed through the same decode step token by
    token, the last prompt token by the first tick. Each slot decodes with
    its request's bank tier. It serves every family (the SSM and hybrid
    states and the encoder-decoder's cache have no per-slot lengths, so the
    batched engines cannot; the encoder-decoder's cross heads are zeros, as
    in the JAX package, whose engine has no frames to encode). Its
    tokens are always greedy: like the JAX package's, it ignores
    ``greedy=False`` and ``temperature``. It keeps the batched engines'
    telemetry registry and tracer (the registry is shared infrastructure):
    each decode call is the ``decode_ref`` program of its tier."""

    CACHE_BATCH_AXIS = 1     # the batch axis of every tensor of every contiguous cache

    def __init__(self, model: ModelBank | DeployedModel, ecfg: EngineConfig | None = None):
        bank, ecfg = _resolve_engine_args(type(self).__name__, model, ecfg)
        cfg = bank.cfg
        missing = []
        if ecfg.kv_dtype != "float32":
            missing.append(f"kv_dtype={ecfg.kv_dtype!r}")
        if ecfg.spec_k:
            missing.append(f"speculative decoding (spec_k={ecfg.spec_k})")
        if ecfg.prefill_chunk is not None:
            missing.append(f"chunked prefill (prefill_chunk={ecfg.prefill_chunk})")
        if ecfg.tier_policy == "pressure":
            missing.append(f"tier_policy={ecfg.tier_policy!r} (page-pressure controller)")
        if ecfg.prefix_cache:
            missing.append("prefix_cache=True (radix prompt cache)")
        if ecfg.mesh is not None:
            missing.append(f"mesh={ecfg.mesh!r} (tensor-parallel serving needs the batched "
                           "engines)")
        if ecfg.adapters or isinstance(bank, AdapterBank):
            missing.append("multi-tenant adapters (AdapterBank serving needs the batched "
                           "engines)")
        if missing:
            raise _capability_error(type(self), cfg.family, missing)
        self.cfg, self.ecfg, self.bank = cfg, ecfg, bank
        self._tier_params, self._default_tier = _bank_tier_state(bank, ecfg)
        self.params = self._tier_params[self._default_tier]
        self.device = self.params["embed"]["embedding"].device
        self.cache = model_lib.init_cache(cfg, ecfg.max_slots, ecfg.max_len,
                                          dtype=torch.float32, device=self.device)
        self._queue: list[Request] = []
        self._active: dict[int, Request] = {}   # slot -> request
        self._slot_len = [0] * ecfg.max_slots
        self._uid = 0
        self._steps = 0
        self.decode_calls = 0
        self.metrics = (EngineTelemetry if ecfg.telemetry else NullTelemetry)(
            type(self).__name__)
        self.tracer: RequestTracer | None = None
        if ecfg.trace:
            self.start_trace()

    start_trace = ServingEngine.start_trace

    @classmethod
    def capabilities(cls) -> dict:
        return {
            "engine": cls.__name__,
            "families": ["dense", "moe", "vlm", "ssm", "hybrid", "encdec"],
            "kv": "contiguous",
            "features": {
                "kv_dtype": ["float32"],
                "continuous_batching": False,
                "deadlines_edf": False,
                "chunked_prefill": False,
                "eviction_resume": False,
                "speculative": False,
                "elastic_tiers": True,
                "tier_pressure_controller": False,
                "prefix_caching": False,
                "tensor_parallel": False,
                "multi_tenant_adapters": False,
            },
        }

    def stats_snapshot(self) -> dict:
        """The batched engines' snapshot; prompts go through the decode
        step, so no prefill call is counted."""
        return {"engine": type(self).__name__, "steps": self._steps,
                "decode_calls": self.decode_calls, "prefill_calls": 0,
                "jit_retraces": self.metrics.retraces(), "metrics": self.metrics.snapshot()}

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               deadline: float | None = None, tier: int | None = None,
               submitted_at: float | None = None, adapter: int | None = None) -> int:
        try:
            _validate_request(prompt, max_new_tokens, self.ecfg.max_len)
            tier = _resolve_request_tier(self.bank, self._default_tier, tier)
            if adapter is not None:
                raise RequestRejected(f"adapter={adapter}: ReferenceEngine serves no "
                                      "adapters (AdapterBank needs the batched engines)")
        except RequestRejected:
            self.metrics.on_reject()
            raise
        self._uid += 1
        self._queue.append(Request(
            self._uid, list(prompt), max_new_tokens, deadline=deadline, tier=tier,
            submitted_at=_now() if submitted_at is None else submitted_at))
        self.metrics.on_submit()
        return self._uid

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def step(self) -> list[Request]:
        """One tick: admit into free slots (feeding each prompt but its last
        token), then one token for every active slot."""
        with self.metrics.measure_tick():
            done = self._step_inner()
            self.metrics.set_pool(queue=len(self._queue), active=len(self._active))
        return done

    def _step_inner(self) -> list[Request]:
        done: list[Request] = []
        self._steps += 1
        tr = self.tracer
        free = [s for s in range(self.ecfg.max_slots) if s not in self._active]
        while self._queue and free:
            slot = free.pop()
            req = self._queue.pop(0)
            now = _now()
            self.metrics.on_admit(req, slot, now, prefill_tokens=len(req.prompt))
            req.admitted_at = now
            self._active[slot] = req
            if tr is not None:
                tr.request_begin(slot, req.uid, t=now, tier=req.tier)
                tr.begin_span(slot, "prefill", t=now, tokens=len(req.prompt))
            self._slot_len[slot] = 0
            for tok in req.prompt[:-1]:
                self._step_slot(slot, tok)
        for slot, req in list(self._active.items()):
            nxt = self._step_slot(slot, (req.out_tokens or req.prompt)[-1])
            req.out_tokens.append(nxt)
            now = _now()
            req.token_times.append(now)
            first = req.first_token_at == 0.0
            if first:
                req.first_token_at = now
            self.metrics.on_token(req, now, first)
            if tr is not None and tr.has_open(slot, "prefill"):
                tr.end_span(slot, "prefill", t=now)
                if first:
                    tr.instant(slot, "first_token", t=now, uid=req.uid)
                tr.begin_span(slot, "decode", t=now, uid=req.uid)
            if len(req.out_tokens) >= req.max_new_tokens or (
                    self.ecfg.eos_token is not None and nxt == self.ecfg.eos_token):
                req.done = True
                req.finished_at = now
                self.metrics.on_finish()
                if tr is not None:
                    if tr.has_open(slot, "decode"):
                        tr.end_span(slot, "decode", t=now)
                    tr.request_end(slot, req.uid, t=now, tokens=len(req.out_tokens))
                done.append(req)
                del self._active[slot]
        return done

    def run(self, max_steps: int = 10_000) -> list[Request]:
        done: list[Request] = []
        steps = 0
        while self.has_work and steps < max_steps:
            steps += 1
            done.extend(self.step())
        return done

    def _step_slot(self, slot: int, token: int) -> int:
        """One decode call for one slot, with its request's tier: the slot's
        view of the cache in, its new tensors written back, the greedy token
        out (one host sync)."""
        ax = self.CACHE_BATCH_AXIS
        full = self.cache
        view = full._replace(length=self._slot_len[slot], **{
            f: getattr(full, f).narrow(ax, slot, 1) for f in full._fields
            if isinstance(getattr(full, f), torch.Tensor)})
        tok = torch.tensor([[token]], dtype=torch.long, device=self.device)
        tier = self._active[slot].tier
        with self.metrics.measure_program("decode_ref", tier, traces=ops.plan_builds):
            logits, new = model_lib.decode_step(self._tier_params[tier], tok, view, self.cfg)
            self.decode_calls += 1
        for f in full._fields:
            dst = getattr(view, f)
            src = getattr(new, f)
            if isinstance(dst, torch.Tensor) and src is not dst \
                    and src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        self._slot_len[slot] += 1
        return int(torch.argmax(logits[0, -1]))
