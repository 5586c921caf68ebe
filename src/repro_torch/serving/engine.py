"""Paged serving engine: continuous batching over a block-paged KV cache,
serving a :class:`~repro_torch.serving.elastic.ModelBank` of budget tiers
(port of ``PagedServingEngine`` and the parts of its base class in
``repro/serving/engine.py`` that the dense path runs).

KV lives in a fixed pool of ``num_blocks`` pages of ``block_size`` tokens
(``models.transformer.PagedKVCache``); a host-side :class:`BlockAllocator`
hands pages to slots on demand. The pool and block table carry no tier, so
every tier of the bank serves over the one cache. Each tick:
  1. admits queued requests (earliest deadline first) whenever a slot and
     enough pages are free. With the prefix cache on, matching full prompt
     pages are attached read-only and only the suffix is prefilled; a hit
     whose first write lands inside an attached page copies that page first
     (copy-on-write, one batched page-copy kernel call per tick);
  2. under ``tier_policy='pressure'`` updates the tier controller from the
     pool's free (and reclaimable) pages and recomputes each slot's effective
     tier;
  3. advances every mid-prefill slot by one chunk (``prefill_chunk``), one
     ``chunk_prefill_step`` call per active tier;
  4. grows the pages of decode-phase slots, reclaiming cached prefix pages
     first and evicting a victim back to the queue when the pool runs dry (it
     resumes by re-prefilling, or by reattaching the pages it published);
  5. runs one ``decode_step`` per active tier, each masked to that tier's
     slots, and records each active slot's next token.

Without ``prefill_chunk`` an admission prefills the whole prompt in one
no-cache forward (the flash attention kernel under ``kernel_impl='pallas'``)
and scatters whole pages.

Tokens are greedy, or with ``greedy=False`` sampled at ``temperature`` by
Gumbel-max on the device (``_sample``): the noise is a pure function of
``(seed, engine step, salt, slot id, vocab index)`` (``keyed_uniform``, a
counter-based integer hash), so a slot's stream does not depend on the batch
or its row order, and decode (salt 0), prefill and chunk ends (salt 1) and
the speculative engine's draft steps (``2 + i``) and verify (``2 + k``) never
share noise. ``kv_dtype='int8'`` stores quantized pages with per-(position,
head) scales (``serving/kv_quant.py``), dequantized in the page gather, under
f32 activations. ``serving/speculative.py`` subclasses this engine.

Multi-tenant adapters (``serving/adapters.py``): an engine built on an
:class:`~repro_torch.serving.adapters.AdapterBank` with
``EngineConfig(adapters=True)`` serves N registered (L + S) adapters over one
shared base. A request picks its adapter at ``submit``; admission pins it
into the bank's device pool (an LRU swap when it is not resident). In
``batched`` mode one program call serves slots that run different adapters
(the per-slot SLR kernel reads the slot -> pool-row map on the device); in
``grouped`` mode the engine runs one call per (tier, pool row). With the
prefix cache on, each adapter has its own radix index (KV pages depend on
the adapter's weights) over the one shared allocator.

``ReferenceEngine`` is the JAX package's per-slot, per-token engine over a
contiguous float32 cache (one decode call and one host sync per slot per
token, prompts fed token by token): the serving path of the hybrid family,
whose SSM state has no per-slot lengths, and the measured baseline for the
dense one. Features it cannot give raise :class:`EngineCapabilityError` at
construction, with its ``capabilities()`` in the message.

Not ported yet, each rejected with a ``ValueError`` that names it:
tensor-parallel meshes, and the telemetry registry and tracer. The counters
the JAX engine keeps in its registry (prefix lookups, hits, hit tokens,
copy-on-write copies, reattached pages, tier switches, downshift ticks,
adapter swaps, resident adapters, tokens by adapter) are plain integers
here.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.paged_attention import takes_pages
from ..models import model as model_lib
from ..models import transformer as transformer_lib
from .adapters import AdapterBank, AdapterError
from .deployed import DeployedModel
from .elastic import ModelBank, TierController, TierControllerConfig
from .prefix_cache import PrefixCache

__all__ = ["Request", "RequestRejected", "EngineCapabilityError", "EngineConfig",
           "BlockAllocator", "PagedServingEngine", "ReferenceEngine", "BATCHED_FAMILIES",
           "keyed_uniform", "unit_interval", "gumbel_argmax", "decode_emitted_tokens"]

BATCHED_FAMILIES = ("dense",)   # ported cache families with per-slot lengths

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
    policy, the prefix cache, adapters) was requested of an engine that
    cannot give it. A ``RequestRejected``, so callers handle both through
    one error path."""


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
    # features of later slices: kept so a request for one fails loudly
    mesh: str | None = None
    adapters: bool = False             # serve an AdapterBank (serving/adapters.py)
    max_resident_adapters: int | None = None  # device adapter-pool rows; None = all
    telemetry: bool = False
    trace: bool = False

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
        later = {
            "mesh (tensor-parallel serving)": self.mesh is not None,
            "telemetry (metrics registry)": self.telemetry,
            "trace (request tracer)": self.trace,
        }
        asked = [name for name, on in later.items() if on]
        if asked:
            raise ValueError(f"not ported yet: {', '.join(asked)}")


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


def _validate_request(prompt: list[int], max_new_tokens: int, max_len: int):
    if len(prompt) < 1:
        raise RequestRejected("empty prompt")
    if len(prompt) + max_new_tokens > max_len:
        raise RequestRejected(f"prompt({len(prompt)}) + max_new({max_new_tokens}) "
                              f"exceeds cache capacity {max_len}")


def _resolve_engine_args(name: str, model, ecfg,
                         adapters_agree: bool = True) -> tuple[ModelBank, EngineConfig]:
    """``Engine(bank, ecfg)``; a bare ``DeployedModel`` is wrapped as a
    one-tier bank. With ``adapters_agree`` an ``AdapterBank`` and
    ``ecfg.adapters`` must agree."""
    if isinstance(model, DeployedModel):
        model = ModelBank.single(model.cfg, model)
    if not isinstance(model, ModelBank):
        raise TypeError(f"{name} expects a ModelBank (serving.elastic) or a "
                        f"DeployedModel, got {type(model).__name__}")
    if ecfg is not None and not isinstance(ecfg, EngineConfig):
        raise TypeError(f"{name}(bank, ecfg): ecfg must be an EngineConfig, got "
                        f"{type(ecfg).__name__}")
    ecfg = ecfg if ecfg is not None else EngineConfig()
    # neither a silently ignored AdapterBank nor a flag with no pool
    if adapters_agree and ecfg.adapters != isinstance(model, AdapterBank):
        raise ValueError("adapters=True needs an AdapterBank (serving.adapters) as the "
                         "engine's bank, and an AdapterBank needs adapters=True; got "
                         f"adapters={ecfg.adapters} with {type(model).__name__}")
    return model, ecfg


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


class PagedServingEngine:
    """Continuously batched engine over a block-paged KV cache, serving every
    tier of a :class:`ModelBank` on the device its weights live on."""

    _speculative = False
    _write_window = 1      # KV positions one decode tick writes per slot

    def __init__(self, model: ModelBank | DeployedModel, ecfg: EngineConfig | None = None):
        bank, ecfg = _resolve_engine_args(type(self).__name__, model, ecfg)
        cfg = bank.cfg
        if cfg.family not in BATCHED_FAMILIES:
            raise ValueError(f"batched engine needs a KV-cache family, got {cfg.family!r}; "
                             "use ReferenceEngine for ssm/hybrid/encdec")
        if ecfg.spec_k and not self._speculative:
            raise EngineCapabilityError(
                f"{type(self).__name__} does not speculate (spec_k={ecfg.spec_k} "
                "requested); speculative decoding needs SpeculativeEngine "
                "(serving/speculative.py). Engine capabilities: "
                f"{json.dumps(self.capabilities(), sort_keys=True)}")
        if ecfg.adapters and self._speculative:
            raise EngineCapabilityError("SpeculativeEngine does not serve AdapterBanks (draft "
                                        "and verify would each need a pool); use "
                                        "PagedServingEngine")
        kv_dtype, quantized = page_pools(cfg, ecfg.kv_dtype, "kv_dtype")
        self.cfg, self.ecfg, self.bank = cfg, ecfg, bank
        self._adapters: AdapterBank | None = bank if ecfg.adapters else None
        if self._adapters is not None:
            self._adapters.materialize(ecfg.max_resident_adapters)
        self._tier_params, self._default_tier = _bank_tier_state(bank, ecfg)
        self.params = self._tier_params[self._default_tier]
        self.device = self.params["embed"]["embedding"].device
        bs = ecfg.block_size
        self._bs = bs
        self._max_len = -(-ecfg.max_len // bs) * bs
        self._nb_slot = self._max_len // bs
        self.num_blocks = ecfg.num_blocks or ecfg.max_slots * self._nb_slot
        self.allocator = BlockAllocator(self.num_blocks)
        self._chunk = None if ecfg.prefill_chunk is None \
            else min(ecfg.prefill_chunk, self._max_len)
        self.cache = model_lib.init_paged_cache(cfg, ecfg.max_slots, self.num_blocks, bs,
                                                self._nb_slot, dtype=kv_dtype,
                                                device=self.device, quantized=quantized)
        self._table = np.full((ecfg.max_slots, self._nb_slot), self.num_blocks, np.int32)
        self._table_dirty = False
        self._pages: dict[int, list[int]] = {}
        self._ptarget: dict[int, int] = {}
        self._progress: dict[int, int] = {}   # slot -> tokens prefilled (mid-prefill)
        # slot -> device length to set before the next program: a prefix-hit
        # admission's length is stale until its first chunk runs, and junk
        # rows other programs write meanwhile must not land in shared pages
        self._len_reset: dict[int, int] = {}
        self._queue: list[Request] = []
        self._active: dict[int, Request] = {}
        self._uid = 0
        self._steps = 0
        self._last_token = np.zeros(ecfg.max_slots, np.int64)
        # effective tier per slot (requested tier + controller downshift)
        self._slot_tier = np.zeros(ecfg.max_slots, np.int64)
        # multi-tenant: pool row per slot (batched calls bind this map as it
        # is, so an idle slot keeps a valid row) and the adapter each slot
        # pinned (unpinned when the slot releases)
        self._slot_pool = np.zeros(ecfg.max_slots, np.int32)
        self._slot_adapter: dict[int, int] = {}
        self._tier_shift = 0
        self.tier_controller = None
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
        self.decode_calls = 0
        self.prefill_calls = 0
        self.chunk_calls = 0
        self.evictions = 0
        self.tier_switches = 0
        self.downshift_ticks = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0      # prompt tokens served from the index
        self.cow_copies = 0             # pages privatized by copy-on-write
        self.reattached_pages = 0       # pages evicted slots got back on resume
        self.adapter_swaps = 0          # pool rows swapped in at admission
        self.adapter_tokens: dict[int, int] = {}   # emitted tokens by adapter id
        self.resident_adapters = 0 if self._adapters is None \
            else len(self._adapters.resident)

    @classmethod
    def capabilities(cls) -> dict:
        """Which families this engine serves, its KV layout and features."""
        return {
            "engine": cls.__name__,
            "families": ["dense"],
            "kv": "paged",
            "features": {
                "kv_dtype": ["float32", "bfloat16", "int8"],
                "continuous_batching": True,
                "deadlines_edf": True,
                "chunked_prefill": True,
                "eviction_resume": True,
                "speculative": False,
                "elastic_tiers": True,
                "tier_pressure_controller": True,
                "prefix_caching": True,
                "tensor_parallel": False,
                "multi_tenant_adapters": True,
            },
        }

    def stats_snapshot(self) -> dict:
        """Host-side scheduler counters."""
        return {"engine": type(self).__name__, "steps": self._steps,
                "decode_calls": self.decode_calls, "prefill_calls": self.prefill_calls,
                "chunk_calls": self.chunk_calls}

    # ------------------------------------------------------------ intake ---

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               deadline: float | None = None, tier: int | None = None,
               submitted_at: float | None = None, adapter: int | None = None) -> int:
        """Enqueue a request; ``adapter`` picks a registered AdapterBank
        adapter (None = the bank's default; rejected on plain banks)."""
        _validate_request(prompt, max_new_tokens, self.ecfg.max_len)
        need = -(-(len(prompt) + max_new_tokens) // self._bs)
        if need > self.num_blocks:
            raise RequestRejected(f"request needs {need} KV pages but the whole pool "
                                  f"holds {self.num_blocks}")
        tier = self._resolve_tier(tier)
        adapter = self._resolve_adapter(adapter)
        self._uid += 1
        self._queue.append(Request(
            self._uid, list(prompt), max_new_tokens, deadline=deadline, tier=tier,
            submitted_at=_now() if submitted_at is None else submitted_at, adapter=adapter))
        return self._uid

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
        """Integrate page pressure into the downshift before anyone can be
        evicted. Index-only cached pages count as free: one ``reclaim``
        away from the pool."""
        if self.tier_controller is None:
            return
        free_like = self.allocator.free_blocks + sum(
            pc.reclaimable_pages for pc in self._all_prefixes())
        self._tier_shift = self.tier_controller.update(free_like / self.num_blocks)
        if self._tier_shift > 0:
            self.downshift_ticks += 1

    def _refresh_slot_tiers(self):
        """Recompute each active slot's effective tier: host bookkeeping only,
        the KV cache carries no tier."""
        for slot, req in self._active.items():
            eff = self._effective_tier(req)
            if eff != self._slot_tier[slot]:
                self.tier_switches += 1
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
            done.append(req)
            return "gone", None
        if row is None:
            return "busy", None
        if swapped:
            self.adapter_swaps += 1
        self._adapters.pin(req.adapter)
        self.resident_adapters = len(self._adapters.resident)
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

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

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
        cache = self._device_cache()
        logits, new = model_lib.decode_step(self._call_params(key, self._slot_pool),
                                            self._to_dev(tokens), cache, self.cfg)
        # only active slots advance; inactive slots wrote a junk row at their
        # frozen position (unmapped pages drop it; the next insert overwrites)
        length = torch.where(self._to_dev(active), new.length, cache.length)
        self.cache = new._replace(length=length)
        self.decode_calls += 1
        return self._sample(logits[:, -1], salt=0).cpu().numpy()

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
            params, self._to_dev(tokens), counts_d, cache._replace(length=n0), self.cfg)
        self.chunk_calls += 1
        last = torch.from_numpy(np.maximum(counts - 1, 0).astype(np.int64)).to(self.device)
        rows = torch.arange(len(counts), device=self.device)
        return self._sample(logits[rows, last], salt=1), n0

    def _chunk_call(self, key, tokens, counts, starts) -> np.ndarray:
        """One chunk over all slots (``_chunk_target``)."""
        tok, _ = self._chunk_target(self._call_params(key, self._slot_pool), tokens, counts,
                                    starts)
        return tok.cpu().numpy()

    def _prefill_call(self, key, tokens, lengths, slot_ids, page_map, rows) -> np.ndarray:
        """One-shot prefill of admitted prompts: no-cache forward, whole
        prompt pages scattered into the pool; padded rows drop. ``rows`` is
        the group-indexed pool-row map (batched adapter mode)."""
        cache = self._device_cache()
        logits, kvs = model_lib._forward(self._call_params(key, rows),
                                         {"tokens": self._to_dev(tokens)}, self.cfg,
                                         collect_kv=True)
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
        self._apply_cow(src, dst)

    def _apply_cow(self, src: torch.Tensor, dst: torch.Tensor):
        """The device copies of copy-on-write (the speculative engine also
        copies its draft pools here: they ride the same page ids)."""
        transformer_lib.copy_cache_pages(self.cache, src, dst)

    # ------------------------------------------------------------- steps ---

    def _bucket(self, n: int) -> int:
        b = self.ecfg.min_bucket
        while b < n:
            b *= 2
        b = min(b, self.ecfg.max_len)
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
        self.prefix_lookups += 1
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
                self.cow_copies += 1
            pages += fresh
            self._queue.pop(0)
            slot = free.pop()
            req.admitted_at = _now()
            self._active[slot] = req
            self._slot_tier[slot] = self._effective_tier(req)
            if arow is not None:
                self._slot_pool[slot] = arow
                self._slot_adapter[slot] = req.adapter
            self._pages[slot] = pages
            self._table[slot, : len(pages)] = pages
            self._table_dirty = True
            if hit:
                self.prefix_hits += 1
                self.prefix_hit_tokens += s0
                if req.evictions:
                    self.reattached_pages += len(hit)
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
            firsts = self._chunk_call(key, tokens, counts, starts)
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

    def _pre_decode(self, free: list[int]):
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
        self.evictions += 1
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
        if self._adapters is not None:
            # LRU residency may swap the adapter out once no slot streams it
            aid = self._slot_adapter.pop(slot, None)
            if aid is not None:
                self._adapters.unpin(aid)
        pages = self._pages.pop(slot, None)
        if pages:
            # release, not free: attached pages fall back to the index
            self.allocator.release(pages)
        self._table[slot, :] = self.num_blocks
        self._table_dirty = True
        self._len_reset.pop(slot, None)
        self._progress.pop(slot, None)
        self._ptarget.pop(slot, None)

    def _record(self, slot: int, req: Request, tok: int, free: list[int],
                done: list[Request]):
        now = _now()
        req.out_tokens.append(tok)
        req.token_times.append(now)
        if req.first_token_at == 0.0:
            req.first_token_at = now
        if req.adapter is not None:
            self.adapter_tokens[req.adapter] = self.adapter_tokens.get(req.adapter, 0) + 1
        self._last_token[slot] = tok
        if len(req.out_tokens) >= req.max_new_tokens or (
                self.ecfg.eos_token is not None and tok == self.ecfg.eos_token):
            req.done = True
            req.finished_at = now
            done.append(req)
            self._retire(slot, req)
            del self._active[slot]
            free.append(slot)
            self._release(slot)

    def _decode_tick(self, active: np.ndarray, free: list[int], done: list[Request]):
        """One decode per active tier over the shared cache, each masked to
        that tier's slots."""
        s = self.ecfg.max_slots
        tokens = np.zeros((s, 1), np.int32)
        decode_slots = [int(x) for x in np.nonzero(active)[0]]
        for slot in decode_slots:
            tokens[slot, 0] = self._last_token[slot]
        out = np.zeros((s,), np.int64)
        for key, slots in self._tier_groups(decode_slots):
            mask = np.zeros((s,), bool)
            mask[slots] = True
            out[slots] = self._decode(key, tokens, mask)[slots]
        for slot, req in list(self._active.items()):
            if slot not in self._progress:
                self._record(slot, req, int(out[slot]), free, done)

    @torch.no_grad()
    def step(self) -> list[Request]:
        """One engine tick; returns the requests that finished in it."""
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
        self._pre_decode(free)
        active = np.zeros((s,), bool)
        for slot in self._active:
            if slot not in self._progress:
                active[slot] = True
        if active.any():
            self._decode_tick(active, free, done)
        return done

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive everything to completion."""
        done: list[Request] = []
        steps = 0
        while self.has_work and steps < max_steps:
            steps += 1
            done.extend(self.step())
        return done


# -------------------------------------------------------------- reference ---


class ReferenceEngine:
    """The per-slot, per-token engine (port of the JAX package's
    ``ReferenceEngine``): a contiguous float32 cache for ``max_slots`` rows,
    a per-slot view of it for every decode call (each cache tensor's batch
    axis ``CACHE_BATCH_AXIS`` narrowed to the slot, the length set to the
    slot's own) and a write-back, one ``decode_step`` call and one host sync
    per slot per token. Prompts are fed through the same decode step token by
    token, the last prompt token by the first tick. Each slot decodes with
    its request's bank tier. It serves every ported family (the hybrid's
    SSM state has no per-slot lengths, so the paged engine cannot). Its
    tokens are always greedy: like the JAX package's, it ignores
    ``greedy=False`` and ``temperature``."""

    CACHE_BATCH_AXIS = 1     # the batch axis of every tensor of LMCache and HybridCache

    def __init__(self, model: ModelBank | DeployedModel, ecfg: EngineConfig | None = None):
        bank, ecfg = _resolve_engine_args(type(self).__name__, model, ecfg,
                                          adapters_agree=False)
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

    @classmethod
    def capabilities(cls) -> dict:
        return {
            "engine": cls.__name__,
            "families": ["dense", "hybrid"],
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
        """The batched engines' counters; prompts go through the decode
        step, so no prefill call is counted."""
        return {"engine": type(self).__name__, "steps": self._steps,
                "decode_calls": self.decode_calls, "prefill_calls": 0}

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               deadline: float | None = None, tier: int | None = None,
               submitted_at: float | None = None, adapter: int | None = None) -> int:
        _validate_request(prompt, max_new_tokens, self.ecfg.max_len)
        tier = _resolve_request_tier(self.bank, self._default_tier, tier)
        if adapter is not None:
            raise RequestRejected(f"adapter={adapter}: ReferenceEngine serves no adapters "
                                  "(AdapterBank needs the batched engines)")
        self._uid += 1
        self._queue.append(Request(
            self._uid, list(prompt), max_new_tokens, deadline=deadline, tier=tier,
            submitted_at=_now() if submitted_at is None else submitted_at))
        return self._uid

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def step(self) -> list[Request]:
        """One tick: admit into free slots (feeding each prompt but its last
        token), then one token for every active slot."""
        done: list[Request] = []
        self._steps += 1
        free = [s for s in range(self.ecfg.max_slots) if s not in self._active]
        while self._queue and free:
            slot = free.pop()
            req = self._queue.pop(0)
            req.admitted_at = _now()
            self._active[slot] = req
            self._slot_len[slot] = 0
            for tok in req.prompt[:-1]:
                self._step_slot(slot, tok)
        for slot, req in list(self._active.items()):
            nxt = self._step_slot(slot, (req.out_tokens or req.prompt)[-1])
            req.out_tokens.append(nxt)
            now = _now()
            req.token_times.append(now)
            if req.first_token_at == 0.0:
                req.first_token_at = now
            if len(req.out_tokens) >= req.max_new_tokens or (
                    self.ecfg.eos_token is not None and nxt == self.ecfg.eos_token):
                req.done = True
                req.finished_at = now
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
        params = self._tier_params[self._active[slot].tier]
        logits, new = model_lib.decode_step(params, tok, view, self.cfg)
        self.decode_calls += 1
        for f in full._fields:
            dst = getattr(view, f)
            src = getattr(new, f)
            if isinstance(dst, torch.Tensor) and src is not dst \
                    and src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        self._slot_len[slot] += 1
        return int(torch.argmax(logits[0, -1]))
