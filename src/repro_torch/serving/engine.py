"""Paged serving engine: continuous batching over a block-paged KV cache
(port of ``PagedServingEngine`` and the parts of its base class in
``repro/serving/engine.py`` that the greedy dense path runs).

KV lives in a fixed pool of ``num_blocks`` pages of ``block_size`` tokens
(``models.transformer.PagedKVCache``); a host-side :class:`BlockAllocator`
hands pages to slots on demand. Each tick:
  1. admits queued requests (earliest deadline first) whenever a slot and
     enough pages are free;
  2. advances every mid-prefill slot by one chunk (``prefill_chunk``) in one
     ``chunk_prefill_step`` call over all slots;
  3. grows the pages of decode-phase slots, evicting a victim back to the
     queue when the pool runs dry (it resumes by re-prefilling its prompt and
     the tokens it already emitted);
  4. runs one ``decode_step`` over all slots and records each active slot's
     greedy token.

Without ``prefill_chunk`` an admission prefills the whole prompt in one
no-cache forward and scatters whole pages. Under ``kernel_impl='pallas'``
that one-shot path needs the flash attention kernel (a later slice), so the
engine requires chunked prefill there.

Not ported yet, each rejected with a ``ValueError`` that names it: model
banks and elastic tiers, the prefix cache, multi-tenant adapters,
speculative decoding, tensor-parallel meshes, int8 pages, sampling with a
temperature, and telemetry/tracing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import model as model_lib
from ..models import transformer as transformer_lib
from .deployed import DeployedModel

__all__ = ["Request", "RequestRejected", "EngineConfig", "BlockAllocator",
           "PagedServingEngine"]

# internal timestamps use the monotonic clock; only Request.deadline is a
# wall-clock value handed in by the caller
_now = time.monotonic

_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
_EVICT_POLICIES = ("longest_remaining", "lru")


class RequestRejected(ValueError):
    """Raised by ``submit`` when a request can never be served by this engine
    (too long for the cache, or larger than the whole page pool)."""


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
    evictions: int = 0
    requeued_at: float = 0.0
    prefill_emitted: int = 0         # tokens emitted by prefill/chunk programs


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
    # features of later slices: kept so a request for one fails loudly
    greedy: bool = True
    prefix_cache: bool = False
    tier_policy: str = "static"
    spec_k: int = 0
    mesh: str | None = None
    adapters: bool = False
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
        if self.kv_dtype == "int8":
            raise ValueError("kv_dtype='int8' (quantized pages) is not ported yet")
        if self.kv_dtype not in _KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}; expected one of "
                             f"{sorted(_KV_DTYPES)}")
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
        later = {
            "greedy=False (sampling with a temperature)": not self.greedy,
            "prefix_cache (radix prompt cache)": self.prefix_cache,
            "tier_policy='pressure' (elastic tiers)": self.tier_policy != "static",
            "spec_k (speculative decoding)": self.spec_k != 0,
            "mesh (tensor-parallel serving)": self.mesh is not None,
            "adapters (multi-tenant adapters)": self.adapters,
            "telemetry (metrics registry)": self.telemetry,
            "trace (request tracer)": self.trace,
        }
        asked = [name for name, on in later.items() if on]
        if asked:
            raise ValueError(f"not ported yet: {', '.join(asked)}")


def _validate_request(prompt: list[int], max_new_tokens: int, max_len: int):
    if len(prompt) < 1:
        raise RequestRejected("empty prompt")
    if len(prompt) + max_new_tokens > max_len:
        raise RequestRejected(f"prompt({len(prompt)}) + max_new({max_new_tokens}) "
                              f"exceeds cache capacity {max_len}")


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
    """Continuously batched greedy engine over a block-paged KV cache, serving
    one :class:`DeployedModel` on the device its weights live on."""

    def __init__(self, model: DeployedModel, ecfg: EngineConfig | None = None):
        if not isinstance(model, DeployedModel):
            raise ValueError(f"PagedServingEngine serves a DeployedModel, got "
                             f"{type(model).__name__} (model banks are not ported yet)")
        ecfg = ecfg if ecfg is not None else EngineConfig()
        cfg = model.cfg
        if cfg.family != "dense":
            raise ValueError(f"family {cfg.family!r} is not ported yet (dense only)")
        kv_dtype = _KV_DTYPES[ecfg.kv_dtype]
        if cfg.kernel_impl == "pallas":
            if ecfg.prefill_chunk is None:
                raise ValueError("kernel_impl='pallas' needs prefill_chunk: one-shot "
                                 "prefill runs the flash attention kernel, ported in a "
                                 "later slice")
            if kv_dtype != cfg.param_dtype:
                raise ValueError(f"kernel_impl='pallas' needs kv_dtype equal to the "
                                 f"model dtype {cfg.param_dtype}, got {ecfg.kv_dtype!r}")
        self.cfg, self.ecfg, self.model = cfg, ecfg, model
        self.params = model.params
        self.device = model.params["embed"]["embedding"].device
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
                                                device=self.device)
        self._table = np.full((ecfg.max_slots, self._nb_slot), self.num_blocks, np.int32)
        self._table_dirty = False
        self._pages: dict[int, list[int]] = {}
        self._ptarget: dict[int, int] = {}
        self._progress: dict[int, int] = {}   # slot -> tokens prefilled (mid-prefill)
        self._queue: list[Request] = []
        self._active: dict[int, Request] = {}
        self._uid = 0
        self._steps = 0
        self._last_token = np.zeros(ecfg.max_slots, np.int64)
        self.decode_calls = 0
        self.prefill_calls = 0
        self.chunk_calls = 0
        self.evictions = 0

    # ------------------------------------------------------------ intake ---

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               deadline: float | None = None, submitted_at: float | None = None) -> int:
        _validate_request(prompt, max_new_tokens, self.ecfg.max_len)
        need = -(-(len(prompt) + max_new_tokens) // self._bs)
        if need > self.num_blocks:
            raise RequestRejected(f"request needs {need} KV pages but the whole pool "
                                  f"holds {self.num_blocks}")
        self._uid += 1
        self._queue.append(Request(
            self._uid, list(prompt), max_new_tokens, deadline=deadline,
            submitted_at=_now() if submitted_at is None else submitted_at))
        return self._uid

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def _order_queue(self):
        """Earliest deadline first; then evicted requests, then FIFO."""
        self._queue.sort(key=lambda r: (r.deadline is None, r.deadline or 0.0,
                                        -r.evictions, r.uid))

    # ----------------------------------------------------- device programs ---

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _device_cache(self):
        if self._table_dirty:
            self.cache.block_table.copy_(torch.from_numpy(self._table))
            self._table_dirty = False
        return self.cache

    def _decode(self, tokens: np.ndarray, active: np.ndarray) -> np.ndarray:
        cache = self._device_cache()
        logits, new = model_lib.decode_step(self.params, self._to_dev(tokens), cache,
                                            self.cfg)
        # only active slots advance; inactive slots wrote a junk row at their
        # frozen position (unmapped pages drop it; the next insert overwrites)
        length = torch.where(self._to_dev(active), new.length, cache.length)
        self.cache = new._replace(length=length)
        self.decode_calls += 1
        return logits[:, -1].argmax(-1).cpu().numpy()

    def _chunk_call(self, tokens, counts, starts) -> np.ndarray:
        """One chunk over all slots: rows with counts > 0 reset their length
        to the host-tracked progress (a fresh slot may inherit a stale device
        length) and insert there; rows with counts == 0 keep their length and
        write junk past it that is never attended."""
        cache = self._device_cache()
        counts_d = self._to_dev(counts)
        n0 = torch.where(counts_d > 0, self._to_dev(starts), cache.length)
        logits, self.cache = model_lib.chunk_prefill_step(
            self.params, self._to_dev(tokens), counts_d, cache._replace(length=n0), self.cfg)
        self.chunk_calls += 1
        last = torch.from_numpy(np.maximum(counts - 1, 0).astype(np.int64)).to(self.device)
        rows = torch.arange(len(counts), device=self.device)
        return logits[rows, last].argmax(-1).cpu().numpy()

    def _prefill_call(self, tokens, lengths, slot_ids, page_map) -> np.ndarray:
        """One-shot prefill of admitted prompts: no-cache forward, whole
        prompt pages scattered into the pool; padded rows drop."""
        cache = self._device_cache()
        logits, kvs = model_lib._forward(self.params, {"tokens": self._to_dev(tokens)},
                                         self.cfg, collect_kv=True)
        transformer_lib.scatter_prefill_pages(cache, kvs, self._to_dev(page_map))
        keep = slot_ids < self.ecfg.max_slots
        cache.length[self._to_dev(slot_ids[keep].astype(np.int64))] = \
            self._to_dev(lengths[keep])
        self.prefill_calls += 1
        rows = torch.arange(len(lengths), device=self.device)
        last = self._to_dev((lengths - 1).astype(np.int64))
        return logits[rows, last].argmax(-1).cpu().numpy()

    # ------------------------------------------------------------- steps ---

    def _bucket(self, n: int) -> int:
        b = self.ecfg.min_bucket
        while b < n:
            b *= 2
        b = min(b, self.ecfg.max_len)
        return min(-(-max(b, self._bs) // self._bs) * self._bs, self._max_len)

    def _admit(self, free: list[int], done: list[Request]):
        """Admit every queued request that a free slot + free pages cover.
        Chunked mode reserves the first chunk's pages and hands the slot to
        ``_prefill_progress``; one-shot mode prefills here."""
        if not self._queue or not free:
            return
        self._order_queue()
        reserve = self.ecfg.decode_reserve or self._bs
        admitted: list[tuple[int, Request, list[int], int]] = []
        while self._queue and free:
            req = self._queue[0]
            plen = len(req.prompt) + len(req.out_tokens)   # evicted requests resume
            if self._chunk is not None and plen > self._chunk:
                want = self._chunk      # first chunk only; the rest reserves as it goes
            else:
                remaining = max(req.max_new_tokens - len(req.out_tokens), 1)
                want = plen + min(max(reserve, 1), remaining)
            pages = self.allocator.alloc(min(-(-want // self._bs), self._nb_slot))
            if pages is None:
                break                   # pool full: stay queued
            self._queue.pop(0)
            slot = free.pop()
            req.admitted_at = _now()
            self._active[slot] = req
            self._pages[slot] = pages
            self._table[slot, : len(pages)] = pages
            self._table_dirty = True
            admitted.append((slot, req, pages, plen))
        if not admitted:
            return
        if self._chunk is not None:
            for slot, _, _, plen in admitted:
                self._progress[slot] = 0
                self._ptarget[slot] = plen
            return
        s = self.ecfg.max_slots
        bucket = self._bucket(max(plen for *_, plen in admitted))
        tokens = np.zeros((s, bucket), np.int32)
        lengths = np.ones((s,), np.int32)
        slot_ids = np.full((s,), s, np.int32)
        page_map = np.full((s, bucket // self._bs), self.num_blocks, np.int32)
        for i, (slot, req, pages, plen) in enumerate(admitted):
            tokens[i, :plen] = req.prompt + req.out_tokens
            lengths[i] = plen
            slot_ids[i] = slot
            nblk = -(-plen // self._bs)
            page_map[i, :nblk] = pages[:nblk]
        firsts = self._prefill_call(tokens, lengths, slot_ids, page_map)
        for i, (slot, req, _, _) in enumerate(admitted):
            req.prefill_emitted += 1
            self._record(slot, req, int(firsts[i]), free, done)

    def _grow(self, slot: int, need: int) -> bool:
        """Allocate pages one at a time until the slot holds ``need``."""
        while len(self._pages[slot]) < need:
            page = self.allocator.alloc(1)
            if page is None:
                return False
            self._table[slot, len(self._pages[slot])] = page[0]
            self._pages[slot].append(page[0])
            self._table_dirty = True
        return True

    def _prefill_progress(self, free: list[int], done: list[Request]):
        """Advance every mid-prefill slot by ONE chunk in one call. A slot
        whose chunk cannot get pages stalls at its last completed chunk
        (prefill growth never evicts); if EVERY active slot is a stalled
        prefill, the least-progressed one is evicted and the survivors take
        its pages within this tick."""
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
        tokens = np.zeros((s, self._chunk), np.int32)
        counts = np.zeros((s,), np.int32)
        starts = np.zeros((s,), np.int32)
        for slot in ready:
            req = self._active[slot]
            p = self._progress[slot]
            c = min(self._chunk, self._ptarget[slot] - p)
            tokens[slot, :c] = (req.prompt + req.out_tokens)[p : p + c]
            counts[slot] = c
            starts[slot] = p
        firsts = self._chunk_call(tokens, counts, starts)
        for slot in ready:
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
        """Grow each decode-phase slot's pages to cover this tick's KV write
        (the latest token lands at len(prompt) + len(out) - 1); evict when the
        pool is dry."""
        for slot in list(self._active):
            req = self._active.get(slot)
            if req is None or slot in self._progress:
                continue
            write_pos = len(req.prompt) + len(req.out_tokens) - 1
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
        """Return the slot's pages and re-queue its request; it re-prefills
        prompt + generated tokens on re-admission."""
        req = self._active.pop(slot)
        req.evictions += 1
        req.requeued_at = _now()
        self.evictions += 1
        self._release(slot)
        self._queue.append(req)
        free.append(slot)

    def _release(self, slot: int):
        pages = self._pages.pop(slot, None)
        if pages:
            self.allocator.release(pages)
        self._table[slot, :] = self.num_blocks
        self._table_dirty = True
        self._progress.pop(slot, None)
        self._ptarget.pop(slot, None)

    def _record(self, slot: int, req: Request, tok: int, free: list[int],
                done: list[Request]):
        now = _now()
        req.out_tokens.append(tok)
        req.token_times.append(now)
        if req.first_token_at == 0.0:
            req.first_token_at = now
        self._last_token[slot] = tok
        if len(req.out_tokens) >= req.max_new_tokens or (
                self.ecfg.eos_token is not None and tok == self.ecfg.eos_token):
            req.done = True
            req.finished_at = now
            done.append(req)
            del self._active[slot]
            free.append(slot)
            self._release(slot)

    def _decode_tick(self, active: np.ndarray, free: list[int], done: list[Request]):
        s = self.ecfg.max_slots
        tokens = np.zeros((s, 1), np.int32)
        for slot in np.nonzero(active)[0]:
            tokens[slot, 0] = self._last_token[slot]
        out = self._decode(tokens, active)
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
