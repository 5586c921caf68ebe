"""Elastic self-speculative decoding on the paged serving engine (port of
``repro/serving/speculative.py``).

Every SALAAD deployment ships its own draft model: a low-HPA-budget tier of
the SAME SLR weights. :class:`SpeculativeEngine` serves a
:class:`~repro_torch.serving.elastic.ModelBank`'s ``spec_target_tier``
(default 0, the largest) and drafts with its ``spec_draft_tier`` (default
-1, the cheapest): a draft proposes ``k`` tokens per slot per tick, the
target scores all ``k`` positions of all active slots in ONE k-wide paged
forward, and acceptance keeps the emitted stream the target's own.

Two draft schedules share the verify and rollback machinery (per tick,
context length n, last emitted token ``t_last``):

``parallel`` (the greedy default at k >= 2): both models run ONE k-wide
forward over the window ``[t_last, g_1, .., g_{k-1}]``, the g_i the draft's
predictions from the previous tick (zeros on a fresh slot). The target's
greedy chain t_0..t_{k-1} confirms g_i iff g_i == t_{i-1}, prefix by prefix;
the tick emits the confirmed guesses and t_a, 1 to k tokens for ~2 forwards.
The draft runs the refined window ``[t_last, t_0..t_{k-2}]`` and the host
re-aligns its chain as the next tick's guesses.

``sequential`` (the sampled default): the draft autoregresses k proposals
(k single-token paged decodes), the target verifies the window k-wide, and
exact rejection sampling (:func:`rejection_sample`) keeps the target's
distribution token for token; greedy acceptance is the longest prefix of
drafts equal to the target's argmax chain.

Target KV for the window lands at n..n+k-1 of the target pools, draft KV in
the draft's own pools (``spec_draft_kv_dtype``, bf16 by default: under an f32
model its paged kernels take f32 queries over bf16 pages), and both caches
share ONE block table, so admission, page growth (``_write_window`` = k),
eviction and resume are the base engine's, and rollback is a per-slot length
reset to n + emitted: rejected positions are overwritten by the next tick.

The port's caches update in place (``models/attention.py``), where the JAX
package donated buffers: a draft call sees the target's lengths as a tensor
of its own (the pre-call ``n0``), and no draft call advances the target's
length. Copy-on-write copies the draft pools with the target's
(``_apply_cow``). Noise is keyed as in the base engine: draft step i uses
salt ``2 + i``, the verify ``2 + k``.

``spec_adaptive`` adapts k with :class:`SpecController`, an integral
controller on the per-slot acceptance EMA, clamped to ``[1 or 2, spec_k]``.
``drafted_tokens`` and ``accepted_tokens`` are views over the registry's
``serve_spec_tokens_total``; each tick is the ``spec_decode[k={k}]``
program, timed with its host fetch, and reports ``on_spec_tick``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops
from ..models import model as model_lib
from ..models import transformer as transformer_lib
from .engine import (
    EngineCapabilityError,
    EngineConfig,
    PagedServingEngine,
    Request,
    RequestRejected,
    gumbel_argmax,
    keyed_uniform,
    page_pools,
)

__all__ = ["SpeculativeEngine", "SpecController", "SpecControllerConfig", "rejection_sample"]

_SLOT_EMA = 0.8   # per-slot acceptance smoothing (feeds the k controller)


# ------------------------------------------------------- rejection sampling ---


def rejection_sample(key: tuple[int, ...], drafts: torch.Tensor, draft_probs: torch.Tensor,
                     target_probs: torch.Tensor, slots: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact speculative rejection sampling (Leviathan et al. '23).

    ``drafts`` (S, k) are the proposals d_1..d_k, ``draft_probs`` and
    ``target_probs`` (S, k, V) the draft's p_i and the target's q_i at each
    position. Position i accepts its draft with probability min(1,
    q_i(d) / p_i(d)); the first rejected position resamples from the
    residual norm(max(q_i - p_i, 0)) (q_i itself where the residual is 0),
    which makes every emitted token exactly target-distributed. Returns
    ``(out, accepted)``: ``out[:, :a]`` are the accepted drafts, ``out[:, a]``
    the corrective token when ``a < k``, zeros past it. The uniforms and the
    corrective draw's Gumbel noise are keyed by ``key`` and each row's slot
    id (``slots``, default the row index), so slots never correlate. When
    p == q the ratio is 1 and every draft is accepted."""
    s, k = drafts.shape
    if slots is None:
        slots = torch.arange(s, device=drafts.device)
    d = drafts.long()
    p_tok = torch.gather(draft_probs, -1, d[..., None])[..., 0]
    q_tok = torch.gather(target_probs, -1, d[..., None])[..., 0]
    u = keyed_uniform(tuple(key) + (0,), slots, k)
    accept = u < torch.clamp_max(q_tok / torch.clamp_min(p_tok, 1e-30), 1.0)
    a = torch.cumprod(accept.long(), dim=1).sum(dim=1)                 # (S,) in 0..k
    rows = torch.arange(s, device=drafts.device)
    ai = torch.clamp_max(a, k - 1)       # read only where a < k
    q_a, p_a = target_probs[rows, ai], draft_probs[rows, ai]
    resid = torch.clamp_min(q_a - p_a, 0.0)
    tot = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(tot > 0, resid / torch.where(tot > 0, tot, torch.ones_like(tot)), q_a)
    corrective = gumbel_argmax(torch.log(torch.clamp_min(resid, 1e-38)), 1.0,
                               tuple(key) + (1,), slots)
    idx = torch.arange(k, device=drafts.device)[None, :]
    out = torch.where(idx < a[:, None], d,
                      torch.where(idx == a[:, None], corrective[:, None], torch.zeros_like(d)))
    return out, a


# --------------------------------------------------------------- controller ---


@dataclass(frozen=True)
class SpecControllerConfig:
    target_accept: float = 0.7  # per-draft-token acceptance the window aims at
    gain: float = 2.0           # integral gain: tokens of k per unit error
    ema: float = 0.8            # smoothing of the observed acceptance rate


class SpecController:
    """I-controller over the draft window k: ``k_f <- clip(k_f + gain *
    (acc_ema - target), k_min, k_max)``, read as ``round(k_f)``. High
    acceptance grows the window, low acceptance shrinks it. Host-only."""

    def __init__(self, k_init: int, k_max: int, k_min: int = 1,
                 cfg: SpecControllerConfig = SpecControllerConfig()):
        self.cfg = cfg
        self.k_min = int(k_min)     # the parallel schedule floors at 2: a k=1
        #                             window has no verifiable guess
        self.k_max = int(k_max)
        self.k_f = float(k_init)
        self.accept_ema = cfg.target_accept     # neutral start: no transient

    @property
    def k(self) -> int:
        return int(round(self.k_f))

    def update(self, accept_rate: float) -> int:
        c = self.cfg
        self.accept_ema = c.ema * self.accept_ema + (1.0 - c.ema) * accept_rate
        self.k_f = float(np.clip(self.k_f + c.gain * (self.accept_ema - c.target_accept),
                                 self.k_min, self.k_max))
        return self.k


# -------------------------------------------------------------------- engine ---


class SpeculativeEngine(PagedServingEngine):
    """Paged engine with elastic self-speculation: the bank's
    ``spec_draft_tier`` proposes k tokens per slot, its ``spec_target_tier``
    verifies them in one k-wide paged forward. Greedy streams equal the
    non-speculative paged engine's at the target tier; sampled streams keep
    the target's distribution through :func:`rejection_sample`."""

    _speculative = True

    def __init__(self, model, ecfg: EngineConfig | None = None):
        ecfg = ecfg if ecfg is not None else EngineConfig()
        if not isinstance(ecfg, EngineConfig):
            raise TypeError("SpeculativeEngine(bank, ecfg): ecfg must be an EngineConfig, got "
                            f"{type(ecfg).__name__}")
        if ecfg.spec_k < 1:
            raise ValueError(f"SpeculativeEngine needs spec_k >= 1, got {ecfg.spec_k}")
        if ecfg.tier_policy == "pressure":
            # every slot is pinned to the target tier, so the controller's
            # downshift would be a silent no-op
            raise EngineCapabilityError(
                "SpeculativeEngine serves every slot at its target tier; the page-pressure "
                "tier controller (tier_policy='pressure') needs PagedServingEngine. Engine "
                f"capabilities: {json.dumps(self.capabilities(), sort_keys=True)}")
        greedy = ecfg.greedy or ecfg.temperature <= 0
        if ecfg.spec_draft_mode == "auto":
            # a k=1 parallel window carries no verifiable guess
            self._parallel = greedy and ecfg.spec_k >= 2
        else:
            self._parallel = ecfg.spec_draft_mode == "parallel"
        if self._parallel and not greedy:
            raise ValueError("the parallel draft schedule verifies greedy guess chains; "
                             "temperature sampling needs spec_draft_mode='sequential' (exact "
                             "rejection sampling over autoregressive proposals)")
        if self._parallel and ecfg.spec_k < 2:
            raise ValueError("the parallel draft schedule needs spec_k >= 2 (a k=1 window has "
                             "no verifiable guess); use spec_draft_mode='sequential'")
        super().__init__(model, ecfg)
        try:
            self._target_tier = self.bank.resolve(ecfg.spec_target_tier)
            self._draft_tier = self.bank.resolve(ecfg.spec_draft_tier)
        except ValueError as e:
            raise ValueError(f"spec tier: {e}") from None
        # every slot serves at the target tier; the draft tier only drafts
        self._default_tier = self._target_tier
        self.params = self._tier_params[self._target_tier]
        self.draft_params = self._tier_params[self._draft_tier]

        ddtype, quantized = page_pools(self.cfg, ecfg.spec_draft_kv_dtype,
                                       "spec_draft_kv_dtype")
        dcache = model_lib.init_paged_cache(self.cfg, ecfg.max_slots, self.num_blocks,
                                            self._bs, self._nb_slot, dtype=ddtype,
                                            device=self.device, quantized=quantized)
        # the draft's pools; its block table and lengths are the target's
        self._dpools = (dcache.k, dcache.v, dcache.k_scale, dcache.v_scale)

        self._k = ecfg.spec_k
        self._write_window = self._k          # _pre_decode covers k positions
        self.controller = SpecController(
            k_init=ecfg.spec_k, k_max=ecfg.spec_k,
            k_min=2 if self._parallel and ecfg.spec_k >= 2 else 1,
        ) if ecfg.spec_adaptive else None
        self.spec_ticks = 0
        self._accept_ema = np.full((ecfg.max_slots,), np.nan)
        # parallel schedule: each slot's guess window for the next tick (zeros:
        # no guess)
        self._guess = np.zeros((ecfg.max_slots, max(ecfg.spec_k - 1, 0)), np.int32)

    @classmethod
    def capabilities(cls) -> dict:
        caps = PagedServingEngine.capabilities.__func__(cls)
        caps["kv"] = "paged + draft pools"
        caps["features"].update(
            speculative=True,
            # the bank's tiers serve as the fixed target/draft pair; per-request
            # tiers and the pressure controller do not
            elastic_tiers=False,
            tier_pressure_controller=False,
            multi_tenant_adapters=False,
        )
        return caps

    def _resolve_tier(self, tier: int | None) -> int:
        """Every slot serves at the target tier; a request pinned elsewhere
        would silently verify at the wrong capacity, so it is refused."""
        if tier is None:
            return self._target_tier
        try:
            t = self.bank.resolve(tier)
        except ValueError as e:
            raise RequestRejected(str(e)) from None
        if t == self._target_tier:
            return t
        raise EngineCapabilityError(
            f"SpeculativeEngine serves every slot at its target tier {self._target_tier} "
            f"(spec_target_tier); per-request tiers need PagedServingEngine. Requested "
            f"tier: {tier}")

    def _effective_tier(self, req: Request) -> int:
        return self._target_tier

    @property
    def drafted_tokens(self) -> int:
        """Draft proposals offered to the verifier, lifetime."""
        return int(self.metrics.counter_value(self.metrics.spec_tokens, "drafted"))

    @property
    def accepted_tokens(self) -> int:
        """Draft proposals the verifier accepted, lifetime."""
        return int(self.metrics.counter_value(self.metrics.spec_tokens, "accepted"))

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verifier accepted, lifetime."""
        return self.accepted_tokens / max(self.drafted_tokens, 1)

    @property
    def slot_acceptance(self) -> np.ndarray:
        """Per-slot EMA acceptance rate (nan = the slot never speculated)."""
        return self._accept_ema.copy()

    # ----------------------------------------------------- device programs ---

    def _draft_cache(self, length: torch.Tensor) -> transformer_lib.PagedKVCache:
        """The draft's cache view: its own pools over the target's block
        table, at ``length`` (a tensor the target never advances)."""
        k, v, k_s, v_s = self._dpools
        return transformer_lib.PagedKVCache(k, v, self.cache.block_table, length, k_s, v_s)

    def _prefill_call(self, key, tokens, lengths, slot_ids, page_map, rows) -> np.ndarray:
        """Admission prefill of both caches: the target's one-shot prefill
        (the first token, sampled as the base engine samples it), then the
        draft's forward scattering the same prompt pages into its pools."""
        first = super()._prefill_call(key, tokens, lengths, slot_ids, page_map, rows)
        _, dkvs = model_lib._forward(self.draft_params, {"tokens": self._to_dev(tokens)},
                                     self.cfg, collect_kv=True)
        transformer_lib.scatter_prefill_pages(self._draft_cache(self.cache.length), dkvs,
                                              self._to_dev(page_map))
        return first

    def _chunk_call(self, key, tokens, counts, starts) -> np.ndarray:
        """A chunk of both caches: the target's (the base engine's body),
        then the draft's at the same pre-chunk lengths through the shared
        block table, so the caches stay position-aligned chunk by chunk."""
        tok, n0 = self._chunk_target(self.params, tokens, counts, starts)
        model_lib.chunk_prefill_step(self.draft_params, self._to_dev(tokens),
                                     self._to_dev(counts), self._draft_cache(n0), self.cfg)
        return tok.cpu().numpy()

    def _apply_cow(self, src, dst):
        super()._apply_cow(src, dst)
        transformer_lib.copy_cache_pages(self._draft_cache(self.cache.length), src, dst)

    def _release(self, slot: int):
        super()._release(slot)
        self._guess[slot, :] = 0         # fresh or resumed slots restart guessing
        self._accept_ema[slot] = np.nan  # ... and their rate estimate

    def _spec_parallel(self, window, active):
        """One parallel-schedule tick: a k-wide target verify of the guess
        window and a k-wide draft forward giving the next guesses. Greedy
        only. Returns (target chain (S, k), draft chain (S, k), emitted (S,),
        confirmed (S,))."""
        k = window.shape[1]
        cache = self._device_cache()
        n0 = cache.length
        dcache = self._draft_cache(n0)
        # position i's greedy token t_i is the target's prediction for n+i+1
        logits, cache = model_lib.decode_step(self.params, window, cache, self.cfg)
        t_chain = logits.argmax(-1).to(window.dtype)                     # (S, k)
        if k > 1:
            conf = (window[:, 1:] == t_chain[:, :-1]).long()
            a = torch.cumprod(conf, dim=1).sum(dim=1)
        else:
            a = torch.zeros(window.shape[0], dtype=torch.long, device=window.device)
        m = torch.where(active, a + 1, torch.zeros_like(a))
        # the draft sees the refined window [t_last, t_0..t_{k-2}]: real for
        # every confirmed position, so its d_m is conditioned on the accepted
        # prefix and the target's own t_a
        d_window = torch.cat([window[:, :1], t_chain[:, :-1]], dim=1)
        dlogits, _ = model_lib.decode_step(self.draft_params, d_window, dcache, self.cfg)
        self.cache = cache._replace(length=(n0 + m).to(n0.dtype))   # rollback = length reset
        return t_chain, dlogits.argmax(-1), m, a

    def _spec_seq(self, tokens, active, k: int):
        """One sequential-schedule tick: k draft decode steps, one k-wide
        verify, acceptance (greedy prefix or rejection sampling), rollback.
        Returns (out (S, k), emitted (S,), accepted (S,))."""
        greedy = self.ecfg.greedy or self.ecfg.temperature <= 0
        cache = self._device_cache()
        n0 = cache.length
        dcache = self._draft_cache(n0)
        tok, drafts, dprobs = tokens, [], []
        for i in range(k):
            logits, dcache = model_lib.decode_step(self.draft_params, tok, dcache, self.cfg)
            lg = logits[:, -1]
            nxt = self._sample(lg, salt=2 + i)
            if not greedy:
                dprobs.append(torch.softmax(lg.float() / self.ecfg.temperature, dim=-1))
            drafts.append(nxt)
            tok = nxt[:, None].to(tokens.dtype)
        drafts = torch.stack(drafts, dim=1)                             # (S, k)
        vtoks = torch.cat([tokens, drafts[:, : k - 1].to(tokens.dtype)], dim=1)
        logits, cache = model_lib.decode_step(self.params, vtoks, cache, self.cfg)
        if greedy:
            out = logits.argmax(-1)
            a = torch.cumprod((drafts == out).long(), dim=1).sum(dim=1)
        else:
            qprobs = torch.softmax(logits.float() / self.ecfg.temperature, dim=-1)
            out, a = rejection_sample((self.ecfg.seed, self._steps, 2 + k), drafts,
                                      torch.stack(dprobs, dim=1), qprobs)
        # a < k: a drafts + 1 corrective token; a == k: all k drafts (the k-th
        # draft's KV is nowhere yet: it becomes the next tick's t_last)
        m = torch.where(a < k, a + 1, torch.full_like(a, k))
        m = torch.where(active, m, torch.zeros_like(m))
        self.cache = cache._replace(length=(n0 + m).to(n0.dtype))   # rollback = length reset
        return out, m, a

    # ------------------------------------------------------------- steps ---

    def _decode_tick(self, active: np.ndarray, free: list[int], done: list[Request]):
        """One speculative tick: draft and k-wide verify over all slots, up
        to k tokens per slot for one host sync."""
        s = self.ecfg.max_slots
        k = self._k
        tokens = np.zeros((s, k if self._parallel else 1), np.int32)
        for slot in self._active:
            if slot in self._progress:   # mid-prefill slots do not decode
                continue
            tokens[slot, 0] = self._last_token[slot]
            if self._parallel:
                tokens[slot, 1:] = self._guess[slot, : k - 1]
        active_d = self._to_dev(active)
        with self.metrics.measure_program(f"spec_decode[k={k}]", self._target_tier,
                                          traces=ops.plan_builds):
            if self._parallel:
                out, guesses, emitted, accepted = self._spec_parallel(self._to_dev(tokens),
                                                                      active_d)
                guess_np = guesses.cpu().numpy()
                drafted = max(k - 1, 1)      # k - 1 verifiable guesses per window
            else:
                out, emitted, accepted = self._spec_seq(self._to_dev(tokens), active_d, k)
                guess_np = None
                drafted = k
            self.decode_calls += 1
            out_np = out.cpu().numpy()
            emitted_np = emitted.cpu().numpy()
            accepted_np = accepted.cpu().numpy()

        ema_sum, n_active = 0.0, 0
        tick_drafted = tick_accepted = 0
        tr = self.tracer
        for slot, req in list(self._active.items()):
            if slot in self._progress:   # drafted nothing this tick
                continue
            n_active += 1
            m = int(emitted_np[slot])
            rate = float(accepted_np[slot]) / drafted
            prev = self._accept_ema[slot]
            self._accept_ema[slot] = rate if np.isnan(prev) \
                else _SLOT_EMA * prev + (1.0 - _SLOT_EMA) * rate
            ema_sum += self._accept_ema[slot]
            tick_drafted += drafted
            tick_accepted += int(accepted_np[slot])
            if tr is not None:
                tr.instant(slot, "spec_accept", uid=req.uid, drafted=drafted,
                           accepted=int(accepted_np[slot]), emitted=m)
            if guess_np is not None:
                # d_chain[i] predicts position n+i+1; the next window starts
                # at n+m, so its guesses are d_chain[m:], zeros past the end
                tail = guess_np[slot, m: m + k - 1]
                self._guess[slot, : len(tail)] = tail
                self._guess[slot, len(tail):] = 0
            for j in range(m):
                if req.done:
                    break                # max_new or eos mid-burst
                self._record(slot, req, int(out_np[slot, j]), free, done)
        self.spec_ticks += 1
        if n_active:
            self.metrics.on_spec_tick(tick_drafted, tick_accepted, ema_sum / n_active, self._k)
        if self.controller is not None and n_active:
            # the window integrates the per-slot acceptance EMAs' mean
            self._k = self.controller.update(ema_sum / n_active)
            self._write_window = self._k
