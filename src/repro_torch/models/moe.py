"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Dispatch is scatter-based, as in the JAX package: the (token, choice) pairs
are sorted by expert (stably, so ties keep token order), each pair's
position in its expert is its rank in that sort, and pairs at or past the
capacity are dropped (the Switch/GShard convention: a dropped pair adds
nothing, its token keeps its other experts). Capacity is
``max(ceil(rows * top_k / E * capacity_factor), top_k)``, padded serving
slots included: those route and take capacity in the JAX package too, so
masking them here would fork the streams wherever a tick drops a token. The
expert products are batched matmuls: the JAX package runs them as einsums
outside any Pallas kernel.

Under a mesh (``parallel/sharding.py::current_mesh``) two branches, as in
the JAX package:

* **expert-parallel** (``model = m > 1`` and ``E % m == 0``): model rank j
  holds experts ``[j E/m, (j+1) E/m)`` and routes every row of its data
  column with the replicated router; pairs of other ranks' experts are
  parked past its last expert, so they take no capacity and count as
  neither routed nor dropped. Each rank emits its per-pair gated values,
  exact zeros where a pair is not its own, the model row sums them in model
  order, and each token's k values are summed in the unsharded order: at
  ``data = 1`` the bits of the unsharded call on every rank. Capacity is per
  data shard (the JAX package's ``t_loc``), the aux loss the data mean of
  the shards'.
* **single-rank** (``E % m != 0``, or no model axis): every rank holds every
  expert. Where the forward spreads the batch rows over a data column, the
  JAX package's capacity, positions and aux loss are over the global batch
  (GSPMD); so the column's per-expert counts are gathered and each local
  position is offset by the counts of the lower data ranks (their rows come
  first in token order), and the aux loss is built from the column's summed
  router means and first-choice counts. The same holds in the
  expert-parallel branch where the data size does not divide the batch: the
  JAX package then keeps the batch whole on every shard.

Rows a ``RowSplit`` repeats past the batch (``live`` False) neither route
nor take capacity.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import current_mesh

__all__ = ["init_moe", "moe_ffn", "capacity", "DropCounter"]


class DropCounter:
    """The (token, choice) pairs the capacity dropped and the pairs routed,
    summed over the MoE layers of every call it is passed to, on the
    device with no host sync: over all rows, and over the rows the caller
    marks ``real`` (a bool tensor of the activations' (B, T) before the
    call; None marks every row real). A serving engine marks the rows it
    serves, so the padded rows of a slot-padded tick or a ragged chunk
    count apart. Under a mesh each rank counts the pairs of its own experts
    and of the rows it serves, so the ranks' counts sum to the unsharded
    count."""

    FIELDS = ("dropped", "routed", "real_dropped", "real_routed")

    def __init__(self, device=None):
        self.totals = torch.zeros(len(self.FIELDS), dtype=torch.long, device=device)
        self.real: torch.Tensor | None = None

    def add(self, keep: torch.Tensor, counted: torch.Tensor, real: torch.Tensor | None):
        """Per pair: ``keep`` (in capacity), ``counted`` (this rank's pair of
        a row it serves), ``real`` (of a row the caller marked real; None:
        every row)."""
        dropped = counted & ~keep
        self.totals[0] += dropped.sum()
        self.totals[1] += counted.sum()
        if real is None:
            self.totals[2] += dropped.sum()
            self.totals[3] += counted.sum()
        else:
            self.totals[2] += (dropped & real).sum()
            self.totals[3] += (counted & real).sum()

    def read(self) -> dict[str, int]:
        return dict(zip(self.FIELDS, (int(v) for v in self.totals.cpu())))


def init_moe(normal, d: int, d_ff: int, num_experts: int, dtype, device,
             lead: tuple[int, ...] = ()) -> dict:
    """Router (f32, as in the JAX package) and stacked expert weights with
    the JAX package's shapes and scales, stacked over ``lead``."""
    si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    router = normal((*lead, d, num_experts), si).to(torch.float32)
    return {
        "router": router,
        "experts": {
            "gate": normal((*lead, num_experts, d, d_ff), si),
            "up": normal((*lead, num_experts, d, d_ff), si),
            "down": normal((*lead, num_experts, d_ff, d), so),
        },
    }


def capacity(rows: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    return max(int(math.ceil(rows * top_k / num_experts * capacity_factor)), top_k)


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """f32 router: softmax probabilities, top-k, gates renormalised to sum 1."""
    probs = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return gate_vals, expert_ids, probs


def _aux(mean_prob: torch.Tensor, fraction: torch.Tensor, num_experts: int):
    """The Switch aux loss ``E * sum_e fraction_routed_e * mean_prob_e``
    (first choice only)."""
    return num_experts * (fraction * mean_prob).sum()


class _ColumnStats(torch.autograd.Function):
    """Every data rank's statistics vector, stacked in data order. Every rank
    computes the same function of the stack (the global aux loss), so the
    gradient of its own row is ``data`` times the upstream gradient there:
    averaged over the column by the train step, it is the global loss's
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather_data(x[None], dim=0)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return grad[mesh.data_index] * mesh.data_size, None


def _dispatch(expert_ids, e_offset: int, num_local: int, live_pairs):
    """The pairs sorted by local expert, pairs of other ranks' experts and of
    rows that do not route parked past the last one: (order, sorted local
    expert, position in expert, counts per local expert (num_local + 1,))."""
    flat_e = expert_ids.reshape(-1) - e_offset
    mine = (flat_e >= 0) & (flat_e < num_local)
    if live_pairs is not None:
        mine = mine & live_pairs
    parked = torch.where(mine, flat_e, torch.full_like(flat_e, num_local))
    order = torch.argsort(parked, stable=True)
    e_sorted = parked[order]
    counts = torch.bincount(e_sorted, minlength=num_local + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=flat_e.device) - starts[e_sorted]
    return order, e_sorted, pos, counts


def _experts(x_flat, gate_vals, order, e_sorted, pos, keep, experts: dict, num_local: int,
             cap: int, k: int):
    """Buffer, expert products and per-pair gated values (t, k, d), zero
    where a pair is not kept, with no host sync: pairs outside capacity or
    parked go to a spare buffer row ``cap`` and come back as zeros."""
    t, d = x_flat.shape
    pos = torch.where(keep, pos, torch.full_like(pos, cap))
    e_idx = torch.where(e_sorted < num_local, e_sorted, torch.zeros_like(e_sorted))
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    buf = torch.zeros((num_local, cap + 1, d), dtype=x_flat.dtype, device=x_flat.device)
    buf[e_idx, pos] = x_flat[tok_sorted]
    h = torch.bmm(buf, experts["gate"].to(buf.dtype))
    u = torch.bmm(buf, experts["up"].to(buf.dtype))
    y_buf = torch.bmm(F.silu(h) * u, experts["down"].to(buf.dtype))
    # gate products in f32, cast to the activations' dtype before the sum
    # (the JAX package's scatter-add into a buffer of that dtype)
    vals = y_buf[e_idx, pos] * gate_vals.reshape(-1)[order][:, None]
    vals = torch.where(keep[:, None], vals, torch.zeros_like(vals)).to(y_buf.dtype)
    per_pair = torch.empty_like(vals)
    per_pair[order] = vals
    return per_pair.reshape(t, k, d)


def moe_ffn(params: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, num_groups: int | None = None,
            drops: DropCounter | None = None, rows=None):
    """(output (B, T, d), aux loss ()). ``num_groups`` is unused (config
    compatibility, as in the JAX package); ``drops`` counts the pairs the
    capacity dropped; ``rows`` is the forward's share of the batch rows on
    a data column (``parallel.sharding.RowSplit`` or ``BatchShard``), None
    when this rank holds the whole batch."""
    b, t, d = x.shape
    k = top_k
    mesh = current_mesh()
    m = mesh.model_size if mesh is not None else 1
    ep = m > 1 and num_experts % m == 0
    num_local = num_experts // m if ep else num_experts
    e_offset = mesh.model_index * num_local if ep else 0
    experts = params["experts"]
    if experts["gate"].shape[-3] != num_local:
        raise ValueError(f"moe_ffn: {experts['gate'].shape[-3]} experts on this rank, "
                         f"expected {num_local} of {num_experts} (model axis {m})")
    spread = rows is not None and rows.spread
    col = rows.mesh if spread else None
    dp = col.data_size if spread else 1
    n = rows.n if spread else b
    per_shard = spread and ep and n % dp == 0        # JAX: capacity per data shard
    across = spread and not per_shard                # JAX: over the whole batch
    cap = capacity((n if across else b) * t, num_experts, k, capacity_factor)

    x_flat = x.reshape(b * t, d)
    gate_vals, expert_ids, probs = _route(x_flat, params["router"], k)
    live_tok = rows.live(x.device).repeat_interleave(t) if spread else None
    live_pairs = live_tok.repeat_interleave(k) if spread else None
    order, e_sorted, pos, counts = _dispatch(expert_ids, e_offset, num_local, live_pairs)

    first = F.one_hot(expert_ids[:, 0], num_experts).float()
    if across:
        w = live_tok.float()[:, None]
        local = torch.cat([(probs * w).sum(0), (first * w).sum(0),
                           counts[:num_local].float()]).double()
        stats = _ColumnStats.apply(local, col)                     # (dp, 2E + E_loc)
        lower = stats[:col.data_index, 2 * num_experts:].sum(0).long()
        pos = pos + torch.cat([lower, lower.new_zeros(1)])[e_sorted]
        total = stats.sum(0) / (n * t)
        aux = _aux(total[:num_experts], total[num_experts:2 * num_experts],
                   num_experts).float()
    else:
        aux = _aux(probs.mean(0), first.mean(0), num_experts)
        if per_shard:
            aux = col.all_gather_data(aux[None].detach()).sum() / dp
    keep = (pos < cap) & (e_sorted < num_local)

    if drops is not None:
        counted = e_sorted < num_local
        real = drops.real
        if real is not None:
            real = rows.take(real) if rows is not None else real
            real = real.reshape(-1).repeat_interleave(k)[order]
        drops.add(keep, counted, real)
    per_pair = _experts(x_flat, gate_vals, order, e_sorted, pos, keep, experts, num_local,
                        cap, k)
    if ep:
        per_pair = mesh.all_reduce_model(per_pair)
    out = per_pair.float().sum(1).to(per_pair.dtype)
    return out.reshape(b, t, d).to(x.dtype), aux
