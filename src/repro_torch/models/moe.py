"""Mixture-of-Experts FFN, single rank (port of the single-device path of
``repro/models/moe.py``).

Dispatch is scatter-based, as in the JAX package: the (token, choice) pairs
are sorted by expert (stably, so ties keep token order), each pair's
position in its expert is its rank in that sort, and pairs at or past the
capacity are dropped (the Switch/GShard convention: a dropped pair adds
nothing, its token keeps its other experts). Capacity is
``max(ceil(B * T * top_k / E * capacity_factor), top_k)`` over every row the
caller passes, padded serving slots included: those route and take capacity
in the JAX package too, so masking them here would fork the streams
wherever a tick drops a token. The expert products are batched matmuls: the
JAX package runs them as einsums outside any Pallas kernel.

The expert-parallel path (experts split over a mesh's ``model`` axis, the
partial outputs summed) waits for the port's serving mesh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["init_moe", "moe_ffn", "capacity", "DropCounter"]


class DropCounter:
    """The (token, choice) pairs the capacity dropped and the pairs routed,
    summed over the MoE layers of every call it is passed to, on the
    device with no host sync: over all rows, and over the rows the caller
    marks ``real`` (a bool tensor of the activations' (B, T) before the
    call; None marks every row real). A serving engine marks the rows it
    serves, so the padded rows of a slot-padded tick or a ragged chunk
    count apart."""

    FIELDS = ("dropped", "routed", "real_dropped", "real_routed")

    def __init__(self, device=None):
        self.totals = torch.zeros(len(self.FIELDS), dtype=torch.long, device=device)
        self.real: torch.Tensor | None = None

    def add(self, keep: torch.Tensor, tok: torch.Tensor):
        """``keep`` (pairs,) of each pair, ``tok`` the row each pair is of."""
        dropped = (~keep).sum()
        self.totals[0] += dropped
        self.totals[1] += keep.numel()
        if self.real is None:
            self.totals[2] += dropped
            self.totals[3] += keep.numel()
        else:
            real = self.real.reshape(-1)[tok]
            self.totals[2] += (~keep & real).sum()
            self.totals[3] += real.sum()

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


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, num_experts: int, top_k: int):
    """f32 router: softmax, top-k, gates renormalised to sum 1, and the
    Switch aux loss ``E * sum_e fraction_routed_e * mean_prob_e`` (first
    choice only)."""
    probs = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    me = probs.mean(0)
    fe = F.one_hot(expert_ids[:, 0], num_experts).float().mean(0)
    return gate_vals, expert_ids, num_experts * (fe * me).sum()


def _rank_moe(x_flat, gate_vals, expert_ids, experts: dict, num_experts: int, cap: int,
              drops: DropCounter | None = None):
    """Dispatch, expert products and combine for all experts on one rank,
    with no host sync: dropped pairs go to a spare buffer row ``cap`` and
    come back as zeros. Each token's k gated outputs are summed in a fixed
    order (no atomics), so the result is the same bits on every call.
    ``drops``, where given, counts the dropped pairs."""
    t, d = x_flat.shape
    k = expert_ids.shape[-1]
    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.bincount(e_sorted, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(t * k, device=x_flat.device) - starts[e_sorted]
    keep = pos_sorted < cap
    pos_sorted = torch.where(keep, pos_sorted, torch.full_like(pos_sorted, cap))
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    if drops is not None:
        drops.add(keep, tok_sorted)
    buf = torch.zeros((num_experts, cap + 1, d), dtype=x_flat.dtype, device=x_flat.device)
    buf[e_sorted, pos_sorted] = x_flat[tok_sorted]
    h = torch.bmm(buf, experts["gate"].to(buf.dtype))
    u = torch.bmm(buf, experts["up"].to(buf.dtype))
    y_buf = torch.bmm(F.silu(h) * u, experts["down"].to(buf.dtype))
    # gate products in f32, cast to the activations' dtype before the sum
    # (the JAX package's scatter-add into a buffer of that dtype)
    vals = y_buf[e_sorted, pos_sorted] * gate_vals.reshape(-1)[order][:, None]
    vals = torch.where(keep[:, None], vals, torch.zeros_like(vals)).to(y_buf.dtype)
    per_pair = torch.empty_like(vals)
    per_pair[order] = vals
    return per_pair.reshape(t, k, d).float().sum(1).to(y_buf.dtype)


def moe_ffn(params: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, num_groups: int | None = None,
            drops: DropCounter | None = None):
    """(output (B, T, d), aux loss ()). ``num_groups`` is unused (config
    compatibility, as in the JAX package); ``drops`` counts the pairs the
    capacity dropped."""
    b, t, d = x.shape
    x_flat = x.reshape(b * t, d)
    cap = capacity(b * t, num_experts, top_k, capacity_factor)
    gate_vals, expert_ids, aux = _route(x_flat, params["router"], num_experts, top_k)
    out = _rank_moe(x_flat, gate_vals, expert_ids, params["experts"], num_experts, cap, drops)
    return out.reshape(b, t, d).to(x.dtype), aux
