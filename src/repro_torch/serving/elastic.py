"""Elastic deployment as a serving-time dimension: one weight bank, many tiers
(port of ``repro/serving/elastic.py``).

``ModelBank``
    Holds the SLR (L + S) weights once and materializes an ordered set of
    budget tiers, each a :class:`~repro_torch.serving.deployed.DeployedModel`
    produced by HPA truncation of the same state. Tier 0 is the largest
    capacity. Leaves HPA does not touch (norms, any unselected block) are the
    same tensor objects in every tier; ``shared_base_bytes`` reports them.
    ``serving.adapters.AdapterBank`` is the one-tier subclass that serves a
    pool of adapters over one base.

``Engine`` (protocol)
    ``submit / step / run / has_work / capabilities`` - the contract the
    serving front end (``launch/serve.py``) programs against.

``TierController``
    An I-controller on the paged pool's free-page fraction: under pressure
    every slot serves a few tiers below its requested one (cheaper steps,
    sooner frees) before the engine evicts; when pressure clears the shift
    decays back to 0. The page pools and block table carry no tier, so a
    slot switches tiers mid-stream with no KV copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Protocol, runtime_checkable

import numpy as np

from ..core.hpa import hpa_keep_ratio
from ..tree import tree_leaves_with_path, tree_map
from .deployed import DeployedModel
from .slr_params import SLRLinear

__all__ = [
    "Engine",
    "ModelBank",
    "Tier",
    "TierController",
    "TierControllerConfig",
    "format_capability_table",
    "shared_base_bytes",
]


# ------------------------------------------------------------------- bank ---


@dataclass(frozen=True)
class Tier:
    """One budget tier of a :class:`ModelBank` (ordered: 0 = largest)."""

    index: int
    name: str
    keep: float | None          # HPA keep-ratio, None for wrapped weights
    model: DeployedModel
    param_bytes: int            # total served bytes of this tier's view

    @property
    def params(self) -> Any:
        return self.model.params


def shared_base_bytes(trees: list) -> int:
    """Bytes of the leaves that are the same object in every tree (deployed
    SLR weights aside): the weight memory a bank's tiers hold once. Takes the
    bank's trees or, under a serving mesh, a rank's local trees."""
    if len(trees) < 2:
        return 0

    def leaf_ids(tree) -> dict[int, Any]:
        return {id(leaf): leaf for _, leaf in tree_leaves_with_path(tree)
                if not isinstance(leaf, SLRLinear)}

    first = leaf_ids(trees[0])
    common = set(first)
    for tree in trees[1:]:
        common &= set(leaf_ids(tree))
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    for i in common:
        tree_map(add, first[i])
    return total


class ModelBank:
    """The SLR weights held once, served at an ordered set of tiers.

    ``ModelBank(cfg, models)`` wraps already-deployed models (the caller's
    order is the tier order, largest first); :meth:`build` materializes the
    spectrum from one (params, SLR state) pair. Engines take ``(bank, ecfg)``.
    """

    def __init__(self, cfg, models, keeps=None, names=None):
        if not models:
            raise ValueError("ModelBank needs at least one tier")
        keeps = list(keeps) if keeps is not None else [None] * len(models)
        names = list(names) if names is not None else [None] * len(models)
        if len(keeps) != len(models) or len(names) != len(models):
            raise ValueError(f"{len(models)} tier model(s) but {len(keeps)} keep(s) / "
                             f"{len(names)} name(s)")
        self.cfg = cfg
        self._tiers: list[Tier] = []
        for i, model in enumerate(models):
            if not isinstance(model, DeployedModel):
                model = DeployedModel(cfg, model, fmt="dense")   # a raw param tree
            name = names[i] or (f"keep={keeps[i]:g}" if keeps[i] is not None else f"tier{i}")
            self._tiers.append(Tier(index=i, name=name, keep=keeps[i], model=model,
                                    param_bytes=model.param_bytes()["total_bytes"]))

    @classmethod
    def build(cls, cfg, params: Any, state, blocks, budgets=(1.0,), *, kappa: float = 0.7,
              fmt: str = "factored", bsr_block: int = 128) -> "ModelBank":
        """One HPA truncation + deployment per budget, all views over the same
        base ``params`` (put them on their device once, before this call, so
        the untouched leaves stay shared). Budgets are sorted descending and
        must be unique and in (0, 1]."""
        budgets = [float(b) for b in budgets]
        if not budgets:
            raise ValueError("ModelBank.build needs at least one budget")
        if len(set(budgets)) != len(budgets):
            raise ValueError(f"duplicate budgets in {budgets}")
        for b in budgets:
            if not 0.0 < b <= 1.0:
                raise ValueError(f"budget {b} outside (0, 1]")
        budgets = sorted(budgets, reverse=True)
        models = []
        for keep in budgets:
            slr_c, _ = hpa_keep_ratio(state, blocks, keep, kappa)
            models.append(DeployedModel.build(cfg, params, slr_c, blocks, fmt=fmt,
                                              bsr_block=bsr_block))
        return cls(cfg, models, keeps=budgets)

    @classmethod
    def single(cls, cfg, weights) -> "ModelBank":
        """Wrap one deployed model (or a raw param tree) as a one-tier bank."""
        return cls(cfg, [weights])

    def __len__(self) -> int:
        return len(self._tiers)

    def __iter__(self) -> Iterator[Tier]:
        return iter(self._tiers)

    def resolve(self, tier: int) -> int:
        """Validated tier index (negative indices count from the cheap end)."""
        t = int(tier)
        n = len(self._tiers)
        if not -n <= t < n:
            raise ValueError(f"tier {tier} out of range for a {n}-tier bank "
                             f"({[x.name for x in self._tiers]})")
        return t % n

    def params(self, tier: int) -> Any:
        return self._tiers[self.resolve(tier)].params

    def shared_base_bytes(self) -> int:
        """Bytes of the leaves that are the same tensor object in every tier:
        the weight memory one bank amortizes across the spectrum."""
        return shared_base_bytes([t.params for t in self._tiers])

    def report(self) -> dict:
        """Per-tier served bytes + the shared base."""
        return {
            "num_tiers": len(self._tiers),
            "tiers": [{"index": t.index, "name": t.name, "keep": t.keep,
                       "fmt": t.model.fmt, "param_bytes": t.param_bytes}
                      for t in self._tiers],
            "shared_base_bytes": self.shared_base_bytes(),
        }


# --------------------------------------------------------------- protocol ---


@runtime_checkable
class Engine(Protocol):
    """The serving front-end contract: ``launch/serve.py`` programs against
    this, not a concrete engine."""

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               deadline: float | None = None, tier: int | None = None,
               submitted_at: float | None = None) -> int:
        """Enqueue a request; returns its uid. ``tier`` pins it to a bank tier
        (None = the engine's default). Raises ``RequestRejected`` when the
        request can never be served."""
        ...

    def step(self) -> list:
        """One engine tick; returns the requests that finished in it."""
        ...

    def run(self, max_steps: int = 10_000) -> list:
        """Drive everything to completion."""
        ...

    @property
    def has_work(self) -> bool: ...

    @classmethod
    def capabilities(cls) -> dict:
        """Which cache families this engine serves, its KV layout, and which
        features it has."""
        ...


def format_capability_table(engines: dict[str, type]) -> str:
    """``capabilities()`` of several engine classes as a text table."""
    caps = {name: cls.capabilities() for name, cls in engines.items()}
    features = sorted({f for c in caps.values() for f in c["features"]})
    rows = [["engine", "families", "kv"] + features]
    for name, c in caps.items():
        rows.append([name, ",".join(c["families"]), c["kv"]]
                    + [_fmt_feature(c["features"][f]) for f in features])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = ["  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
             for row in rows]
    lines.insert(1, "-" * len(lines[0]))
    return "\n".join(lines)


def _fmt_feature(v) -> str:
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v)
    return str(v)


# ------------------------------------------------------------- controller ---


@dataclass(frozen=True)
class TierControllerConfig:
    target_free_frac: float = 0.25   # free-page fraction setpoint
    gain: float = 4.0                # integral gain: tiers per unit pressure
    ema: float = 0.5                 # smoothing of the observed free fraction


class TierController:
    """I-controller over the serving-tier downshift:

        shift_f <- clip(shift_f + gain * (target_free - free_ema), 0, T-1)

    read as ``round(shift_f)``, so the engine serves at most ``num_tiers``
    distinct tiers."""

    def __init__(self, num_tiers: int, cfg: TierControllerConfig = TierControllerConfig()):
        if num_tiers < 1:
            raise ValueError(f"num_tiers must be >= 1, got {num_tiers}")
        if not 0.0 < cfg.target_free_frac < 1.0:
            raise ValueError(f"target_free_frac {cfg.target_free_frac} outside (0, 1)")
        self.cfg = cfg
        self.num_tiers = int(num_tiers)
        self.shift_f = 0.0
        self.free_ema: float | None = None

    @property
    def shift(self) -> int:
        return int(round(self.shift_f))

    def update(self, free_frac: float) -> int:
        """One integral step on the observed free-page fraction."""
        c = self.cfg
        self.free_ema = (float(free_frac) if self.free_ema is None
                         else c.ema * self.free_ema + (1.0 - c.ema) * float(free_frac))
        err = c.target_free_frac - self.free_ema
        self.shift_f = float(np.clip(self.shift_f + c.gain * err, 0.0, self.num_tiers - 1))
        return self.shift
