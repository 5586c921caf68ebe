"""Radix prompt cache: a host-side index over token prefixes at KV-page
granularity (a copy of ``repro/serving/prefix_cache.py``, which imports no
JAX; the port keeps its own copy rather than importing the JAX package).

The paged engine decouples logical positions from physical KV through its
block table, so two requests whose prompts share a prefix can share the
physical pages that hold it. This module is the host half of that sharing
(the device half is ``kernels/page_copy.py``, copy-on-write):

  * the index is a radix trie whose edges are ``block_size``-token tuples;
    each node owns exactly one page (one reference in the engine's
    :class:`~repro_torch.serving.engine.BlockAllocator`) holding the KV of
    that block, conditioned on the full chain of blocks above it;
  * ``match`` walks a prompt down the trie and returns the longest chain of
    cached full pages - admission attaches them read-only (``share``) and
    prefills only the unmatched suffix;
  * ``publish`` adopts a retired slot's full pages, one chain node per block.
    Blocks the index already holds keep their existing page and the caller's
    duplicate reference is dropped, so N slots retiring the same prefix
    converge on one physical copy;
  * ``reclaim`` walks the LRU tail: leaf nodes nobody else references
    (refcount 1, index-only) are released oldest first, cascading upward as
    parents become leaves. Interior nodes and attached pages are never
    touched, so reclaim never frees KV a live slot still reads.

The index carries no tier: a prefix prefilled by one bank tier serves
admissions pinned to any tier, the approximation a mid-stream tier switch
already makes.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # engine.py imports this module; annotation only, no cycle
    from .engine import BlockAllocator

__all__ = ["PrefixCache"]


class _Node:
    __slots__ = ("page", "children", "tick", "parent", "key")

    def __init__(self, page, parent, key):
        self.page = page          # pool page id (None only on the root)
        self.children: dict[tuple, _Node] = {}
        self.tick = 0             # last match/publish touch (LRU order)
        self.parent = parent
        self.key = key            # the block-token tuple edge from parent


class PrefixCache:
    """Radix index over token prefixes; one :class:`BlockAllocator` reference
    held per indexed page."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self._alloc = allocator
        self._bs = block_size
        self._root = _Node(None, None, None)
        self._tick = 0
        self._size = 0

    @property
    def pages(self) -> int:
        """Pages the index currently holds a reference to."""
        return self._size

    @property
    def reclaimable_pages(self) -> int:
        """Pages ``reclaim`` could eventually free: nodes whose whole subtree
        is index-only (refcount 1). Feeds the page-pressure signal so cached
        tail pages do not read as scarcity."""
        def walk(node) -> tuple[int, bool]:
            count, clean = 0, True
            for child in node.children.values():
                c, ok = walk(child)
                count += c
                clean = clean and ok
            ok = clean and self._alloc.refcount(node.page) == 1
            return count + (1 if ok else 0), ok

        return sum(walk(child)[0] for child in self._root.children.values())

    def match(self, tokens: list[int]) -> list[int]:
        """Longest chain of cached full pages prefixing ``tokens`` (page ids,
        root first). Touches every node on the chain for LRU."""
        self._tick += 1
        node = self._root
        out: list[int] = []
        for i in range(len(tokens) // self._bs):
            child = node.children.get(tuple(tokens[i * self._bs:(i + 1) * self._bs]))
            if child is None:
                break
            child.tick = self._tick
            out.append(child.page)
            node = child
        return out

    def publish(self, tokens: list[int], pages: list[int]):
        """Adopt ``pages`` (page i holds the KV of token block i) into the
        index. The caller transfers one allocator reference per page: new
        blocks keep it, blocks the index already holds release the duplicate
        (the index's existing page wins, so concurrent sharers converge)."""
        self._tick += 1
        node = self._root
        for i, page in enumerate(pages):
            key = tuple(tokens[i * self._bs:(i + 1) * self._bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(page, node, key)
                node.children[key] = child
                self._size += 1
            else:
                # the index already holds this block (possibly this very page,
                # when the caller had attached it): the caller's transferred
                # reference is a duplicate - drop it
                self._alloc.release([page])
            child.tick = self._tick
            node = child

    def reclaim(self, n: int) -> int:
        """Free up to ``n`` pages from the LRU tail: repeatedly release the
        least recently touched leaf whose page nobody else holds. Returns the
        pages actually freed (0 when every leaf is still attached somewhere)."""
        freed = 0
        while freed < n:
            victim = None
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif self._alloc.refcount(node.page) == 1 and (
                    victim is None or node.tick < victim.tick
                ):
                    victim = node
            if victim is None:
                return freed
            self._alloc.release([victim.page])
            del victim.parent.children[victim.key]
            self._size -= 1
            freed += 1
        return freed
