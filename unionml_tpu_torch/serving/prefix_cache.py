"""Host radix index over token-id blocks: the paged pool's allocator and prefix cache.

The port's copy of ``unionml_tpu/serving/prefix_cache.py:46-400`` (standard
library only), with its telemetry hooks (lookups, hits, hit tokens).

A node caches exactly ``block_size`` tokens' KV in one pool block; matching
walks whole blocks, so a prompt sharing 10 tokens of a cached prefix at
``block_size=4`` reuses 8 and prefills the rest. Every matched or inserted
path is reference-held until the using slot retires; referenced nodes are
never evicted. Allocation prefers the free list, then evicts the
least-recently-used unreferenced *leaf* (an interior evict would orphan the
descendants whose match path runs through it).

The index is also the paged engine's allocator: live slots draw their blocks
through :meth:`PrefixCache.alloc_blocks` / :meth:`PrefixCache.free_blocks`,
and a retiring slot's full blocks are indexed without a copy by
:meth:`PrefixCache.adopt` (ownership moves from the slot to a tree node). Every
pool block is therefore owned by exactly one of the free list, a tree node or
a live slot (``slot_blocks`` counts the last), so "no block leaked or freed
twice" is a counter check at teardown.
"""

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PrefixCache", "block_key", "prefix_digests"]

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_FNV_MASK = 0xFFFFFFFFFFFFFFFF


def block_key(tokens: Sequence[int], block_index: int, block_size: int) -> Tuple[int, ...]:
    """The radix key of block ``block_index`` of ``tokens``: the tuple of that
    block's token ids (the tree's node keys and :func:`prefix_digests` both
    derive from it)."""
    start = block_index * block_size
    return tuple(int(t) for t in tokens[start : start + block_size])


def prefix_digests(tokens: Sequence[int], block_size: int, max_blocks: Optional[int] = None) -> List[int]:
    """Chained 64-bit FNV-1a digests of ``tokens``' block-aligned prefixes:
    ``digests[i]`` summarizes blocks ``0..i`` and folds in its predecessor, so
    equal digests mean equal whole prefixes. Deterministic across processes;
    a prompt shorter than one block has none."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    total = len(tokens) // block_size
    if max_blocks is not None:
        total = min(total, max_blocks)
    digests: List[int] = []
    acc = _FNV_OFFSET
    for index in range(total):
        for tok in block_key(tokens, index, block_size):
            val = int(tok) & _FNV_MASK
            for _ in range(8):  # byte-wise, so nearby ids diverge fully
                acc = ((acc ^ (val & 0xFF)) * _FNV_PRIME) & _FNV_MASK
                val >>= 8
        digests.append(acc)
    return digests


class _Node:
    """One cached block: ``key`` (the block's token ids) under ``parent``."""

    __slots__ = ("key", "block_id", "parent", "children", "refcount", "last_used")

    def __init__(self, key: Tuple[int, ...], block_id: int, parent: Optional["_Node"]) -> None:
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.refcount = 0
        self.last_used = 0


class PrefixCache:
    """Block-granular radix index mapping token-id prefixes to pool block ids.

    :param num_blocks: pool blocks this index manages (the scratch block excluded).
    :param block_size: tokens per block (the match and insert granularity).

    :meth:`match` walks the longest cached chain of full blocks and acquires a
    reference on every matched node; :meth:`extend` / :meth:`adopt` index a
    prompt's further full blocks; :meth:`release` drops a path's references
    when its slot retires; :meth:`pin` holds a preempted request's path across
    its wait in the queue. :meth:`stats` counts hits, insertions and evictions.
    """

    def __init__(self, num_blocks: int, block_size: int, *, telemetry=None) -> None:
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        #: optional Telemetry mirror for the hit-rate counters (``is not None`` guarded)
        self.telemetry = telemetry
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._root = _Node((), -1, None)
        # pop() takes from the tail: ids come out ascending
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._tick = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self.pinned_blocks = 0
        #: blocks owned by live slots (acquired by alloc_blocks, returned by
        #: free_blocks or adopt); zero again at teardown
        self.slot_blocks = 0
        self.adopted_blocks = 0

    @property
    def cached_blocks(self) -> int:
        """Blocks holding indexed KV (neither free nor a live slot's)."""
        return self.num_blocks - len(self._free) - self.slot_blocks

    def _key_at(self, tokens: Sequence[int], block_index: int) -> Tuple[int, ...]:
        return block_key(tokens, block_index, self.block_size)

    def match(self, tokens: Sequence[int], max_blocks: int) -> List[_Node]:
        """Longest cached chain of full blocks covering ``tokens``, up to
        ``max_blocks``. Bumps recency and acquires a reference on every
        matched node: the caller must :meth:`release` the path."""
        self._tick += 1
        self.lookups += 1
        if self.telemetry is not None:
            self.telemetry.prefix_lookups_total.inc()
        node, path = self._root, []
        while len(path) < max_blocks:
            child = node.children.get(self._key_at(tokens, len(path)))
            if child is None:
                break
            child.last_used = self._tick
            child.refcount += 1
            path.append(child)
            node = child
        return path

    def probe(self, tokens: Sequence[int], max_blocks: int) -> int:
        """Blocks :meth:`match` would return, without references, recency or
        counters."""
        node, depth = self._root, 0
        while depth < max_blocks:
            child = node.children.get(self._key_at(tokens, depth))
            if child is None:
                break
            depth += 1
            node = child
        return depth

    def record_hit(self, matched_tokens: int) -> None:
        """Count one served hit of ``matched_tokens`` reused tokens (the final
        match, after any shrink)."""
        if matched_tokens > 0:
            self.hits += 1
            self.hit_tokens += int(matched_tokens)
            if self.telemetry is not None:
                self.telemetry.prefix_hits_total.inc()
                self.telemetry.prefix_hit_tokens_total.inc(float(matched_tokens))

    def extend(self, path: List[_Node], tokens: Sequence[int], max_blocks: int) -> Tuple[List[_Node], List[_Node]]:
        """Index ``tokens``' full blocks beyond ``path``, up to ``max_blocks``,
        allocating a block for each missing node (evicting LRU leaves when
        the free list is empty); stops early when every block is referenced.
        Returns ``(full_path, new_nodes)``; ``new_nodes`` is the tail of
        ``full_path``, whose every node holds a reference to release."""
        self._tick += 1
        node = path[-1] if path else self._root
        full, new = list(path), []
        while len(full) < max_blocks:
            key = self._key_at(tokens, len(full))
            child = node.children.get(key)
            if child is None:
                block_id = self._alloc()
                if block_id is None:  # every block referenced: nothing to evict
                    break
                child = _Node(key, block_id, node)
                node.children[key] = child
                new.append(child)
                self.inserted_blocks += 1
            child.last_used = self._tick
            child.refcount += 1
            full.append(child)
            node = child
        return full, new

    def alloc_blocks(self, n: int) -> Optional[List[int]]:
        """Acquire ``n`` blocks for a live slot, evicting LRU unreferenced
        leaves as needed. All or nothing: ``None`` (nothing held) when fewer
        than ``n`` can be freed."""
        ids: List[int] = []
        for _ in range(n):
            block_id = self._alloc()
            if block_id is None:
                self._free.extend(reversed(ids))  # roll back, keeping the order
                return None
            ids.append(block_id)
        self.slot_blocks += n
        return ids

    def free_blocks(self, ids: Sequence[int]) -> None:
        """Return slot-owned blocks (those :meth:`adopt` did not take) to the
        free list."""
        self._free.extend(int(b) for b in ids)
        self.slot_blocks -= len(ids)
        assert self.slot_blocks >= 0, "freed more slot blocks than were allocated"

    def available_blocks(self) -> int:
        """Blocks :meth:`alloc_blocks` could acquire now: the free list plus
        every transitively unreferenced chain (leaves-only eviction frees a
        node once its descendants are gone; a referenced parent does not
        shield evictable chains below it)."""
        def reclaim(node: _Node) -> Tuple[int, bool]:
            count, fully = 0, True
            for child in node.children.values():
                sub, sub_fully = reclaim(child)
                count += sub
                fully = fully and sub_fully
            if fully and node.refcount <= 0:
                return count + 1, True
            return count, False

        return len(self._free) + sum(reclaim(child)[0] for child in self._root.children.values())

    def adopt(self, path: List[_Node], tokens: Sequence[int], max_blocks: int,
              block_map: Dict[int, int]) -> Tuple[List[_Node], int]:
        """Copy-free :meth:`extend`: a missing node takes the slot's own block
        for its index (popped from ``block_map``, block index -> block id);
        where a sibling indexed the block first, the existing node is acquired
        and the slot keeps its duplicate. Returns ``(full_path, adopted)``."""
        self._tick += 1
        node = path[-1] if path else self._root
        full = list(path)
        adopted = 0
        while len(full) < max_blocks:
            key = self._key_at(tokens, len(full))
            child = node.children.get(key)
            if child is None:
                block_id = block_map.pop(len(full), None)
                if block_id is None:  # the caller holds no block for this index
                    break
                child = _Node(key, block_id, node)
                node.children[key] = child
                adopted += 1
                self.inserted_blocks += 1
                self.adopted_blocks += 1
                self.slot_blocks -= 1  # ownership: slot -> tree
            child.last_used = self._tick
            child.refcount += 1
            full.append(child)
            node = child
        return full, adopted

    def release(self, path: Sequence[_Node]) -> None:
        """Drop one reference from every node of ``path``."""
        for node in path:
            node.refcount -= 1

    def pin(self, path: Sequence[_Node]) -> None:
        """Hold an eviction-proof reference on ``path`` across a preempted
        request's wait in the queue (``pinned_blocks`` returns to zero once
        every pin is dropped)."""
        for node in path:
            node.refcount += 1
        self.pinned_blocks += len(path)

    def unpin(self, path: Sequence[_Node]) -> None:
        """Drop a :meth:`pin`'s references."""
        for node in path:
            node.refcount -= 1
        # clear() may have reset the counter while paths were pinned
        self.pinned_blocks = max(0, self.pinned_blocks - len(path))

    def clear(self) -> None:
        """Forget every cached block and every slot's ownership (the engine's
        pool was reallocated)."""
        self._root = _Node((), -1, None)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self.pinned_blocks = 0
        self.slot_blocks = 0

    def _alloc(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        victim = self._lru_leaf()
        if victim is None:
            return None
        self._evict(victim)
        return self._free.pop()

    def _lru_leaf(self) -> Optional[_Node]:
        best: Optional[_Node] = None
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif node.refcount <= 0 and (best is None or node.last_used < best.last_used):
                best = node
        return best

    def _evict(self, node: _Node) -> None:
        assert node.parent is not None and not node.children
        del node.parent.children[node.key]
        self._free.append(node.block_id)
        self.evicted_blocks += 1

    def stats(self) -> Dict[str, int]:
        """Counters: hits, insertions, evictions, pins and pool occupancy."""
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "cached_blocks": self.cached_blocks,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "pinned_blocks": self.pinned_blocks,
            "slot_blocks": self.slot_blocks,
            "free_blocks": len(self._free),
            "adopted_blocks": self.adopted_blocks,
        }
