"""Paged KV-cache allocation: a global block pool + per-slot block tables
(port of ``repro/serve/paged.py``).

The host half — :class:`BlockPool`, :func:`chain_block_hashes`,
:func:`chain_block_keys`, :func:`max_blocks_per_slot` and
:func:`device_pool_rows` — is a copy of the JAX package's, without its
fault-injection hook (faults are not ported).  The device half,
:func:`init_paged_cache`, builds per-layer torch pools.

Each attention layer's K and V live in a pooled ``(rows, block_size,
n_kv_heads, head_dim)`` tensor shared by every slot; a slot's block table
row maps logical block ``position // block_size`` to a physical block id
(``-1`` = unallocated).  The pool is refcounted and content-addressed for
prefix caching: full blocks are published under chain hashes and reused by
later requests whose token prefix reproduces the chain.
"""
from __future__ import annotations

from collections import Counter, OrderedDict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["BlockPool", "chain_block_hashes", "chain_block_keys",
           "device_pool_rows", "init_paged_cache", "max_blocks_per_slot"]


# Device pool leaves carry ONE reserved row past the allocator's id space.
# The TPU scatter kernel parks its invisible grid steps on that trailing
# sentinel block; the CUDA scatter drops an invisible row without touching
# the pool, so it needs no parking.  The row is kept anyway so the port's
# cache shapes match the JAX package's one for one (the parity tests compare
# them like with like).  BlockPool never hands out the sentinel id.
SENTINEL_POOL_ROWS = 1


def device_pool_rows(num_blocks: int) -> int:
    """Rows of a device pool leaf for an allocator of ``num_blocks``
    physical blocks: the allocatable blocks plus the trailing sentinel
    row."""
    return num_blocks + SENTINEL_POOL_ROWS


_HASH_SEED = 0x9E3779B9


def max_blocks_per_slot(max_seq: int, block_size: int) -> int:
    """Width of a slot's block table: logical blocks covering ``max_seq``."""
    return -(-max_seq // block_size)


def chain_block_hashes(tokens, block_size: int,
                       n_blocks: Optional[int] = None,
                       dense_from: Optional[int] = None,
                       start: int = 0,
                       h0: Optional[int] = None) -> List[int]:
    """Chain hashes for full blocks ``start .. n_blocks-1`` of a sequence.

    ``h_i = hash((h_{i-1}, dense_rows_i, token_ids_in_block_i))`` — block
    ``i`` is addressed by its *whole prefix*, not just its own tokens, so
    an index hit guarantees the block's KV (which depends on every earlier
    token through attention) is reusable.

    ``dense_from`` marks the row index from which KV rows were produced by
    the DENSE program (tokens a request *emitted*, first written by the
    dense decode step and replayed dense after preemption) while rows
    before it came from the sparse prefill path.  Under a sparse prefill
    policy the same token ids yield different KV on the two paths, so the
    per-block count of dense rows is folded into the hash: a request whose
    own prompt extends into another request's emitted region hashes those
    blocks differently and correctly misses.  Pass ``None`` when every row
    takes one path (dense policy), which keeps hashes boundary-independent.

    ``start``/``h0`` resume an existing chain incrementally: ``h0`` must
    be the hash of block ``start - 1`` (``None`` = the seed, for
    ``start == 0``) — callers that hash as a sequence grows memoize their
    chain and pay only for the new blocks.

    The block length is folded into the chain seed: the same token stream
    hashed at a different ``block_size`` lands in a disjoint hash space
    (blocks of different geometry must never alias).  Hashes remain
    *probabilistic* identifiers — :meth:`BlockPool.match` additionally
    verifies stored token content (see :func:`chain_block_keys`) so a
    hash collision can never cause false sharing.
    """
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
    if n_blocks is None:
        n_blocks = len(tokens) // block_size
    assert n_blocks * block_size <= len(tokens), \
        "chain hashes cover full blocks only"
    assert (h0 is None) == (start == 0), "h0 must accompany a resume point"
    h = hash((_HASH_SEED, block_size)) if h0 is None else h0
    out: List[int] = []
    for i in range(start, n_blocks):
        lo, hi = i * block_size, (i + 1) * block_size
        dense = 0 if dense_from is None else max(0, hi - max(dense_from, lo))
        h = hash((h, dense, tokens[lo:hi].tobytes()))
        out.append(h)
    return out


def chain_block_keys(tokens, block_size: int,
                     n_blocks: Optional[int] = None,
                     dense_from: Optional[int] = None) -> List[Tuple]:
    """Verification keys ``(dense_rows, token_bytes)`` per full block.

    A chain hash is a probabilistic address; the key is the ground truth
    it stands for.  :meth:`BlockPool.register` stores the key alongside
    the hash and :meth:`BlockPool.match` compares keys block-by-block, so
    a hash collision between different contents is *detected* (counted in
    ``hash_collisions``) instead of silently sharing the wrong KV.
    Verification is inductive: block ``i`` only matches after blocks
    ``0..i-1`` matched with verified keys, so equal per-block keys along
    the chain imply the whole prefix (and its sparse/dense row split) is
    identical."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
    if n_blocks is None:
        n_blocks = len(tokens) // block_size
    out: List[Tuple] = []
    for i in range(n_blocks):
        lo, hi = i * block_size, (i + 1) * block_size
        dense = 0 if dense_from is None else max(0, hi - max(dense_from, lo))
        out.append((dense, tokens[lo:hi].tobytes()))
    return out


class BlockPool:
    """Host-side refcounted allocator over ``num_blocks`` fixed-size blocks.

    Every block is in exactly one of three states (asserted by
    :meth:`check_invariants`, exercised by ``tests/test_paged_kv.py`` and
    ``tests/test_prefix_cache.py``):

      * **free** — on the FIFO free list (a deque: reuse sweeps the whole
        pool instead of hammering one block under fragmenting traffic);
      * **allocated** — refcount ≥ 1 in ``_ref``; refcount > 1 means the
        block is a registered prefix block shared read-only by several
        live requests;
      * **cached** — refcount dropped to 0 but the block is registered in
        the prefix index; parked in an LRU and revived by
        :meth:`acquire_cached` or reclaimed (evicted) by :meth:`alloc`.

    ``alloc`` validates the ENTIRE operation before mutating anything, so a
    failed allocation leaves the pool exactly as it found it.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = True):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self._free: Deque[int] = deque(range(num_blocks))
        self._ref: Dict[int, int] = {}           # block id → refcount ≥ 1
        # zero-ref registered blocks, LRU → MRU; value = registered hash
        self._cached: "OrderedDict[int, int]" = OrderedDict()
        self._index: Dict[int, int] = {}         # chain hash → block id
        self._hash_of: Dict[int, int] = {}       # block id → chain hash
        # block id → verification key (chain_block_keys): the content the
        # hash stands for, compared on match to refuse collision aliasing
        self._key_of: Dict[int, Tuple] = {}
        self.peak_in_use = 0
        self.total_allocs = 0                    # fresh allocations only
        self.evictions = 0
        self.hash_collisions = 0                 # matches refused on key skew

    # ------------------------------------------------------------ queries
    @property
    def available(self) -> int:
        """Blocks obtainable without preempting anyone: free + evictable."""
        return len(self._free) + len(self._cached)

    @property
    def in_use(self) -> int:
        """Blocks currently referenced by at least one request."""
        return len(self._ref)

    @property
    def cached_blocks(self) -> int:
        """Zero-ref blocks retained for prefix reuse (evictable)."""
        return len(self._cached)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` KV rows."""
        return -(-n_tokens // self.block_size)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)

    def is_registered(self, block_id: int) -> bool:
        return block_id in self._hash_of

    def is_cached(self, block_id: int) -> bool:
        """Zero-ref parked in the LRU (counted in :attr:`available`) —
        reviving it consumes one unit of availability, unlike sharing an
        already-live block."""
        return block_id in self._cached

    # --------------------------------------------------------- allocation
    def alloc(self, n: int) -> List[int]:
        """Hand out ``n`` fresh exclusively-owned blocks (refcount 1).

        Draws from the free list first, then reclaims zero-ref cached
        blocks LRU-first (dropping their prefix-index entries); raises if
        even eviction cannot cover the request — callers check
        :attr:`available` and preempt first.  All validation happens
        before any state is mutated.
        """
        if n > self.available:
            raise RuntimeError(
                f"block pool exhausted: want {n}, have {self.available} "
                f"({len(self._free)} free + {len(self._cached)} cached)")
        take_free = min(n, len(self._free))
        cand = [self._free[i] for i in range(take_free)]
        evict: List[int] = []
        if take_free < n:                        # LRU → MRU iteration order
            lru = iter(self._cached)
            evict = [next(lru) for _ in range(n - take_free)]
        for i in cand + evict:
            assert i not in self._ref, f"double allocation of block {i}"
        assert len(set(cand + evict)) == n, "free list holds duplicates"
        # ---- validated: now mutate
        for _ in range(take_free):
            self._free.popleft()
        for i in evict:
            h = self._cached.pop(i)
            if self._index.get(h) == i:
                del self._index[h]
            self._hash_of.pop(i, None)
            self._key_of.pop(i, None)
            self.evictions += 1
        ids = cand + evict
        for i in ids:
            self._ref[i] = 1
        self.total_allocs += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return ids

    def acquire_cached(self, block_id: int) -> None:
        """Take a reference on a prefix-index hit: revive a zero-ref cached
        block (keeping its registration) or share a live one (refcount+1).
        The caller may only write rows BEYOND the block — registered blocks
        are full and immutable."""
        if block_id in self._cached:
            del self._cached[block_id]
            self._ref[block_id] = 1
        else:
            assert block_id in self._ref, \
                f"acquire_cached of unallocated block {block_id}"
            self._ref[block_id] += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)

    def release(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; a block reaching refcount 0 is parked
        in the prefix LRU if registered, else returned to the free list."""
        need = Counter(ids)
        for i, k in need.items():                # validate before mutating
            assert self._ref.get(i, 0) >= k, \
                f"release of unallocated block {i}"
        for i in ids:
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                h = self._hash_of.get(i)
                if h is not None and self._index.get(h) == i:
                    self._cached[i] = h          # MRU end of the LRU
                else:
                    self._hash_of.pop(i, None)
                    self._key_of.pop(i, None)
                    self._free.append(i)

    # ------------------------------------------------------- prefix index
    def register(self, block_id: int, chain_hash: int,
                 key: Optional[Tuple] = None) -> bool:
        """Publish a FULL block under its chain hash.  Returns False when
        the hash is already indexed (first copy wins — the duplicate block
        simply stays unregistered and frees normally) or when prefix
        caching is off.

        ``key`` is the block's verification key (:func:`chain_block_keys`)
        — the actual content the hash addresses.  :meth:`match` compares
        it so a hash collision between different token contents is
        refused instead of silently sharing the wrong KV.  ``None``
        registers hash-only (legacy/debug posture: collisions under
        Python's 64-bit tuple hash are ~2^-64 per pair, but a production
        index must not bet correctness on that)."""
        if not self.prefix_cache:
            return False
        assert block_id in self._ref, "register of a block nobody owns"
        if chain_hash in self._index:
            return self._index[chain_hash] == block_id
        prev = self._hash_of.get(block_id)
        assert prev is None or prev == chain_hash, \
            f"block {block_id} re-registered under a different hash"
        self._hash_of[block_id] = chain_hash
        self._index[chain_hash] = block_id
        if key is not None:
            self._key_of[block_id] = key
        return True

    def match(self, chain_hashes: Sequence[int],
              keys: Optional[Sequence[Tuple]] = None) -> List[int]:
        """Longest indexed prefix of a hash chain → block ids (not yet
        acquired; callers :meth:`acquire_cached` each hit).

        With ``keys`` (aligned with ``chain_hashes``), every hash hit is
        verified against the registered block's stored content key; a
        mismatch — a genuine hash collision — stops the match there and
        increments ``hash_collisions``.  A block registered without a key
        matches hash-only."""
        ids: List[int] = []
        for i, h in enumerate(chain_hashes):
            b = self._index.get(h)
            if b is None:
                break
            if keys is not None:
                stored = self._key_of.get(b)
                if stored is not None and stored != keys[i]:
                    self.hash_collisions += 1
                    break
            ids.append(b)
        return ids

    # --------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """free / allocated / cached partition the pool; the prefix index
        is a bijection onto registered live-or-cached blocks."""
        free, cached, ref = list(self._free), set(self._cached), \
            set(self._ref)
        assert len(free) == len(set(free)), "free list holds duplicates"
        assert not (set(free) & cached) and not (set(free) & ref) \
            and not (cached & ref), "block in two states at once"
        assert len(free) + len(cached) + len(ref) == self.num_blocks, \
            "blocks leaked or conjured"
        assert all(c >= 1 for c in self._ref.values()), "zero-ref in _ref"
        assert set(self._index.values()) == set(self._hash_of), \
            "index/registration skew"
        assert set(self._key_of) <= set(self._hash_of), \
            "verification key for an unregistered block"
        for h, b in self._index.items():
            assert self._hash_of.get(b) == h, f"hash mismatch on block {b}"
            assert b in cached or b in ref, f"indexed block {b} is free"
        for b, h in self._cached.items():
            assert self._index.get(h) == b, f"cached block {b} unreachable"


def init_paged_cache(cfg, num_slots: int, max_seq: int, block_size: int,
                     num_blocks: int, dtype: Optional[torch.dtype] = None,
                     device=None) -> Dict:
    """Slot cache with pooled attention K/V: per layer, ``k``/``v`` pools of
    ``(device_pool_rows(num_blocks), block_size, n_kv_heads, head_dim)``
    (the allocatable blocks plus the trailing sentinel row, never referenced
    by any block table), the per-slot ``pos`` vector and the ``-1``-filled
    ``(num_slots, max_blocks)`` int32 ``block_table``.  The pools are updated
    in place by the prefill and decode steps.  ``device`` defaults to the
    GPU and raises if there is none."""
    from repro_torch.models.common import dtype_of, resolve_device

    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg)
    shape = (device_pool_rows(num_blocks), block_size, cfg.n_kv_heads, cfg.head_dim)
    mb = max_blocks_per_slot(max_seq, block_size)
    return {
        "pos": torch.zeros((num_slots,), dtype=torch.int32, device=device),
        "block_table": torch.full((num_slots, mb), -1, dtype=torch.int32,
                                  device=device),
        "layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
                   for _ in range(cfg.n_layers)],
    }
