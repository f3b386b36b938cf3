"""Pure-host scheduling layer of the serving engine (port of
``repro/serve/scheduler.py``).

A copy of the JAX package's :class:`Scheduler`, numpy only, for the paged
cache and, with
``paged=False``, the dense per-slot slab (no block pool, no block-budget
admission, no preemption, no prefix cache): the same stream makes the
same decisions, faults
included (the ``admit`` site, retries with backoff, the ``pool.alloc``
recovery paths), exact dyadic chunks included (``exact_chunks``: models
with recurrent layers, whose scans cannot mask a padded tail, prefill in
power-of-two chunks of at most ``chunk_size`` that sum to the prompt, and
keep the prefix cache off), modality extras included (a request marked
with :meth:`Scheduler.mark_extras` carries frame or patch embeddings that
its KV depends on beyond its tokens, so it neither matches nor registers
prefix blocks; a chunk's ``first`` flag says that the engine sends the
extras with it, also on a preempted request's replay).  The
:class:`Scheduler` owns every piece of
host state — the :class:`Request` lifecycle machine, slot assignment, the paged
:class:`~repro_torch.serve.paged.BlockPool`, the prefix index bookkeeping,
the watchdog, and the scheduling counters — and never touches device
tensors.  Each iteration it emits a :class:`StepPlan` (or, for the legacy
two-program split, a prefill plan and a decode plan): a plain-numpy
description of the device work; the executor runs it and the ``commit_*``
methods fold the sampled tokens back into request state.
:meth:`Scheduler.host_snapshot` / :meth:`Scheduler.host_restore` are its
share of the engine's crash recovery.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.paged import (BlockPool, chain_block_hashes,
                               chain_block_keys, max_blocks_per_slot)

__all__ = ["Scheduler", "Request", "StepPlan", "PrefillWork", "DecodeWork",
           "WAITING", "PREFILL", "DECODE", "DONE", "REJECTED", "TIMED_OUT",
           "CANCELLED", "TERMINAL"]

WAITING, PREFILL, DECODE, DONE = "waiting", "prefill", "decode", "done"
# terminal without ever running: admission proved the request can NEVER
# fit the block pool (its replay sequence outgrew capacity), its transient-
# failure retry budget ran out, or the no-progress watchdog evicted it —
# rejecting keeps strict-FCFS admission from waiting on it forever and
# starving the queue behind it
REJECTED = "rejected"
# deadline (submit ttl / cfg.ttl_default) passed before completion
TIMED_OUT = "timed_out"
# cancel(rid): caller withdrew the request; unwound from any phase
CANCELLED = "cancelled"
TERMINAL = (DONE, REJECTED, TIMED_OUT, CANCELLED)


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray                 # (T,) prompt token ids
    max_new_tokens: int
    arrival: int = 0                   # scheduler iteration of arrival
    # --- runtime (scheduler-owned) ---
    state: str = WAITING
    slot: int = -1
    filled: int = 0                    # seq tokens prefilled so far
    cur: int = 0                       # last generated token (decode input)
    out: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    kv_len: int = 0                    # KV rows held (host mirror of pos)
    shared: int = 0                    # leading blocks reused from the index
    registered: int = 0                # leading blocks published to the index
    cached_tokens: int = 0             # prefill rows skipped via prefix hits
    # memoized chain hashes of this request's full blocks; token content
    # never changes for an already-hashed block (out only appends), so the
    # chain survives preemption and extends in O(new blocks)
    hash_chain: List[int] = dataclasses.field(default_factory=list)
    preempted: int = 0                 # times requeued by the block pool
    admitted_iter: int = -1
    first_token_iter: int = -1
    done_iter: int = -1
    arrival_time: float = -1.0         # wall clock when arrival was reached
    done_time: float = 0.0             # wall-clock latency from arrival
    # --- lifecycle ---
    deadline: Optional[int] = None     # absolute iteration bound (TIMED_OUT)
    cancel_requested: bool = False     # processed at the next iteration start
    retries: int = 0                   # transient admission failures absorbed
    next_retry_iter: int = 0           # backoff window after a transient fail


def _dyadic_sizes(length: int, cap: int) -> List[int]:
    """Non-increasing powers of two ≤ cap summing exactly to length
    (``[]`` for ``length <= 0``: a cancel or timeout can land between
    scheduling and prefill, and the ladder must then be empty, not spin)."""
    if length <= 0:
        return []
    sizes = []
    c = 1
    while c * 2 <= cap:
        c *= 2
    rem = length
    while rem:
        while c > rem:
            c //= 2
        sizes.append(c)
        rem -= c
    return sizes


# --------------------------------------------------------------- the plan
# The Scheduler→Executor contract: a plan is plain host data (numpy + ints
# + Request references for commit bookkeeping).  The Executor reads ONLY
# the array-ish fields (slot/tokens/chunk_len/toks/active/resets/table);
# the Request references exist so the driver can hand sampled tokens back
# to ``Scheduler.commit_*`` without re-deriving rosters.

@dataclasses.dataclass
class PrefillWork:
    req: Request
    tokens: np.ndarray         # (1, C) chunk token ids
    chunk_len: int
    replay: bool               # re-ingesting emitted tokens → dense program
    first: bool = False        # the request's first chunk: its extras attach here


@dataclasses.dataclass
class DecodeWork:
    requests: List[Request]    # frozen roster, one per active slot
    toks: np.ndarray           # (num_slots,) int32 last sampled tokens
    active: np.ndarray         # (num_slots,) bool


@dataclasses.dataclass
class StepPlan:
    """Device work for one scheduler iteration.  ``resets`` and ``table``
    are idempotent cache-side effects the Executor applies BEFORE the
    step dispatch (slot handoffs and block-table rewrites, both decided
    host-side); ``prefill``/``decode`` describe the fused step program's
    operands.  An all-``None`` plan is an idle iteration."""
    prefill: Optional[PrefillWork] = None
    decode: Optional[DecodeWork] = None
    resets: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    table: Optional[np.ndarray] = None   # host block table when dirty

    @property
    def bucket(self) -> Tuple[bool, bool, bool]:
        """(replay, has_prefill, has_decode) — the step-program shape
        bucket (static phase presence, see executor.py)."""
        return (self.prefill is not None and self.prefill.replay,
                self.prefill is not None, self.decode is not None)

    @property
    def has_work(self) -> bool:
        return self.prefill is not None or self.decode is not None


class Scheduler:
    """Admission, prefix match, preemption, TTL/cancel/watchdog — the
    pure-Python half of the serving engine.  Owns all :class:`Request`
    state and the block pool; emits :class:`StepPlan`s and commits their
    results.  Never touches device tensors or sampling generators."""

    def __init__(self, cfg, *, policy_enabled: bool, prefix_cache: bool,
                 paged: bool = True, exact_chunks: bool = False, faults=None):
        self.cfg = cfg
        self.faults = faults
        self._policy_enabled = policy_enabled
        self._exact_chunks = exact_chunks
        self.paged = paged
        # block reuse needs every piece of a request's state in the pool:
        # recurrent scan state is not, so exact-chunk archs keep it off
        self.prefix_cache = paged and prefix_cache and not exact_chunks
        self.preemptions = 0
        self.rejections = 0
        self.admission_retries = 0   # transient admission failures absorbed
        self.preempt_log: List[tuple] = []   # (rid, state-when-preempted)
        self.watchdog_trips = 0      # forced evictions by the watchdog
        self.timeouts = 0
        self.cancellations = 0
        self.prefix_hits = 0         # admissions that reused ≥ 1 block
        self.blocks_reused = 0       # total shared-block acquisitions
        self.tokens_skipped = 0      # prefill rows served from the index
        self.prefill_demand = 0      # prefill rows requested at admission
        self.pool: Optional[BlockPool] = None
        self._table_dirty = False
        if paged:
            self._max_blocks = max_blocks_per_slot(cfg.max_seq, cfg.block_size)
            nb = (cfg.num_blocks if cfg.num_blocks is not None
                  else cfg.num_slots * self._max_blocks)
            self.pool = BlockPool(nb, cfg.block_size, prefix_cache=self.prefix_cache)
            self._host_table = np.full((cfg.num_slots, self._max_blocks), -1, np.int32)
            self._table_dirty = True
        self.requests: List[Request] = []
        self._free_slots = list(range(cfg.num_slots))
        self._slot_req: List[Optional[Request]] = [None] * cfg.num_slots
        self._pending_resets: List[Tuple[int, int]] = []
        # requests with modality extras: their KV depends on more than their
        # tokens, so they never match or register prefix blocks
        self._extra_rids: set = set()
        self.it = 0                       # scheduler-iteration clock
        self._last_progress = 0           # watchdog bookkeeping

    # ------------------------------------------------------------ admission
    def submit(self, tokens, max_new_tokens: int = 32, arrival: int = 0,
               ttl: Optional[int] = None) -> int:
        """Queue a request visible from scheduler iteration ``arrival``;
        ``ttl`` bounds its lifetime in iterations.  Returns its id."""
        tokens = np.asarray(tokens).reshape(-1).astype(np.int32)
        if tokens.size == 0:
            raise ValueError("empty prompt")
        if tokens.size + max_new_tokens > self.cfg.max_seq:
            raise ValueError("request exceeds slot capacity (max_seq)")
        if (self.paged and self.pool.blocks_for(tokens.size + max_new_tokens)
                > self.pool.num_blocks):
            raise ValueError("request exceeds block pool capacity")
        rid = len(self.requests)
        if ttl is None:
            ttl = self.cfg.ttl_default
        self.requests.append(Request(
            rid=rid, tokens=tokens, max_new_tokens=max_new_tokens,
            arrival=arrival,
            deadline=None if ttl is None else arrival + ttl))
        return rid

    def mark_extras(self, rids) -> None:
        """Requests ``rids`` carry modality extras: no prefix cache for them."""
        self._extra_rids |= set(rids)

    def cancel(self, rid: int) -> bool:
        req = next((r for r in self.requests if r.rid == rid), None)
        if req is None or req.state in TERMINAL:
            return False
        req.cancel_requested = True
        return True

    def live(self) -> bool:
        return any(r.state not in TERMINAL for r in self.requests)

    def _fire(self, site: str) -> Optional[str]:
        return self.faults.fire(site) if self.faults is not None else None

    # ---------------------------------------------------- lifecycle plumbing
    def evict_request(self, req: Request, state: str, it: int) -> None:
        """Move ``req`` to terminal ``state`` from ANY lifecycle phase,
        unwinding whatever it holds.  Full blocks are registered before
        release — their rows are final KV, so the prefix index keeps them
        (a re-submitted prompt still hits); the partially-written frontier
        block is released unregistered, so no writable block is ever
        published (audited by ``audit_pool``)."""
        if req.state in (PREFILL, DECODE):
            if req.blocks:
                self._register_blocks(req)
                self.pool.release(req.blocks[::-1])   # chain head → MRU end
                req.blocks = []
                req.shared = req.registered = 0
            if req.slot >= 0:
                if self.paged:
                    self._host_table[req.slot, :] = -1
                    self._table_dirty = True
                self._free_slots.append(req.slot)
                self._slot_req[req.slot] = None
                req.slot = -1
        req.state = state
        req.done_iter = it
        # terminal latency is still wall-clock since arrival — evicted
        # requests (cancelled / timed out / rejected) otherwise report the
        # -1.0 dataclass default as their latency_s
        if req.arrival_time >= 0:
            req.done_time = time.perf_counter() - req.arrival_time
        req.filled = 0
        req.kv_len = 0

    def reap(self, it: int) -> int:
        """Process cancellations and deadlines at the iteration boundary;
        returns how many requests reached a terminal state."""
        n = 0
        for r in self.requests:
            if r.state in TERMINAL:
                continue
            if r.cancel_requested:
                self.evict_request(r, CANCELLED, it)
                self.cancellations += 1
                n += 1
            elif r.deadline is not None and it >= r.deadline:
                self.evict_request(r, TIMED_OUT, it)
                self.timeouts += 1
                n += 1
        return n

    def _retry(self, req: Request, it: int) -> None:
        """Absorb a transient admission failure: exponential backoff, then
        the REJECTED backstop once the per-request retry budget is spent
        (an unbounded retry of a persistent fault would livelock strict-
        FCFS admission)."""
        req.retries += 1
        self.admission_retries += 1
        if req.retries > self.cfg.admission_retries:
            self.evict_request(req, REJECTED, it)
            self.rejections += 1
        else:
            req.next_retry_iter = it + min(
                self.cfg.retry_backoff ** req.retries, 64)

    def stamp_arrivals(self, it: int, now: float) -> None:
        """Anchor wall-clock latency at arrival.  Stamped unconditionally
        on visibility, NOT gated on WAITING: a request admitted the same
        iteration it became visible would otherwise keep the -1.0 default
        and report garbage latency."""
        for r in self.requests:
            if r.arrival <= it and r.arrival_time < 0:
                r.arrival_time = now

    def _seq(self, req: Request) -> np.ndarray:
        """Tokens to prefill: the prompt, plus — after a preemption — the
        tokens already emitted, replayed so decode resumes exactly where it
        left off (greedy outputs are chunking-invariant, so the replayed
        prefix regenerates the identical KV state)."""
        if req.out:
            return np.concatenate([req.tokens,
                                   np.asarray(req.out, np.int32)])
        return req.tokens

    def _chain_for(self, req: Request, tokens: np.ndarray,
                   n_full: int) -> List[int]:
        """First ``n_full`` chain hashes of the request's sequence,
        extending the memoized chain only over blocks not yet hashed."""
        chain = req.hash_chain
        if n_full > len(chain):
            dense_from = (len(req.tokens) if self._policy_enabled else None)
            chain.extend(chain_block_hashes(
                tokens, self.pool.block_size, n_full, dense_from,
                start=len(chain), h0=chain[-1] if chain else None))
        return chain[:n_full]

    def match_prefix(self, req: Request, seq: np.ndarray) -> List[int]:
        """Longest indexed block-prefix of the request's prefill sequence.
        Capped at ``len(seq) - 1`` tokens: at least one token must run
        through prefill to produce the logits the next token samples from,
        so the request's last block is always a fresh allocation (and a
        partially-covered tail block has no full-block hash anyway) —
        shared blocks are therefore never writable."""
        if not self.prefix_cache or req.rid in self._extra_rids:
            return []
        n_full = (len(seq) - 1) // self.pool.block_size
        if n_full == 0:
            return []
        dense_from = len(req.tokens) if self._policy_enabled else None
        return self.pool.match(
            self._chain_for(req, seq, n_full),
            keys=chain_block_keys(seq, self.pool.block_size, n_full,
                                  dense_from))

    def admit(self, it: int) -> int:
        # FCFS by arrival, not submission order: requests may be submitted
        # with out-of-order arrival times (and preempted requests requeue
        # with their original arrival).  Returns how many requests changed
        # state (admitted or rejected) — the watchdog's progress signal.
        moved = 0
        for req in sorted(self.requests, key=lambda r: (r.arrival, r.rid)):
            if req.state != WAITING or req.arrival > it:
                continue
            if req.next_retry_iter > it:
                continue               # backing off a transient failure
            seq = self._seq(req)
            need = self.pool.blocks_for(len(seq)) if self.paged else 0
            if self.paged and need > min(self.pool.num_blocks, self._max_blocks):
                # can NEVER fit: strict FCFS would wait on it forever
                # and starve every request behind it (head-of-line
                # livelock) — reject with a terminal state instead.
                # ``submit`` already bounds prompt+max_new, and a
                # replay sequence (prompt + emitted) stays under that
                # bound, so through the public API this is a
                # defense-in-depth backstop: it converts any capacity
                # drift (out-of-band enqueues, future scheduler
                # changes shrinking the pool) into a visible REJECTED
                # request instead of a silent queue stall
                self.evict_request(req, REJECTED, it)
                self.rejections += 1
                moved += 1
                continue
            if not self._free_slots:
                break
            if self._fire("admit") == "transient":
                # injected transient admission failure (e.g. a control-
                # plane hiccup): backoff-and-retry before the backstop
                self._retry(req, it)
                continue
            skip = 0
            if self.paged:
                shared = self.match_prefix(req, seq)
                # full feasibility BEFORE taking anything: reviving a
                # zero-ref cached hit consumes availability (sharing a
                # live block does not), and the fresh remainder must fit
                # what is left — so a refused admission never touches the
                # pool (no rollback, no phantom peak_in_use spike)
                revive = sum(map(self.pool.is_cached, shared))
                if need - len(shared) > self.pool.available - revive:
                    # strict FCFS: the oldest waiting request admits first;
                    # skipping ahead would starve long prompts under
                    # sustained short-prompt traffic
                    break
                acquired: List[int] = []
                try:
                    for b in shared:
                        self.pool.acquire_cached(b)
                        acquired.append(b)
                    fresh = self.pool.alloc(need - len(shared))
                except RuntimeError:
                    # allocation failed mid-admission (injected pool fault,
                    # or capacity raced away): roll back the prefix refs
                    # just acquired — the pool is left exactly as found —
                    # and retry with backoff
                    self.pool.release(acquired[::-1])
                    self._retry(req, it)
                    continue
                req.blocks = shared + fresh
                req.shared = req.registered = len(shared)
                skip = len(shared) * self.pool.block_size
                req.cached_tokens += skip
                self.prefill_demand += len(seq)
                self.tokens_skipped += skip
                self.blocks_reused += len(shared)
                if shared:
                    self.prefix_hits += 1
            slot = self._free_slots.pop(0)
            # prefix-cached rows are already valid KV: the executor resets
            # the slot's pos to the first non-cached token so the first
            # prefill chunk runs mid-sequence (a deferred device-side
            # effect — the scheduler only RECORDS it; reset never touches
            # pooled leaves, so the shared blocks other slots may be
            # reading survive the slot handoff)
            self._pending_resets.append((slot, skip))
            if self.paged:
                self._host_table[slot, :] = -1
                self._host_table[slot, :len(req.blocks)] = req.blocks
                self._table_dirty = True
            req.slot, req.state = slot, PREFILL
            req.filled = req.kv_len = skip
            req.admitted_iter = it
            self._slot_req[slot] = req
            moved += 1
        return moved

    def _register_blocks(self, req: Request) -> None:
        """Publish the request's full blocks in the prefix index.  KV rows
        0..kv_len-1 hold the tokens ``(prompt ++ out)[:kv_len]`` (a freshly
        sampled token's own KV is only written when it is next fed back
        in), so full blocks are content-addressable by that token chain.
        Called whenever row content is final AND worth publishing: after
        each prefill chunk, and — to pick up decode-written rows — right
        before the blocks are released at preemption or completion."""
        if not self.prefix_cache or req.rid in self._extra_rids:
            return
        bs = self.pool.block_size
        n_full = min(req.kv_len // bs, len(req.blocks))
        if n_full <= req.registered:
            return
        seq = self._seq(req)[:req.kv_len]
        hashes = self._chain_for(req, seq, n_full)
        dense_from = len(req.tokens) if self._policy_enabled else None
        keys = chain_block_keys(seq, bs, n_full, dense_from)
        for i in range(req.registered, n_full):
            self.pool.register(req.blocks[i], hashes[i], key=keys[i])
        req.registered = n_full

    def preempt(self, req: Request) -> None:
        """Requeue ``req`` (recompute-on-readmission): its blocks return to
        the pool, its slot frees, and its emitted tokens stay on the
        request to be replayed through prefill when it is re-admitted.
        Full blocks are registered first, so as long as they survive in
        the zero-ref LRU the replay is nearly free: the replayed
        prompt+emitted prefix re-matches exactly what was just released."""
        self.preemptions += 1
        req.preempted += 1
        self.preempt_log.append((req.rid, req.state))
        self._register_blocks(req)
        # deepest blocks first: chain hashes only match a CONTIGUOUS prefix
        # from block 0, so eviction must consume chains tail-first — the
        # reversed release order parks the chain head at the MRU end
        self.pool.release(req.blocks[::-1])
        req.blocks = []
        req.shared = req.registered = 0
        self._host_table[req.slot, :] = -1
        self._table_dirty = True
        self._free_slots.append(req.slot)
        self._slot_req[req.slot] = None
        req.slot = -1
        req.state = WAITING
        req.filled = 0
        req.kv_len = 0

    def ensure_decode_blocks(self) -> None:
        """Grab a fresh block for every decoding slot crossing a block
        boundary; when the pool is dry, preempt the youngest active
        request until the oldest decoders can proceed (or the needy
        request is itself the youngest and yields).  Nothing to do on the
        dense slab."""
        if not self.paged:
            return
        order = sorted((r for r in self.requests if r.state == DECODE),
                       key=lambda r: (r.admitted_iter, r.rid))
        for r in order:
            while r.state == DECODE:
                need = self.pool.blocks_for(r.kv_len + 1)
                if len(r.blocks) >= need:
                    break
                blk = None
                if self.pool.available:
                    try:
                        blk = self.pool.alloc(1)
                    except RuntimeError:
                        blk = None   # injected exhaustion → preempt path
                if blk is not None:
                    self._host_table[r.slot, len(r.blocks)] = blk[0]
                    r.blocks.extend(blk)
                    self._table_dirty = True
                else:
                    victim = max((v for v in self.requests
                                  if v.state in (PREFILL, DECODE)),
                                 key=lambda v: (v.admitted_iter, v.rid))
                    self.preempt(victim)

    def finish(self, req: Request, it: int, t0: float) -> None:
        req.state = DONE
        req.done_iter = it
        anchor = req.arrival_time if req.arrival_time >= 0 else t0
        req.done_time = time.perf_counter() - anchor
        if self.paged and req.blocks:
            self._register_blocks(req)
            self.pool.release(req.blocks[::-1])   # chain head → MRU end
            req.blocks = []
            req.shared = req.registered = 0
            self._host_table[req.slot, :] = -1
            self._table_dirty = True
        self._free_slots.append(req.slot)
        self._slot_req[req.slot] = None
        req.slot = -1

    def clear(self) -> None:
        """Drop completed requests (e.g. after a warmup pass) so a fresh
        stream can be submitted and measured on the already-compiled
        engine.  The prefix index deliberately survives: a warm cache
        across streams is the production behavior being measured."""
        assert all(r.state in TERMINAL for r in self.requests), \
            "cannot clear with requests in flight"
        self.requests = []
        # rids restart at 0 for the next stream: stale extras marks must not
        # reach unrelated requests of the same rid
        self._extra_rids = set()
        self.it = 0
        self._last_progress = 0

    # ------------------------------------------------------- plan building
    def next_chunk(self, req: Request):
        """(tokens (1, C), chunk_len, send_extras, is_replay) for the next
        chunk, padded to ``chunk_size`` (under exact chunks: the next dyadic
        size, unpadded, ``C == chunk_len``).  ``send_extras``: the chunk is
        the first of the request's sequence (``filled == 0``, also after a
        preemption or a restore).  Chunks never span the prompt/emitted
        boundary, so a replay chunk (re-ingesting emitted tokens after a
        preemption) is entirely replay and runs through the dense program.

        Returns the ``(None, 0, False, False)`` sentinel when nothing remains
        to ingest (a fully-filled request momentarily parked in PREFILL)."""
        c = self.cfg.chunk_size
        seq = self._seq(req)
        rem = len(seq) - req.filled
        if rem <= 0:
            return None, 0, False, False
        if req.filled < len(req.tokens):
            rem = min(rem, len(req.tokens) - req.filled)
            replay = False
        else:
            replay = self._policy_enabled
        if self._exact_chunks:
            size = _dyadic_sizes(rem, c)[0]
            return (seq[req.filled:req.filled + size][None, :], size, req.filled == 0,
                    replay)
        v = min(c, rem)
        chunk = np.zeros((c,), np.int32)
        chunk[:v] = seq[req.filled:req.filled + v]
        return chunk[None, :], v, req.filled == 0, replay

    def _drain_effects(self, plan: StepPlan) -> None:
        plan.resets = self._pending_resets
        self._pending_resets = []
        if self.paged and self._table_dirty:
            plan.table = self._host_table
            self._table_dirty = False

    def _prefill_work(self) -> Optional[PrefillWork]:
        prefilling = [r for r in self.requests if r.state == PREFILL]
        if not prefilling:
            return None
        req = prefilling[0]
        tokens, clen, first, replay = self.next_chunk(req)
        if tokens is None:     # fully ingested, parked — nothing to run
            return None
        return PrefillWork(req, tokens, clen, replay, first)

    def _decode_work(self) -> Optional[DecodeWork]:
        decoding = [r for r in self.requests if r.state == DECODE]
        if not decoding:
            return None
        toks = np.zeros((self.cfg.num_slots,), np.int32)
        act = np.zeros((self.cfg.num_slots,), bool)
        for r in decoding:
            toks[r.slot], act[r.slot] = r.cur, True
        return DecodeWork(decoding, toks, act)

    def plan_step(self) -> StepPlan:
        """Fused-path plan: the active request's prefill chunk AND the
        frozen decode roster, as one step-program dispatch."""
        plan = StepPlan(prefill=self._prefill_work(),
                        decode=self._decode_work())
        if plan.has_work:
            self._drain_effects(plan)
        return plan

    def plan_prefill(self) -> StepPlan:
        """Legacy two-program split, phase 1: just the prefill chunk."""
        plan = StepPlan(prefill=self._prefill_work())
        if plan.has_work:
            self._drain_effects(plan)
        return plan

    def plan_decode(self) -> StepPlan:
        """Legacy two-program split, phase 2: the decode roster computed
        AFTER prefill (a request finishing prefill this iteration joins
        decode the same iteration — the legacy scheduling difference)."""
        plan = StepPlan(decode=self._decode_work())
        if plan.has_work:
            self._drain_effects(plan)
        return plan

    # ------------------------------------------------------------- commits
    def commit_chunk(self, req: Request, chunk_len: int) -> None:
        """Fold a completed prefill chunk back into request state and
        publish blocks the chunk just completed: a request admitted while
        this one is still decoding can already share its prompt."""
        req.filled += chunk_len
        req.kv_len += chunk_len
        self._register_blocks(req)

    def seq_complete(self, req: Request) -> bool:
        return req.filled == len(self._seq(req))

    def emit_prefill_token(self, req: Request, tok: int, it: int,
                           t0: float) -> None:
        """The chunk that completed the sequence sampled ``tok``: record
        it and transition to DECODE (or finish on eos/budget)."""
        req.out.append(tok)
        if req.first_token_iter < 0:
            req.first_token_iter = it
        if tok == self.cfg.eos_token or len(req.out) >= req.max_new_tokens:
            self.finish(req, it, t0)
        else:
            req.state, req.cur = DECODE, tok

    def emit_decode_tokens(self, work: DecodeWork, nxt: np.ndarray,
                           it: int, t0: float) -> None:
        for r in work.requests:
            r.kv_len += 1
            tok = int(nxt[r.slot])
            r.out.append(tok)
            r.cur = tok
            if tok == self.cfg.eos_token or len(r.out) >= r.max_new_tokens:
                self.finish(r, it, t0)

    # ------------------------------------------------------------ watchdog
    def observe_progress(self, it: int, progressed: bool) -> None:
        """No-progress watchdog: clean scheduling always advances
        (prefill/decode run every iteration something is active), so a
        stall with admission-eligible waiters only arises under persistent
        faults — force-reject the oldest stuck request instead of
        livelocking until max_iters."""
        pending = [r for r in self.requests
                   if r.state == WAITING and r.arrival <= it]
        if progressed or not pending:
            self._last_progress = it
        elif it - self._last_progress >= self.cfg.watchdog_iters:
            stuck = min(pending, key=lambda r: (r.arrival, r.rid))
            self.evict_request(stuck, REJECTED, it)
            self.rejections += 1
            self.watchdog_trips += 1
            self._last_progress = it

    # ---------------------------------------------------------- auditing
    def audit_pool(self) -> None:
        """Refcount/ownership invariants (cfg.validate_pool): the pool's
        internal partition holds, every live reference is accounted to
        exactly one slot-holding request, and no block is simultaneously
        writable from two slots.  A request's writable frontier is block
        ``kv_len // block_size`` onward (rows below kv_len are final);
        everything it can still write must be exclusively owned and
        unpublished — shared/registered blocks are full and immutable."""
        pool = self.pool
        pool.check_invariants()
        expect: Dict[int, int] = {}
        writable: Dict[int, int] = {}
        for r in self.requests:
            if r.state not in (PREFILL, DECODE):
                assert not r.blocks, \
                    f"r{r.rid} ({r.state}) still holds blocks {r.blocks}"
                continue
            for b in r.blocks:
                expect[b] = expect.get(b, 0) + 1
            for b in r.blocks[r.kv_len // pool.block_size:]:
                assert b not in writable, \
                    f"block {b} writable from r{writable[b]} AND r{r.rid}"
                writable[b] = r.rid
                assert pool.refcount(b) == 1, \
                    f"writable block {b} of r{r.rid} is shared"
                assert not pool.is_registered(b), \
                    f"writable block {b} of r{r.rid} is published"
        assert expect == dict(pool._ref), \
            f"refcount skew: requests hold {expect}, pool says {pool._ref}"

    # ------------------------------------------------------ crash recovery
    def host_snapshot(self) -> Dict[str, Any]:
        """Host-state copy at an iteration boundary (the scheduler's share
        of the engine snapshot — see ContinuousServingEngine.snapshot)."""
        return {
            "it": self.it,
            "requests": copy.deepcopy(self.requests),
            "slot_rids": [None if r is None else r.rid
                          for r in self._slot_req],
            "free_slots": list(self._free_slots),
            "extra_rids": set(self._extra_rids),
            "pool": self.pool.snapshot() if self.paged else None,
            "host_table": self._host_table.copy() if self.paged else None,
            "counters": {
                "preemptions": self.preemptions,
                "rejections": self.rejections,
                "admission_retries": self.admission_retries,
                "watchdog_trips": self.watchdog_trips,
                "timeouts": self.timeouts,
                "cancellations": self.cancellations,
                "prefix_hits": self.prefix_hits,
                "blocks_reused": self.blocks_reused,
                "tokens_skipped": self.tokens_skipped,
                "prefill_demand": self.prefill_demand,
            },
        }

    def host_restore(self, snap: Dict[str, Any]) -> None:
        """Rebuild scheduler state from a :meth:`host_snapshot`.  Device
        KV is treated as LOST — in-flight requests are demoted to WAITING
        with a fresh block pool and empty prefix index, and replay through
        prefill on re-admission (the same recompute path preemption uses,
        so resumed greedy outputs are token-identical)."""
        cfg = self.cfg
        self.it = snap["it"]
        self._last_progress = self.it    # fresh watchdog grace period
        self.requests = copy.deepcopy(snap["requests"])
        self._free_slots = list(range(cfg.num_slots))
        self._slot_req = [None] * cfg.num_slots
        self._pending_resets = []
        self._extra_rids = set(snap["extra_rids"])
        for r in self.requests:
            if r.state in (PREFILL, DECODE):
                r.state = WAITING
                r.slot = -1
                r.blocks = []
                r.shared = r.registered = 0
                r.filled = 0
                r.kv_len = 0
        if self.paged:
            self.pool = BlockPool(snap["pool"]["num_blocks"], cfg.block_size,
                                  prefix_cache=self.prefix_cache)
            self._host_table = np.full((cfg.num_slots, self._max_blocks), -1,
                                       np.int32)
            self._table_dirty = True
        for name, val in snap["counters"].items():
            setattr(self, name, val)
