"""The port's serving lifecycle against the JAX package's: fault injection,
snapshot/restore, the legacy two-program split and ``MetricsSnapshot``.

Both engines serve the same requests (prompts from a numpy seed) on the
same weights (LLaMA-3.1 smoke config, float32, the JAX parameters through
``weights.from_jax_params``), each under its own package's
``FaultInjector`` with the same ``(seed, schedule)``.  They mirror
``tests/test_chaos.py``: faults may change when work happens, never what
surviving requests emit.  Where the JAX package degrades to its oracle
programs, the port raises.  Tolerance: none — tokens, states, fired logs
and counters are compared exactly.
"""
import dataclasses
import gc
import json
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core.pruner import precompute_scales as jprecompute
from repro.models import build_model as jbuild
from repro.serve import faults as jfaults
from repro.serve.continuous import ContinuousConfig as JConfig
from repro.serve.continuous import ContinuousServingEngine as JContinuous
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.models import build_model
from repro_torch.serve import ContinuousConfig, ContinuousServingEngine, Engine, EngineConfig
from repro_torch.serve.faults import (EngineCrash, FaultInjector, FaultSpec, KernelFault,
                                      SITES)
from repro_torch.serve.metrics import MetricsSnapshot
from repro_torch.serve.scheduler import CANCELLED, DONE, REJECTED, TERMINAL, TIMED_OUT
from repro_torch.weights import from_jax_params

MAX_SEQ = 64
SERVE = dict(max_seq=MAX_SEQ, num_slots=2, chunk_size=8, block_size=4, validate_pool=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's smoke engines run thousands of tiny torch ops: with the
    suite's six workers, torch's intra-op thread pools oversubscribe the
    cores and slow them.  One thread a worker while this module runs;
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model, port params), the same weights."""
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(tcfg, device="cpu"), tp


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in lens]


def _jax(jm, jp, prompts, arrivals, max_new, policy=jpolicy.DENSE, faults=None, **kw):
    eng = JContinuous(jm, policy, JConfig(**{**SERVE, **kw}), faults=faults)
    for p, a in zip(prompts, arrivals):
        eng.submit(p, max_new_tokens=max_new, arrival=a)
    return eng, eng.run(jp)


def _engine(tm, policy=tpolicy.DENSE, faults=None, **kw):
    return ContinuousServingEngine(tm, policy, ContinuousConfig(**{**SERVE, **kw}),
                                   faults=faults)


def _port(tm, tp, prompts, arrivals, max_new, policy=tpolicy.DENSE, faults=None, **kw):
    eng = _engine(tm, policy, faults, **kw)
    for p, a in zip(prompts, arrivals):
        eng.submit(p, max_new_tokens=max_new, arrival=a)
    return eng, eng.run(tp)


def _drained(eng):
    """Every request terminal and holding nothing, every block back."""
    assert all(r.state in TERMINAL for r in eng.requests)
    assert all(not r.blocks and r.slot == -1 for r in eng.requests)
    assert eng.pool.in_use == 0, "leaked live blocks after drain"
    eng.pool.check_invariants()


# ------------------------------------------------------- injector mechanics

def test_injector_replay_matches_jax():
    """The same ``(seed, schedule)`` fires the same sequence in both
    packages, replays deterministically (also through ``to_json``), and a
    different seed perturbs only the probabilistic spec."""
    sched = [dict(site="pool.alloc", kind="exhausted", p=0.3),
             dict(site="decode", kind="nonfinite", calls=(2, 5), limit=1),
             dict(site="admit", kind="transient", iters=(1,))]

    def drive(inj):
        for it in range(6):
            inj.tick(it)
            for site in ("admit", "pool.alloc", "decode", "pool.alloc"):
                inj.fire(site)
        return inj.fired

    a = drive(FaultInjector(seed=7, schedule=sched))
    assert a == drive(jfaults.FaultInjector(seed=7, schedule=sched))
    assert a == drive(FaultInjector(seed=7, schedule=sched)) and len(a) >= 2
    assert drive(FaultInjector.from_json(FaultInjector(seed=7, schedule=sched).to_json())) == a
    d = drive(FaultInjector(seed=8, schedule=sched))
    assert ([f for f in d if f["site"] != "pool.alloc"]
            == [f for f in a if f["site"] != "pool.alloc"])
    assert SITES == jfaults.SITES
    with pytest.raises(AssertionError):
        FaultSpec("no.such.site", "boom")


def test_clean_run_records_no_faults(tiny):
    """An undisturbed run counts no fault, retry, watchdog trip, timeout,
    cancellation or restore, and emits the JAX engine's tokens."""
    jm, jp, tm, tp = tiny
    prompts = _prompts([9, 14], 400)
    _, want = _jax(jm, jp, prompts, [0, 1], 6)
    eng, res = _port(tm, tp, prompts, [0, 1], 6)
    assert res["outputs"] == want["outputs"]
    m = res["metrics"]
    assert m["degraded_iterations"] == 0
    lc = m["lifecycle"]
    assert lc["admission_retries"] == lc["watchdog_trips"] == lc["restores"] == 0
    assert lc["timeouts"] == lc["cancellations"] == lc["faults_fired"] == 0
    assert lc["terminal_states"] == {DONE: 2, REJECTED: 0, TIMED_OUT: 0, CANCELLED: 0}
    _drained(eng)


# ------------------------------------------------- pool and admit faults

POOL_SCENARIOS = {
    # the first two allocations fail outright, then a random 30% (capped so
    # the retry budget always wins), plus one transient admission failure
    "exhaustion": ([9, 17, 6, 12], [0, 0, 2, 3], 6, None, [
        dict(site="pool.alloc", kind="exhausted", calls=(0, 1)),
        dict(site="pool.alloc", kind="exhausted", p=0.3, limit=4),
        dict(site="admit", kind="transient", calls=(3,))]),
    # flushing the zero-ref prefix LRU at random allocations
    "evict_storm": ([6, 9, 7], [0, 3, 5], 6, 16, [
        dict(site="pool.alloc", kind="evict_storm", calls=(3,)),
        dict(site="pool.alloc", kind="evict_storm", p=0.25)]),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(POOL_SCENARIOS))
def test_pool_faults_token_identical(tiny, name, seed):
    """Pool exhaustion absorbed by admission retries (and decode-growth
    preemption), and eviction storms: the port's tokens are the undisturbed
    JAX run's, and its fired log, retries, preemptions and evictions are
    the JAX engine's under the same schedule."""
    jm, jp, tm, tp = tiny
    lens, arrivals, max_new, shared, sched = POOL_SCENARIOS[name]
    prompts = _prompts(lens, 410)
    if shared:
        sysp = _prompts([shared], 420)[0]
        prompts = [np.concatenate([sysp, p]) for p in prompts]
    _, base = _jax(jm, jp, prompts, arrivals, max_new, num_slots=3)
    jinj = jfaults.FaultInjector(seed=seed, schedule=sched)
    _, jres = _jax(jm, jp, prompts, arrivals, max_new, faults=jinj, num_slots=3)
    inj = FaultInjector(seed=seed, schedule=sched)
    eng, res = _port(tm, tp, prompts, arrivals, max_new, faults=inj, num_slots=3)
    assert res["outputs"] == base["outputs"] == jres["outputs"]
    assert inj.fired == jinj.fired and inj.total_fired >= 1
    lc, jlc = res["metrics"]["lifecycle"], jres["metrics"]["lifecycle"]
    assert lc == jlc
    assert lc["terminal_states"][DONE] == len(prompts)
    for key in ("preemptions", "evictions", "prefix_hits", "peak_blocks_in_use"):
        assert res["metrics"]["paged"][key] == jres["metrics"]["paged"][key], key
    if name == "exhaustion":
        assert lc["admission_retries"] >= 3
    _drained(eng)


# ------------------------------------------- crash + snapshot/restore

CRASHES = [dict(site="decode", kind="crash", iters=tuple(range(4, 9)), limit=1),
           dict(site="prefill", kind="crash", iters=tuple(range(11, 15)), limit=1)]


def _serve_with_restores(make, submit, params, faults, crash=EngineCrash):
    """Run, and after every ``crash`` (the package's EngineCrash) restore the
    last auto-snapshot into a NEW engine (the crashed one dropped first).
    Returns (engine, result, crashes, weak references to the crashed
    engines)."""
    eng = make(faults)
    submit(eng)
    crashes, dead = 0, []
    for _ in range(5):
        try:
            return eng, eng.run(params), crashes, dead
        except crash:
            crashes += 1
        snap = eng.last_snapshot
        assert snap is not None
        dead.append(weakref.ref(eng))
        del eng
        eng = make(faults)
        eng.restore(snap)
    raise AssertionError("engine never finished after restores")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_crash_restore_resumes_token_identical(tiny, fused):
    """EngineCrash mid-decode and mid-prefill kills the engine; a NEW engine
    restored from the last auto-snapshot finishes the stream with the
    undisturbed JAX run's tokens, as the JAX engine does under the same
    schedule (``restores == crashes``), and the crashed engines are gone
    once dropped."""
    jm, jp, tm, tp = tiny
    lens, arrivals, max_new = [9, 16, 12], [0, 1, 2], 8
    prompts = _prompts(lens, 460)
    _, base = _jax(jm, jp, prompts, arrivals, max_new, fused_step=fused)

    def submit(eng):
        for p, a in zip(prompts, arrivals):
            eng.submit(p, max_new_tokens=max_new, arrival=a)

    jinj = jfaults.FaultInjector(seed=0, schedule=CRASHES)
    _, jres, jcrashes, _ = _serve_with_restores(
        lambda f: JContinuous(jm, jpolicy.DENSE, JConfig(
            **SERVE, snapshot_every=1, fused_step=fused), faults=f), submit, jp, jinj,
        jfaults.EngineCrash)
    inj = FaultInjector(seed=0, schedule=CRASHES)
    gc.disable()
    try:
        eng, res, crashes, dead = _serve_with_restores(
            lambda f: _engine(tm, faults=f, snapshot_every=1, fused_step=fused),
            submit, tp, inj)
        assert all(ref() is None for ref in dead), "a crashed engine is still alive"
    finally:
        gc.enable()
    assert crashes == jcrashes == 2 and eng.restores == crashes
    assert inj.fired == jinj.fired
    assert res["outputs"] == base["outputs"] == jres["outputs"]
    assert res["metrics"]["lifecycle"]["restores"] == crashes
    assert res["metrics"]["lifecycle"]["terminal_states"][DONE] == len(prompts)
    assert set(eng.trace_counts.values()) == {1}
    _drained(eng)


def test_snapshot_is_deep_and_reusable(tiny):
    """Through the facade: a snapshot is isolated from the live engine, and
    restoring it twice into new engines completes the same way, with the
    undisturbed run's tokens; ``request_state`` reads the lifecycle."""
    jm, jp, tm, tp = tiny
    prompts = _prompts([10, 14], 470)
    inj = FaultInjector(seed=0, schedule=[FaultSpec("decode", "crash", iters=(5,), limit=1)])

    def engine(faults=None):
        return Engine.from_config(tm, EngineConfig(serving=ContinuousConfig(
            **SERVE, snapshot_every=2)), faults=faults, device="cpu")

    eng = engine(inj)
    for p, a in zip(prompts, [0, 1]):
        eng.submit(p, 6, a)
    with pytest.raises(EngineCrash):
        eng.run(tp)
    snap = eng.last_snapshot
    assert eng.request_state(0) in ("prefill", "decode")
    frozen = [(r.rid, r.state, list(r.out)) for r in snap["replicas"][0]["requests"]]
    outs = []
    for _ in range(2):
        e2 = engine()
        e2.restore(snap)
        outs.append(e2.run(tp)["outputs"])
        assert [e2.request_state(r) for r in (0, 1)] == [DONE, DONE]
        assert e2.metrics.lifecycle.restores == 1
        _drained(e2.replica)
    assert [(r.rid, r.state, list(r.out)) for r in snap["replicas"][0]["requests"]] == frozen
    assert outs[0] == outs[1]
    _, base = _jax(jm, jp, prompts, [0, 1], 6, snapshot_every=2)
    assert outs[0] == base["outputs"]


# ------------------------------------------ deadline / cancellation storm

def test_deadline_and_cancel_storm(tiny):
    """TTL expiry and cancel() (driven through ``iteration_hook``) unwind
    requests from every phase — waiting, mid-prefill, decoding — with the
    JAX engine's terminal states, counters and survivor tokens."""
    jm, jp, tm, tp = tiny
    lens, arrivals, max_new = [9, 16, 20, 8, 11], [0, 0, 1, 2, 3], 8
    prompts = _prompts(lens, 480)

    def drive(eng, params):
        for i, (p, a) in enumerate(zip(prompts, arrivals)):
            eng.submit(p, max_new_tokens=max_new, arrival=a, ttl=3 if i == 1 else None)
        seen = {}

        def hook(engine, it):
            r2 = engine.requests[2]
            if r2.state == "prefill" and r2.filled > 0 and 2 not in seen:
                seen[2] = ("mid-prefill", it)
                assert engine.cancel(2)
            if it == 1 and engine.requests[3].state == "waiting":
                seen[3] = ("waiting", it)
                assert engine.cancel(3)

        eng.iteration_hook = hook
        res = eng.run(params)
        return res, seen, {r.rid: r.state for r in eng.requests}

    jres, jseen, jstates = drive(JContinuous(jm, jpolicy.DENSE, JConfig(**SERVE)), jp)
    eng = _engine(tm)
    res, seen, states = drive(eng, tp)
    assert states == jstates and seen == jseen
    assert states[1] == TIMED_OUT and states[2] == states[3] == CANCELLED
    assert states[0] == states[4] == DONE
    assert res["outputs"] == jres["outputs"]
    assert res["metrics"]["lifecycle"] == jres["metrics"]["lifecycle"]
    assert res["metrics"]["lifecycle"]["timeouts"] == 1
    assert res["metrics"]["lifecycle"]["cancellations"] == 2
    assert not eng.cancel(2) and not eng.cancel(0)
    _drained(eng)


def test_watchdog_breaks_admission_livelock(tiny):
    """A persistent allocation fault with an unbounded retry budget: the
    no-progress watchdog force-rejects the stuck requests, at the JAX
    engine's iteration, instead of spinning to max_iters."""
    jm, jp, tm, tp = tiny
    prompts = _prompts([9, 12], 490)
    sched = [dict(site="pool.alloc", kind="exhausted", p=1.0)]
    kw = dict(admission_retries=10 ** 6, watchdog_iters=8)
    _, jres = _jax(jm, jp, prompts, [0, 1], 4, faults=jfaults.FaultInjector(0, sched), **kw)
    eng, res = _port(tm, tp, prompts, [0, 1], 4, faults=FaultInjector(0, sched), **kw)
    lc = res["metrics"]["lifecycle"]
    assert lc["watchdog_trips"] >= 1 and lc["terminal_states"][REJECTED] == 2
    assert lc == jres["metrics"]["lifecycle"]
    assert res["metrics"]["iterations"] == jres["metrics"]["iterations"] < 200
    assert all(not out for out in res["outputs"].values())
    _drained(eng)


# ------------------------------------- where JAX degrades, the port raises

RAISES = [("prefill", "nonfinite", FloatingPointError),
          ("decode", "nonfinite", FloatingPointError)] + [
    (site, kind, KernelFault)
    for site in ("kernel.projection", "kernel.paged_attention", "kernel.paged_scatter")
    for kind in ("compile_error", "fallback")]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("site,kind,exc", RAISES, ids=[f"{s}-{k}" for s, k, _ in RAISES])
def test_port_raises_where_jax_degrades(tiny, site, kind, exc, fused):
    """The JAX engine re-runs a faulted step on its oracle program (or takes
    the jnp branch for ``fallback``); the port has neither and raises: a
    ``nonfinite`` fault reaches the step as its fault operand and the
    finiteness check raises ``FloatingPointError``; a ``kernel.*`` fault
    raises ``KernelFault`` naming the site.  The paper's policy with the
    kernel wrappers on (their plain versions on the CPU), so every kernel
    site is consulted."""
    _, _, tm, tp = tiny
    policy = tpolicy.paper_policy(8, 16, (3,)).with_(use_kernels=True)
    inj = FaultInjector(seed=0, schedule=[FaultSpec(site, kind, calls=(1,))])
    eng = _engine(tm, policy, faults=inj, fused_step=fused)
    for p, a in zip(_prompts([11, 18], 430), [0, 1]):
        eng.submit(p, max_new_tokens=5, arrival=a)
    with pytest.raises(exc, match=site if exc is KernelFault else "non-finite"):
        eng.run(tp)
    assert inj.fired_kinds(site) == [kind]


# ----------------------------------------------------- the legacy split

@pytest.mark.parametrize("name", ["dense", "paper_8_16"])
def test_legacy_split_matches_fused_and_jax(tiny, name):
    """``fused_step=False``: the legacy two-program split emits the fused
    path's tokens and the JAX legacy engine's, with its dispatch count, and
    captures each program once (``prefill``/``decode``, plus
    ``prefill_replay`` when a preemption replays under a sparse policy), as
    ``test_single_trace_per_bucket_legacy`` pins for the JAX engine."""
    from repro_torch.serve.executor import declared_trace_keys

    jm, jp, tm, _ = tiny
    jpol = jpolicy.DENSE if name == "dense" else jpolicy.paper_policy(8, 16, (3,))
    tpol = tpolicy.DENSE if name == "dense" else tpolicy.paper_policy(8, 16, (3,))
    jparams = jprecompute(jp, jpol)
    tparams = from_jax_params(tm.cfg, jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    lens, arrivals = [3, 9, 14, 23, 31, 6], [0, 0, 1, 2, 5, 9]
    prompts = _prompts(lens, 70)
    # a small pool: decode growth preempts, and replays run
    kw = dict(num_slots=3, chunk_size=16, num_blocks=10)
    _, jres = _jax(jm, jparams, prompts, arrivals, 8, jpol, fused_step=False, **kw)
    _, fres = _port(tm, tparams, prompts, arrivals, 8, tpol, **kw)
    eng, res = _port(tm, tparams, prompts, arrivals, 8, tpol, fused_step=False, **kw)
    assert res["outputs"] == fres["outputs"] == jres["outputs"]
    m, jm_ = res["metrics"], jres["metrics"]
    assert m["dispatches"] == jm_["dispatches"] and m["iterations"] == jm_["iterations"]
    assert m["dispatches_per_iteration"] > 1.0 == fres["metrics"]["dispatches_per_iteration"]
    assert m["trace_counts"] == jm_["trace_counts"] == eng.trace_counts
    assert set(m["trace_counts"].values()) == {1}
    assert {"prefill", "decode"} <= set(m["trace_counts"]) <= set(declared_trace_keys())
    assert set(m["buckets"]) == set(m["trace_counts"])
    assert m["paged"]["preemptions"] == jm_["paged"]["preemptions"] > 0
    if name != "dense":
        assert "prefill_replay" in m["trace_counts"]
    _drained(eng)


# ------------------------------------------------------ MetricsSnapshot

def _keys(d):
    """Nested key set of a metrics dict (request records: one record's)."""
    out = set()
    for k, v in d.items():
        out.add(k)
        if isinstance(v, dict) and k not in ("trace_counts", "buckets", "terminal_states"):
            out |= {f"{k}.{s}" for s in _keys(v)}
        if k == "requests":
            out |= {f"requests.{s}" for s in _keys(v[0])}
    return out


def test_metrics_snapshot_matches_jax_schema(tiny):
    """``run()["metrics"]`` is ``MetricsSnapshot.to_dict()``: its key set is
    the JAX engine's plus ``buckets``, ``from_dict`` round-trips it, and
    ``merge`` of one part keeps its counters and buckets."""
    jm, jp, tm, tp = tiny
    prompts = _prompts([9, 14], 480)
    _, jres = _jax(jm, jp, prompts, [0, 1], 4)
    eng, res = _port(tm, tp, prompts, [0, 1], 4)
    snap = eng.metrics_snapshot
    d = res["metrics"]
    assert d == snap.to_dict()
    assert _keys(d) == _keys(jres["metrics"]) | {"buckets"}
    assert d["schema_version"] == 1 and d["buckets"]
    assert MetricsSnapshot.from_dict(d).to_dict() == d
    merged = MetricsSnapshot.merge([snap])
    assert merged.buckets == snap.buckets and merged.dispatches == snap.dispatches
    assert merged.replicas == [snap]
    assert MetricsSnapshot.from_dict(json.loads(snap.to_json())).to_dict() == d


def test_block_pool_snapshot_restore_matches_jax():
    """``BlockPool.snapshot`` after the same allocations, registrations and
    releases equals the JAX pool's, and ``restore`` into a new pool
    rebuilds it exactly (free-list order, refcounts, index, LRU order)."""
    from repro.serve.paged import BlockPool as JPool
    from repro.serve.paged import chain_block_hashes as jhashes
    from repro_torch.serve.paged import BlockPool, chain_block_hashes

    tokens = np.random.default_rng(3).integers(0, 256, size=40).astype(np.int32)
    snaps = []
    for pool_cls, hashes in ((JPool, jhashes), (BlockPool, chain_block_hashes)):
        pool = pool_cls(12, 4)
        a, b = pool.alloc(5), pool.alloc(3)
        for blk, h in zip(a, hashes(tokens, 4, 5)):
            pool.register(blk, h)
        pool.release(a[::-1])
        pool.acquire_cached(a[0])
        pool.alloc(6)                      # evicts from the zero-ref LRU
        pool.release(b)
        snaps.append(pool.snapshot())
    assert snaps[0] == snaps[1]
    fresh = BlockPool(12, 4)
    fresh.restore(snaps[1])
    assert fresh.snapshot() == snaps[1] and fresh.evictions > 0
