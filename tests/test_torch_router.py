"""The port's data-parallel router (``repro_torch.serve.router``) against the
JAX package's, case by case with ``tests/test_sharded_serving.py``.

The LLaMA-3.1 smoke config in float32, the port's seeded weights carried
into the JAX tree, the same numpy prompts, arrivals and ``FaultSpec``s
through both packages' ``Engine`` (a ``Router`` at every ``dp``) under
DENSE.  Greedy decoding on the same weights gives the same tokens, and the
routing, failover and merged counters are host logic that must match
exactly: there is no tolerance in this file.  One case serves the
encoder-decoder (Whisper smoke, on the slab) with frame embeddings across
two replicas and a crash.  The CLI runs ``--dp 2 --trace``.

The JAX router is built once (its replicas compile their step programs
once) and each case starts it from the snapshot of its empty fleet
(``Router.restore``, which also revives a replica a crash killed), with
the case's injector set on its replicas and its failover counters at 0.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.models import build_model as jbuild
from repro.serve.api import Engine as JEngine
from repro.serve.api import EngineConfig as JEngineConfig
from repro.serve.continuous import ContinuousConfig as JConfig
from repro.serve.faults import FaultInjector as JInjector
from repro.serve.faults import FaultSpec as JSpec
from repro.serve.router import Router as JRouter
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.launch.serve import main
from repro_torch.models import build_model
from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
from repro_torch.serve.faults import EngineCrash, FaultInjector, FaultSpec
from repro_torch.serve.metrics import MetricsSnapshot
from repro_torch.serve.router import Router

SERVE = dict(max_seq=64, num_slots=2, chunk_size=8)
TERMINAL = ("done", "rejected", "timed_out", "cancelled")
LENS, ARRIVALS = (9, 17, 12, 21, 11), (0, 0, 2, 3, 5)


def _jax_tree(jm, port):
    """The JAX parameter tree of the port's LLaMA (one block kind, so the
    scanned period ``b0`` stacks every layer): the JAX init's structure
    (``jax.eval_shape``, nothing computed) filled from the port's modules.
    The JAX init is slow on the CPU; the weights only have to be the same."""
    def fill(path, sds):
        keys = [p.key for p in path]
        mods = list(port.blocks) if keys[0] == "periods" else [port]
        leaves = []
        for obj in mods:
            for k in keys[2:] if keys[0] == "periods" else keys:
                obj = getattr(obj, k)
            leaves.append(obj.detach().numpy())
        a = np.stack(leaves) if keys[0] == "periods" else leaves[0]
        assert a.shape == sds.shape and a.dtype == sds.dtype, keys
        return a

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's smoke engines run thousands of tiny torch ops: with the
    suite's six workers, torch's intra-op thread pools oversubscribe the
    cores and slow them several-fold.  One thread a worker while this
    module runs; restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model, port params, the JAX ``dp=2``
    engine and the snapshot of its empty fleet), the same weights."""
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    jm = jbuild(cfg)
    tm = build_model(dataclasses.replace(tget("llama31_8b"), dtype="float32"), device="cpu")
    tp = tm.init(0)
    jp = _jax_tree(jm, tp)
    jeng = JEngine.from_config(jm, JEngineConfig(dp=2, serving=JConfig(**SERVE)),
                               policy=jpolicy.DENSE)
    return jm, jp, tm, tp, jeng, jeng.snapshot()


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in lens]


def _port(tm, tp, prompts, arrivals, *, dp, faults=None, max_new=6, **serve):
    eng = Engine.from_config(tm, EngineConfig(dp=dp, serving=ContinuousConfig(
        **{**SERVE, **serve})), faults=faults, device="cpu")
    rids = [eng.submit(p, max_new, arrival=a) for p, a in zip(prompts, arrivals)]
    res = eng.run(tp)
    return eng, [res["outputs"][r] for r in rids]


def _jax(tiny, prompts, arrivals, faults=None, max_new=6):
    """The prompts through the JAX ``dp=2`` engine, started from its empty
    fleet with ``faults`` on every replica."""
    jp, eng, empty = tiny[1], tiny[4], tiny[5]
    router = eng._router
    router.restore(empty)
    router.crashes = router.transplants = 0
    for rep in router.replicas:
        rep.faults = rep.sched.faults = faults
    rids = [eng.submit(p, max_new, arrival=a) for p, a in zip(prompts, arrivals)]
    res = eng.run(jp)
    return eng, [res["outputs"][r] for r in rids]


# ------------------------------------------------------------ dp identity

def test_dp2_tokens_routing_and_metrics_match_jax(tiny):
    """``dp=2`` tokens equal the JAX ``dp=2`` tokens and the port's ``dp=1``
    tokens; each request lands on the JAX router's replica; both replicas
    served; the merged metrics (generated tokens, parts, one dispatch per
    work iteration) equal the JAX router's."""
    tm, tp = tiny[2:4]
    prompts = _prompts(LENS, 10)
    _, one = _port(tm, tp, prompts, ARRIVALS, dp=1)
    eng, two = _port(tm, tp, prompts, ARRIVALS, dp=2)
    jeng, want = _jax(tiny, prompts, ARRIVALS)
    assert two == one == want
    assert eng._router._rid_map == jeng._router._rid_map
    assert isinstance(eng.replicas, tuple) and len(eng.replicas) == 2
    assert all(len(r.requests) > 0 for r in eng.replicas)
    m, jmet = eng.metrics, jeng.metrics
    assert m.replicas is not None and len(m.replicas) == len(jmet.replicas) == 2
    assert m.generated_tokens == jmet.generated_tokens == sum(len(o) for o in two)
    assert m.dispatches_per_iteration == max(
        p.dispatches_per_iteration for p in m.replicas) == jmet.dispatches_per_iteration == 1.0
    for key in ("iterations", "dispatches", "trace_counts"):
        assert getattr(m, key) == getattr(jmet, key), key
    assert [(p.generated_tokens, p.iterations) for p in m.replicas] == \
        [(p.generated_tokens, p.iterations) for p in jmet.replicas]
    with pytest.raises(ValueError, match="replicas"):
        eng.replica


def test_prefix_affinity_routes_like_jax(tiny):
    """Requests opening with the same first block land on one replica, a
    different first block goes by load, and the JAX router picks the same
    replicas; without the prefix cache affinity is off."""
    jm, tm = tiny[0], tiny[2]
    shared = _prompts((16,), 7)[0]
    prompts = [np.concatenate([shared, p]) for p in _prompts((5, 6, 7, 8), 30)]
    other = _prompts((20,), 50)[0]
    cfg, jcfg = ContinuousConfig(**SERVE), JConfig(**SERVE)
    router, jrouter = Router(tm, tpolicy.DENSE, cfg, dp=2), JRouter(jm, jpolicy.DENSE, jcfg,
                                                                    dp=2)
    for r in (router, jrouter):
        for p in prompts + [other]:
            r.submit(p, 4)
    reps = {router._rid_map[g][0] for g in range(len(prompts))}
    assert len(reps) == 1
    assert router._rid_map[len(prompts)][0] not in reps
    assert router._rid_map == jrouter._rid_map
    off = Router(tm, tpolicy.DENSE, dataclasses.replace(cfg, prefix_cache=False), dp=2)
    for p in prompts:
        off.submit(p, 4)
    assert {off._rid_map[g][0] for g in range(len(prompts))} == {0, 1}


# --------------------------------------------------------- crash failover

@pytest.mark.parametrize("seed,site,it", [(0, "decode", 3), (1, "prefill", 1),
                                          (2, "decode", 5)])
def test_replica_crash_drains_to_survivor_like_jax(tiny, seed, site, it):
    """A crash in one replica drains it to the survivor: ``crashes``,
    ``transplants``, ``alive``, the id map and the outputs equal the JAX
    router's, the outputs are a clean ``dp=1`` run's, every request ends
    terminal, and the degraded fleet refuses to snapshot."""
    tm, tp = tiny[2:4]
    prompts = _prompts(LENS, 60 + seed)
    _, clean = _port(tm, tp, prompts, ARRIVALS, dp=1)
    eng, out = _port(tm, tp, prompts, ARRIVALS, dp=2, faults=FaultInjector(
        seed=seed, schedule=[FaultSpec(site, "crash", iters=(it,), limit=1)]))
    jeng, want = _jax(tiny, prompts, ARRIVALS, JInjector(
        seed=seed, schedule=[JSpec(site, "crash", iters=(it,), limit=1)]))
    router, jrouter = eng._router, jeng._router
    assert router.crashes == jrouter.crashes == 1
    assert router.transplants == jrouter.transplants >= 1
    assert router.alive == jrouter.alive and sum(router.alive) == 1
    assert router._rid_map == jrouter._rid_map
    assert out == want == clean
    assert all(eng.request_state(g) in TERMINAL for g in range(len(prompts)))
    assert eng.metrics.generated_tokens == jeng.metrics.generated_tokens
    with pytest.raises(AssertionError, match="degraded"):
        eng.snapshot()


def test_dp1_crash_propagates(tiny):
    tm, tp = tiny[2:4]
    faults = FaultInjector(seed=0, schedule=[FaultSpec("decode", "crash", iters=(2,), limit=1)])
    with pytest.raises(EngineCrash):
        _port(tm, tp, _prompts((9, 17), 80), (0, 0), dp=1, faults=faults)


# ----------------------------------------------------------- fleet state

def test_fleet_snapshot_restore_round_trip_and_clear(tiny):
    """A two-replica fleet's snapshot restores into a new fleet with every
    request's state; a one-replica snapshot does not fit it.  ``clear``
    drops the finished requests and the id map (ids restart at 0) and keeps
    the affinity table, as the reference's does."""
    tm, tp = tiny[2:4]
    prompts = _prompts((9, 17, 12), 95)
    eng, out = _port(tm, tp, prompts, (0, 0, 0), dp=2, max_new=5)
    snap = eng.snapshot()
    assert len(snap["replicas"]) == 2
    eng2 = Engine.from_config(tm, EngineConfig(dp=2, serving=ContinuousConfig(**SERVE)),
                              device="cpu")
    eng2.restore(snap)
    assert [eng2.request_state(r) for r in range(3)] == [eng.request_state(r)
                                                         for r in range(3)] == ["done"] * 3
    one = Engine.from_config(tm, EngineConfig(serving=ContinuousConfig(**SERVE)), device="cpu")
    with pytest.raises(AssertionError, match="replica count"):
        one.restore(snap)
    affinity = dict(eng._router._affinity)
    eng.clear()
    assert eng._router._rid_map == {} and eng._router._affinity == affinity
    assert all(r.requests == [] for r in eng.replicas)
    assert eng.submit(prompts[0], 5) == 0
    assert eng.run(tp)["outputs"][0] == out[0]


def test_merged_metrics_round_trip_and_relabel(tiny):
    """The merged snapshot's dict round-trips, keeps both parts, sums their
    counters, and carries its request records under global ids."""
    tm, tp = tiny[2:4]
    eng, _ = _port(tm, tp, _prompts((9, 17), 97), (0, 1), dp=2)
    m = eng.metrics
    assert MetricsSnapshot.from_dict(m.to_dict()).to_dict() == m.to_dict()
    assert len(m.to_dict()["replicas"]) == 2
    assert m.generated_tokens == sum(p.generated_tokens for p in m.replicas)
    assert sorted(r.rid for r in m.requests) == [0, 1]
    assert {k: sum(p.trace_counts.get(k, 0) for p in m.replicas)
            for k in m.trace_counts} == m.trace_counts


# ------------------------------------------------------------ with extras

WHISPER_SERVE = dict(max_seq=48, num_slots=2, chunk_size=8)


def test_router_sends_extras_to_the_survivor():
    """Whisper smoke on the slab with frame embeddings: ``dp=2`` tokens equal
    ``dp=1``'s, and so do those of a ``dp=2`` run whose first replica
    crashes mid-stream, its requests transplanted with their extras sent
    again from the survivor's first chunk."""
    tcfg = dataclasses.replace(tget("whisper_medium"), dtype="float32")
    tm = build_model(tcfg, device="cpu")
    tp = tm.init(0)
    (rows, d), = tm.stub_shapes().values()
    prompts = _prompts((5, 17, 12, 9), 11)
    extras = {i: {"frame_embeds": np.random.default_rng(100 + i).standard_normal(
        (1, rows, d)).astype(np.float32)} for i in range(len(prompts))}

    def run(dp, faults=None):
        eng = Engine.from_config(tm, EngineConfig(dp=dp, serving=ContinuousConfig(
            **WHISPER_SERVE)), faults=faults, device="cpu")
        for p, a in zip(prompts, (0, 0, 1, 2)):
            eng.submit(p, 5, arrival=a)
        return eng, eng.run(tp, extras=extras)["outputs"]

    _, want = run(1)
    eng, got = run(2)
    assert got == want and all(len(r.requests) == 2 for r in eng.replicas)
    eng, got = run(2, FaultInjector(seed=0, schedule=[
        FaultSpec("decode", "crash", iters=(3,), limit=1)]))
    assert eng._router.crashes == 1 and eng._router.transplants >= 1
    assert got == want
    survivor = eng.replicas[eng._router.alive.index(True)]
    assert survivor.metrics["trace_counts"]["step_prefill"] == 2


# ------------------------------------------------------------------ the CLI

TRACE = ["--smoke", "--arch", "llama31_8b", "--trace", "--num-requests", "6", "--rate",
         "0.7", "--len-range", "6:20", "--slots", "2", "--chunk", "8", "--new-tokens", "5"]


def test_cli_dp2_trace_reports_both_replicas(capfd):
    """``--dp 2 --trace --device cpu``: rc 0, every request done, one
    program per work iteration, a replica line whose two parts add up to
    the throughput line's tokens, each replica's programs traced once (the
    merged ``# traces:`` sums them); ``--dp 2 --tp 2`` (two ranks the CLI
    starts; rank 0 prints the report) serves the same tokens (the report's
    digest) on both replicas."""
    assert main(TRACE + ["--dp", "2", "--device", "cpu"]) == 0
    out = capfd.readouterr().out
    assert "dp=2, tp=1" in out and "done=6 " in out and "ERROR" not in out
    assert "1.00 per work iteration" in out
    per = re.findall(r"r(\d): (\d+) tok / \d+ iters / dpi 1.00",
                     out.split("# replicas (2):")[1].splitlines()[0])
    assert [r for r, _ in per] == ["0", "1"] and all(int(n) > 0 for _, n in per)
    total = int(re.search(r"# throughput: (\d+) tokens", out).group(1))
    assert sum(int(n) for _, n in per) == total == 6 * 5
    traces = re.findall(r"(\w+)=(\d+)", out.split("# traces:")[1].split("(")[0])
    assert traces and all(1 <= int(n) <= 2 for _, n in traces)
    assert main(TRACE + ["--dp", "2", "--tp", "2", "--device", "cpu"]) == 0
    tp2 = capfd.readouterr().out

    def digest(report):
        return next(x for x in report.splitlines() if x.startswith("# tokens:"))

    assert "dp=2, tp=2" in tp2 and "# replicas (2):" in tp2
    assert digest(tp2) == digest(out)
