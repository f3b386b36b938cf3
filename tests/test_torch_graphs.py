"""The port's step programs, which a CUDA graph captures on the GPU, on the
CPU: every ``STEP_BUCKETS`` program against the model's entry points, the
slot as a device index against the JAX engine, and the launch counters that
a graph replay adds to.  (The graphs themselves, and the launch counts
under replay, are card tests in ``tests/test_torch_cuda.py``.)
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core.pruner import precompute_scales as jprecompute
from repro.models import build_model as jbuild
from repro.serve.api import Engine as JEngine
from repro.serve.api import EngineConfig as JEngineConfig
from repro.serve.continuous import ContinuousConfig as JConfig
from repro_torch import kernels
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.core.pruner import precompute_scales
from repro_torch.models import build_model
from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
from repro_torch.serve.executor import STEP_BUCKETS, Executor
from repro_torch.weights import from_jax_params


def test_counters_set_and_add_round_trip():
    """``kernels.counters`` reads every launch counter as one flat dict
    (per kernel, osparse's pruned calls, the int8 GEMMs by route), and
    ``set_counters`` / ``add_counters`` write them back: what a capture
    takes back and a replay adds."""
    saved = kernels.counters()
    try:
        kernels.reset_launch_counts()
        zero = kernels.counters()
        assert set(zero.values()) == {0}
        assert {"paged_kv_scatter", "osparse_matmul.pruned", "osparse_matmul.wgmma",
                "w8a8_matmul.swap_fused"} <= set(zero)
        delta = {"paged_kv_scatter": 32, "osparse_matmul.swap_fused": 192,
                 "osparse_matmul.pruned": 54}
        kernels.add_counters(delta)
        kernels.add_counters(delta)
        now = kernels.counters()
        assert {k: v for k, v in now.items() if v} == {k: 2 * v for k, v in delta.items()}
        assert kernels.launch_counts()["paged_kv_scatter"] == 64
        kernels.set_counters(zero)
        assert kernels.counters() == zero
    finally:
        kernels.set_counters(saved)


def _smoke_executor(policy):
    cfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    precompute_scales(params, policy)
    ex = Executor(model, policy, ContinuousConfig(max_seq=32, num_slots=3, chunk_size=8,
                                                  block_size=8))
    ex.init_cache(12)
    ex.cache["block_table"].copy_(torch.arange(12, dtype=torch.int32).reshape(3, 4))
    ex.cache["pos"].copy_(torch.tensor([5, 9, 0], dtype=torch.int32))
    return model, params, ex


@pytest.mark.parametrize("bucket", list(STEP_BUCKETS), ids=list(STEP_BUCKETS.values()))
def test_step_program_runs_every_bucket(bucket):
    """``step_program(bucket)``, the body a bucket's graph captures, equals
    the model's own entry points on a copy of the cache: the prefill half
    on slot 2 (a 0-d index tensor, chunk_len 6 of 8), then the decode half
    over the three slots with slot 1 inactive (its ``pos`` stays)."""
    policy = tpolicy.paper_policy(8, 16, (3,)).with_(use_kernels=True)
    model, params, ex = _smoke_executor(policy)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, 256, size=(1, 8)).astype(np.int32))
    toks = torch.from_numpy(rng.integers(0, 256, size=3).astype(np.int32))
    slot = torch.tensor(2, dtype=torch.int32)
    chunk_len = torch.tensor(6, dtype=torch.int32)
    active = torch.tensor([True, False, True])
    ref = copy.deepcopy(ex.cache)
    p_logits, d_logits, finite = ex.step_program(bucket)(
        params, ex.cache, slot, tokens, chunk_len, toks, active, torch.zeros(()))
    replay, has_prefill, has_decode = bucket
    dense = tpolicy.DENSE.with_(use_kernels=True)
    if has_prefill:
        sub = {"pos": ref["pos"][2].clone(), "block_table": ref["block_table"][2:3],
               "layers": ref["layers"]}
        want, sub = model.prefill_chunk(params, {"tokens": tokens, "chunk_len": chunk_len},
                                        sub, policy=dense if replay else policy)
        ref["pos"][2] = sub["pos"]
        assert torch.equal(p_logits, want[0])
    else:
        assert p_logits is None
    if has_decode:
        want, new = model.decode_step(params, toks[:, None], ref, policy=dense)
        ref["pos"] = torch.where(active, new["pos"], ref["pos"])
        assert torch.equal(d_logits, want)
    else:
        assert d_logits is None
    assert bool(finite)
    assert torch.equal(ex.cache["pos"], ref["pos"])
    assert ex.cache["pos"].tolist() == [5 + has_decode, 9, 6 * has_prefill + has_decode]
    for got, want in zip(ex.cache["layers"], ref["layers"]):
        assert torch.equal(got["k"], want["k"]) and torch.equal(got["v"], want["v"])
    assert [name for _, name, _ in ex.step_programs()] == list(STEP_BUCKETS.values())


def test_prefill_into_slot_2_while_slots_0_and_1_decode():
    """Two requests take slots 0 and 1 and decode; a third arrives and is
    prefilled, chunk by chunk, into slot 2 beside their decode (the
    ``step_prefill_decode`` program with slot 2 in its operand buffer).
    Every request's tokens equal the JAX engine's."""
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    jm = jbuild(cfg)
    jpol = jpolicy.paper_policy(8, 16, (3,))
    jp = jprecompute(jm.init(jax.random.PRNGKey(0)), jpol)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 7, 19)]
    arrivals, max_new = [0, 0, 3], [14, 14, 4]
    serve = dict(max_seq=40, num_slots=3, chunk_size=8, block_size=8)
    jeng = JEngine.from_config(jm, JEngineConfig(serving=JConfig(**serve)), policy=jpol)
    for p, a, n in zip(prompts, arrivals, max_new):
        jeng.submit(p, n, a)
    want = jeng.run(jp)["outputs"]

    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    eng = Engine.from_config(build_model(tcfg, device="cpu"), EngineConfig(
        serving=ContinuousConfig(**serve)), policy=tpolicy.paper_policy(8, 16, (3,)).with_(
            use_kernels=True), device="cpu")
    ex = eng.replica.exec
    seen = []
    step = ex.step

    def recording_step(params, plan, fault=0.0, extras=None):
        out = step(params, plan, fault, extras)
        if plan.prefill is not None:        # the slot the plan named, and the operand's
            seen.append((plan.prefill.req.slot, plan.decode is not None,
                         int(ex._operands[0])))
        return out

    ex.step = recording_step
    for p, a, n in zip(prompts, arrivals, max_new):
        eng.submit(p, n, a)
    res = eng.run(from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    assert res["outputs"] == want
    # the third request's three chunks went to slot 2 beside a decode half
    assert seen.count((2, True, 2)) == 3
    assert res["metrics"]["trace_counts"]["step_prefill_decode"] == 1


def test_engines_are_freed_when_dropped():
    """Neither engine holds itself in a reference cycle: dropped, it goes at
    once, and with it its cache, its graphs and their memory pool, and its
    hold on the parameters (on the card, the graphs keep them alive)."""
    import gc
    import weakref

    from repro_torch.serve import ServeConfig, ServingEngine

    cfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    gc.disable()
    try:
        eng = Engine.from_config(model, EngineConfig(serving=ContinuousConfig(
            max_seq=32, num_slots=2, chunk_size=8)), device="cpu")
        eng.submit(np.arange(5), 3)
        eng.run(params)
        executor = weakref.ref(eng.replica.exec)
        del eng
        assert executor() is None
        one_shot = ServingEngine(model, tpolicy.DENSE, ServeConfig(max_seq=32))
        one_shot.generate(params, {"tokens": torch.ones((1, 4), dtype=torch.int64)}, 2)
        ref = weakref.ref(one_shot)
        del one_shot
        assert ref() is None
    finally:
        gc.enable()
