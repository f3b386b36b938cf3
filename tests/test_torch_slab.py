"""The dense per-slot slab of the port against the JAX package's.

* Continuous serving on the slab: the Mixtral-8x7B smoke model (window 16,
  where paging turns off by itself; one request of 37 tokens wraps its
  ring; chunk 8 fits the ring) and the LLaMA-3.1-8B smoke model with
  ``paged=False``, under ``paper_policy(8, 16)`` and DENSE, fused and legacy
  split, plain path and kernel wrappers (their plain versions on the CPU):
  the greedy tokens, ``trace_counts`` and scheduling counters equal the JAX
  ``ContinuousServingEngine``'s (float32, the JAX weights through
  ``from_jax_params``); ``metrics["paged"]`` is ``{"enabled": False}``.
* The slab's lifecycle: crash/restore through snapshots (tokens identical
  to the undisturbed run, as the JAX engine's), the slot helpers in place
  (a slice shares the slab, a reset zeroes one slot), and a chunk larger
  than the ring refused with ``ValueError`` where the JAX package asserts.
* One-shot ``ServingEngine.generate`` on Mixtral's rings against the JAX
  one-shot engine, a prompt past the window.
* The CLI: ``--trace --no-paged`` and ``--arch mixtral_8x7b --smoke`` report
  the JAX CLI's counters and ``# paged KV: disabled``; one-shot mode on
  Mixtral runs.
Tolerance: none — tokens and counters are compared exactly.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core.pruner import precompute_scales as jprecompute
from repro.launch.serve import main as jax_main
from repro.models import build_model as jbuild
from repro.serve import faults as jfaults
from repro.serve.continuous import ContinuousConfig as JConfig
from repro.serve.continuous import ContinuousServingEngine as JContinuous
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.launch.serve import main
from repro_torch.models import build_model
from repro_torch.serve import ContinuousConfig, ContinuousServingEngine, ServeConfig, ServingEngine
from repro_torch.serve import slots as slot_ops
from repro_torch.serve.faults import EngineCrash, FaultInjector
from repro_torch.weights import from_jax_params

# (arch, extra config): Mixtral turns paging off by itself, LLaMA is asked to
ARCHS = {"mixtral_8x7b": {}, "llama31_8b": {"paged": False}}
SERVE = dict(max_seq=64, num_slots=2, chunk_size=8)
PROMPTS = [np.random.default_rng(3).integers(0, 256, size=n).astype(np.int32)
           for n in (5, 37, 12, 22)]
ARRIVALS, NEW = [0, 0, 2, 5], [6, 9, 5, 7]


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
def models():
    """Per arch: (JAX model, JAX params, port model, port cfg), float32."""
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        jm = jbuild(cfg)
        tcfg = dataclasses.replace(tget(arch), dtype="float32")
        out[arch] = (jm, jm.init(jax.random.PRNGKey(0)), build_model(tcfg, device="cpu"), tcfg)
    return out


def _policies(name):
    if name == "dense":
        return jpolicy.DENSE, tpolicy.DENSE
    return jpolicy.paper_policy(8, 16), tpolicy.paper_policy(8, 16)


def _submit(eng):
    for p, a, n in zip(PROMPTS, ARRIVALS, NEW):
        eng.submit(p, max_new_tokens=n, arrival=a)
    return eng


@pytest.fixture(scope="module")
def served(models):
    """The JAX engine's run per (arch, policy, fused), with the params."""
    out = {}
    for arch, extra in ARCHS.items():
        jm, params = models[arch][:2]
        for name in ("dense", "paper_8_16"):
            jpol = _policies(name)[0]
            jp = jprecompute(params, jpol)
            for fused in (True, False):
                eng = _submit(JContinuous(jm, jpol, JConfig(**SERVE, **extra,
                                                            fused_step=fused)))
                assert not eng.paged
                out[arch, name, fused] = (jax.tree_util.tree_map(np.asarray, jp), eng.run(jp))
    return out


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("name", ["dense", "paper_8_16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_slab_engine_matches_jax(models, served, arch, name, fused, use_kernels):
    tm, tcfg = models[arch][2:]
    params_np, jres = served[arch, name, fused]
    eng = _submit(ContinuousServingEngine(
        tm, _policies(name)[1].with_(use_kernels=use_kernels),
        ContinuousConfig(**SERVE, **ARCHS[arch], fused_step=fused)))
    assert not eng.paged and eng.pool is None and not eng.exec.paged_kernel
    res = eng.run(from_jax_params(tcfg, params_np, device="cpu"))
    assert res["outputs"] == jres["outputs"]
    assert res["metrics"]["paged"] == jres["metrics"]["paged"] == {"enabled": False}
    assert res["metrics"]["trace_counts"] == dict(jres["metrics"]["trace_counts"])
    for key in ("iterations", "dispatches", "generated_tokens"):
        assert res["metrics"][key] == jres["metrics"][key], key
    assert [r["done_iter"] for r in res["metrics"]["requests"]] == \
        [r["done_iter"] for r in jres["metrics"]["requests"]]
    cache = eng.exec.cache
    rows = 16 if arch == "mixtral_8x7b" else SERVE["max_seq"]
    assert "block_table" not in cache and cache["pos"].shape == (2,)
    assert all(leaf.shape[:2] == (2, rows) for layer in cache["layers"]
               for leaf in layer.values())


def test_full_cache_chunk_drops_the_rows_past_its_end(models):
    """A chunk whose valid rows run past a full-attention dense cache (16
    rows, chunks of 6, 6 and 8): the JAX package drops the rows past the end
    (its scatter's ``mode="drop"``), so every chunk's logits match JAX's; a
    wrap would overwrite the cache's first rows before the chunk attends."""
    jm, params, tm, tcfg = models["llama31_8b"]
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(5).integers(0, 256, size=(1, 20)).astype(np.int32)
    jc, tc = jm.init_cache(1, 16), tm.init_cache(1, 16, paged=False)
    for s, e in ((0, 6), (6, 12), (12, 20)):
        jl, jc = jm.prefill_chunk(params, {"tokens": jnp.asarray(toks[:, s:e])}, jc,
                                  policy=jpolicy.DENSE)
        tl, tc = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(toks[:, s:e])}, tc,
                                  policy=tpolicy.DENSE)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


CRASHES = [dict(site="decode", kind="crash", iters=tuple(range(4, 9)), limit=1),
           dict(site="prefill", kind="crash", iters=tuple(range(11, 15)), limit=1)]


def test_slab_crash_restore_resumes_token_identical(models, served):
    """EngineCrash mid-decode and mid-prefill on Mixtral's slab; each crashed
    engine dropped and a NEW one restored from the last auto-snapshot
    (which carries no pool): the stream ends with the undisturbed JAX run's
    tokens, as the JAX engine's restores do."""
    jm, params, tm, tcfg = models["mixtral_8x7b"]
    jres = served["mixtral_8x7b", "dense", True][1]

    def run(make, params, crash):
        eng, crashes, dead = _submit(make()), 0, []
        for _ in range(5):
            try:
                return eng, eng.run(params), crashes, dead
            except crash:
                crashes += 1
            snap = eng.last_snapshot
            assert snap["pool"] is None and snap["host_table"] is None
            dead.append(weakref.ref(eng))
            del eng
            eng = make()
            eng.restore(snap)
        raise AssertionError("engine never finished after restores")

    jinj = jfaults.FaultInjector(seed=0, schedule=CRASHES)
    _, jrun, jcrashes, _ = run(lambda: JContinuous(jm, jpolicy.DENSE, JConfig(
        **SERVE, snapshot_every=1), faults=jinj), params, jfaults.EngineCrash)
    inj = FaultInjector(seed=0, schedule=CRASHES)
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    gc.disable()
    try:
        eng, res, crashes, dead = run(lambda: ContinuousServingEngine(
            tm, tpolicy.DENSE, ContinuousConfig(**SERVE, snapshot_every=1), faults=inj),
            tp, EngineCrash)
        assert all(ref() is None for ref in dead), "a crashed engine is still alive"
    finally:
        gc.enable()
    assert crashes == jcrashes == 2 and eng.restores == 2
    assert res["outputs"] == jres["outputs"] == jrun["outputs"]
    assert res["metrics"]["lifecycle"]["restores"] == 2
    assert res["metrics"]["paged"] == {"enabled": False}


def test_slab_slot_helpers_work_in_place(models):
    """``slice_slot`` on the slab shares the layer tensors and names the
    slot; ``write_slot`` moves only ``pos``; ``reset_slot`` zeroes one
    slot's rows and sets its position."""
    tm = models["mixtral_8x7b"][2]
    cache = slot_ops.init_slot_cache(tm, 3, 40)
    for layer in cache["layers"]:
        for leaf in layer.values():
            leaf.fill_(1.0)
    slot = torch.tensor(1)
    sub = slot_ops.slice_slot(cache, slot)
    assert sub["layers"] is cache["layers"] and sub["slot"].tolist() == [1]
    sub["pos"] = torch.tensor(7, dtype=torch.int32)
    slot_ops.write_slot(cache, slot, sub)
    assert cache["pos"].tolist() == [0, 7, 0]
    slot_ops.reset_slot(cache, 2, pos=3)
    assert cache["pos"].tolist() == [0, 7, 3]
    k = cache["layers"][1]["k"]
    assert k.shape[:2] == (3, 16) and float(k[2].abs().max()) == 0.0
    assert float(k[:2].min()) == 1.0


@pytest.mark.parametrize("max_seq,chunk", [(64, 32), (12, 16)], ids=["window", "max_seq"])
def test_chunk_larger_than_the_ring_is_refused(models, max_seq, chunk):
    """A chunk must fit ``min(window, max_seq)`` ring rows (the JAX package
    asserts; the port raises ``ValueError``)."""
    tm = models["mixtral_8x7b"][2]
    with pytest.raises(ValueError, match="ring"):
        ContinuousServingEngine(tm, tpolicy.DENSE,
                                ContinuousConfig(max_seq=max_seq, num_slots=2, chunk_size=chunk))
    with pytest.raises(AssertionError):
        JContinuous(models["mixtral_8x7b"][0], jpolicy.DENSE,
                    JConfig(max_seq=max_seq, num_slots=2, chunk_size=chunk))


@pytest.mark.parametrize("name", ["dense", "paper_8_16"])
def test_one_shot_generate_on_the_rings_matches_jax(models, name):
    """Two 30-token prompts (window 16) and 6 new tokens: the JAX one-shot
    engine's greedy tokens; the port's cache is the dense ring layout."""
    jm, params, tm, tcfg = models["mixtral_8x7b"]
    jpol, tpol = _policies(name)
    jp = jprecompute(params, jpol)
    toks = np.random.default_rng(9).integers(0, 256, size=(2, 30)).astype(np.int32)
    want = np.asarray(JServingEngine(jm, jpol, JServeConfig(max_seq=40)).generate(
        jp, {"tokens": jnp.asarray(toks)}, 6)["tokens"])
    tp = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    out = ServingEngine(tm, tpol.with_(use_kernels=True), ServeConfig(max_seq=40)).generate(
        tp, {"tokens": torch.from_numpy(toks)}, 6)
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    assert "block_table" not in out["cache"]
    assert out["cache"]["layers"][0]["k"].shape == (2, 16, 2, 16)


# ------------------------------------------------------------------- the CLI

TRACE = ["--smoke", "--trace", "--num-requests", "4", "--rate", "0.7", "--len-range",
         "6:30", "--slots", "2", "--chunk", "8", "--new-tokens", "5"]


def _counters(out: str):
    """Per-request rows without the wall-clock column, and the ``#`` lines
    whose counters do not depend on the prompts' token values."""
    rows = [line.split(",")[:7] + line.split(",")[8:] for line in out.splitlines()
            if line and line[0].isdigit()]
    keep = [line.split("(")[0] for line in out.splitlines()
            if line.startswith(("# terminal states", "# traces", "# dispatches",
                                "# paged KV", "# prefix cache"))]
    return rows, keep


@pytest.mark.parametrize("flags", [["--arch", "llama31_8b", "--no-paged"],
                                   ["--arch", "mixtral_8x7b"],
                                   ["--arch", "mixtral_8x7b", "--no-fused-step"]],
                         ids=["llama-no-paged", "mixtral", "mixtral-legacy"])
def test_trace_cli_on_the_slab_matches_jax_cli(capsys, flags):
    """``--trace`` on the slab: rc 0 and the JAX CLI's counters, with
    ``# paged KV: disabled (dense per-slot slab)``."""
    assert jax_main(TRACE + flags) == 0
    want = capsys.readouterr().out
    assert main(TRACE + flags + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "# paged KV: disabled (dense per-slot slab)" in got
    assert _counters(got) == _counters(want)
    assert _counters(got)[0]


def test_one_shot_cli_on_mixtral(capsys):
    """One-shot mode on the Mixtral smoke config, prompts past the window:
    rc 0, both engines' lines and the agreement line."""
    assert main(["--arch", "mixtral_8x7b", "--device", "cpu", "--smoke", "--batch", "2",
                 "--prompt-len", "24", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "[     dense] generated (2, 4)" in out and "[amber 8:16] generated (2, 4)" in out
    assert "agreement dense vs sparse-prefill" in out
