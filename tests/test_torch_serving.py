"""The port's serving slice against the JAX package's, plus the port's guards.

Greedy token identity: the port's ``Engine`` and the JAX package's engine
(``use_pallas_kernels=False``) serve the same requests on the same weights
under DENSE, the paper's policy and its tile-consensus mode
(LLaMA-3.1 smoke config, float32) with the same config — staggered
arrivals, 2 slots, chunk 8, block size 8, a shared prompt prefix and a
half-size block pool that forces preemption — and must emit the same
tokens, on the port's plain path and through its kernel wrappers.
"""
import ast
import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

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
from repro.serve.continuous import ContinuousServingEngine as JContinuous
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.models import build_model
from repro_torch.serve import (ContinuousConfig, ContinuousServingEngine, Engine,
                               EngineConfig)
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
MAX_SEQ = 64
SLOTS, BS = 2, 8
HALF_POOL = SLOTS * MAX_SEQ // (2 * BS)
SERVE = dict(max_seq=MAX_SEQ, num_slots=SLOTS, chunk_size=8, block_size=BS,
             num_blocks=HALF_POOL)
POLICIES = {
    "dense": (jpolicy.DENSE, tpolicy.DENSE),
    "paper_8_16": (jpolicy.paper_policy(8, 16, (3,)), tpolicy.paper_policy(8, 16, (3,))),
    # the continuous engine under tile consensus (each prefill chunk is one
    # consensus tile); JAX documents that this mode is not token-identical
    # to one-shot prefill, so it is held to the JAX continuous engine
    "tile_consensus": (jpolicy.paper_policy(8, 16, (3,), tile_consensus=True),
                       tpolicy.paper_policy(8, 16, (3,), tile_consensus=True)),
}


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


def _traffic():
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, size=16)               # two full blocks
    prompts = [rng.integers(0, 256, size=n) for n in (5, 21, 13)]
    prompts += [np.concatenate([shared, rng.integers(0, 256, size=n)]) for n in (7, 11, 3)]
    arrivals = [0, 0, 2, 4, 7, 30]
    max_new = [8, 30, 6, 20, 24, 5]
    return prompts, arrivals, max_new


@pytest.fixture(scope="module")
def served():
    """JAX engine outputs per policy, computed once, with the weights."""
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    jm = jbuild(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    prompts, arrivals, max_new = _traffic()
    out = {}
    for name, (jpol, _) in POLICIES.items():
        jp = jprecompute(params, jpol)
        eng = JEngine.from_config(jm, JEngineConfig(serving=JConfig(**SERVE)), policy=jpol)
        for p, a, n in zip(prompts, arrivals, max_new):
            eng.submit(p, n, a)
        res = eng.run(jp)
        out[name] = (jax.tree_util.tree_map(np.asarray, jp), res)
    return out


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_engine_greedy_tokens_match_reference(served, name, use_kernels):
    params_np, jres = served[name]
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    model = build_model(tcfg, device="cpu")
    params = from_jax_params(tcfg, params_np, device="cpu")
    eng = Engine.from_config(model, EngineConfig(serving=ContinuousConfig(
        validate_pool=True, **SERVE)), policy=POLICIES[name][1].with_(
            use_kernels=use_kernels), device="cpu")
    prompts, arrivals, max_new = _traffic()
    for p, a, n in zip(prompts, arrivals, max_new):
        eng.submit(p, n, a)
    res = eng.run(params)
    assert res["outputs"] == jres["outputs"]
    jpg, pg = jres["metrics"]["paged"], res["metrics"]["paged"]
    assert pg["preemptions"] > 0 and pg["prefix_hits"] > 0, pg
    for key in ("preemptions", "prefix_hits", "tokens_skipped", "peak_blocks_in_use"):
        assert pg[key] == jpg[key], key
    assert eng.replica.pool.in_use == 0
    assert res["metrics"]["dispatches_per_iteration"] == 1.0
    assert set(res["metrics"]["buckets"]) == set(jres["metrics"]["trace_counts"])


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_trace_counts_match_reference(served, name):
    """The port's engine builds each step program once, as the JAX engine
    traces each once: equal ``trace_counts`` (every bucket the run used at
    1, preemption replays included), keys among ``declared_trace_keys()``,
    and the JAX engine's tokens."""
    from repro_torch.serve.executor import declared_trace_keys

    params_np, jres = served[name]
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    eng = ContinuousServingEngine(build_model(tcfg, device="cpu"),
                                  POLICIES[name][1].with_(use_kernels=True),
                                  ContinuousConfig(**SERVE))
    prompts, arrivals, max_new = _traffic()
    for p, a, n in zip(prompts, arrivals, max_new):
        eng.submit(p, n, a)
    res = eng.run(from_jax_params(tcfg, params_np, device="cpu"))
    assert res["outputs"] == jres["outputs"]
    got = res["metrics"]["trace_counts"]
    assert got == dict(jres["metrics"]["trace_counts"]) == eng.trace_counts
    assert set(got.values()) == {1} and set(got) <= set(declared_trace_keys())
    if name != "dense":                           # preemption replays a chunk
        assert "step_replay" in got or "step_replay_decode" in got


def _extend_into_emitted(eng, params, p0):
    """The first request, then a second whose prompt is the first's prompt
    and emitted tokens: (first's tokens, second's tokens, second's cached
    tokens)."""
    eng.submit(p0, max_new_tokens=8, arrival=0)
    first = eng.run(params)["outputs"][0]
    eng.clear()                                   # rids restart at 0
    eng.submit(np.concatenate([p0, np.asarray(first, np.int32)]), max_new_tokens=6,
               arrival=0)
    res = eng.run(params)
    return list(first), res["outputs"][0], res["metrics"]["requests"][0]["cached_tokens"]


def test_prefix_cache_does_not_share_across_the_emitted_boundary():
    """A prompt that extends into another request's emitted tokens, under
    ``paper_policy(2, 4)`` (block size 4, chunk 8): its 16 prompt tokens (4
    blocks) hit the prefix cache, and the emitted region's blocks, whose KV
    was written by dense decode, miss under the dense-row salt of
    ``serve/paged.py:chain_block_hashes``.  Both engines run on
    ``precompute_scales`` params; the port's tokens and cached count are the
    JAX engine's."""
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    jm = jbuild(cfg)
    jpol = jpolicy.paper_policy(2, 4, cfg.qgate_skip_layers)
    sparams = jprecompute(jm.init(jax.random.PRNGKey(0)), jpol)
    p0 = np.random.default_rng(120).integers(0, cfg.vocab_size, size=16).astype(np.int32)
    conf = dict(max_seq=MAX_SEQ, num_slots=2, chunk_size=8, block_size=4, validate_pool=True)
    want = _extend_into_emitted(JContinuous(jm, jpol, JConfig(**conf)), sparams, p0)
    assert want[2] == 16
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    tpol = tpolicy.paper_policy(2, 4, tcfg.qgate_skip_layers)
    for uk in (False, True):
        eng = ContinuousServingEngine(build_model(tcfg, device="cpu"), tpol.with_(use_kernels=uk),
                                      ContinuousConfig(**conf))
        params = from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, sparams), device="cpu")
        got = _extend_into_emitted(eng, params, p0)
        assert got == want, uk
        assert eng.pool.in_use == 0


def test_engine_generate_and_dp_tp_guard():
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    model = build_model(tcfg, device="cpu")
    params = model.init(0)
    eng = Engine.from_config(model, EngineConfig(serving=ContinuousConfig(
        max_seq=32, num_slots=2, chunk_size=8)), device="cpu")
    outs = eng.generate(params, [np.arange(5), np.arange(9)], max_new_tokens=3)
    assert [len(o) for o in outs] == [3, 3]
    # dp > 1 serves the same tokens through the router; tp > 1 needs an
    # initialised group of tp ranks and raises up front outside one
    # (tests/test_torch_tp.py serves it)
    eng = Engine.from_config(model, EngineConfig(dp=2, serving=ContinuousConfig(
        max_seq=32, num_slots=2, chunk_size=8)), device="cpu")
    assert eng.generate(params, [np.arange(5), np.arange(9)], max_new_tokens=3) == outs
    assert len(eng.replicas) == 2
    for dp, tp in ((1, 2), (2, 2)):
        with pytest.raises(ValueError, match="none is initialised"):
            Engine.from_config(model, EngineConfig(dp=dp, tp=tp), device="cpu")


def test_engine_cancel_and_temperature_sampling():
    """A cancelled request ends ``cancelled`` and frees its blocks; sampling
    at temperature > 0 is reproducible from the config's seed and stays in
    the vocabulary."""
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    model = build_model(tcfg, device="cpu")
    params = model.init(0)
    prompts = [np.arange(7), np.arange(3, 15)]
    outs = []
    for _ in range(2):
        eng = Engine.from_config(model, EngineConfig(serving=ContinuousConfig(
            max_seq=32, num_slots=2, chunk_size=8, temperature=0.8, seed=3)),
            device="cpu")
        rids = [eng.submit(p, 6) for p in prompts]
        doomed = eng.submit(np.arange(9), 6, arrival=2)
        assert eng.cancel(doomed)
        res = eng.run(params)
        states = {r["rid"]: r["state"] for r in res["metrics"]["requests"]}
        assert states[doomed] == "cancelled" and res["outputs"][doomed] == []
        assert eng.replica.pool.in_use == 0
        outs.append([res["outputs"][r] for r in rids])
    assert outs[0] == outs[1]
    assert all(len(o) == 6 and all(0 <= t < tcfg.vocab_size for t in o) for o in outs[0])


# --------------------------------------------------------------- guards

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    """AST scan: no module of the port, and not chip_smoke.py, imports
    ``jax`` or anything of ``repro`` — at top level or inside a function."""
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts).replace(".__init__", "")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m.rstrip('.'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tget("llama31_8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tcfg, device="cuda")
    model = build_model(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine.from_config(model)
    Engine.from_config(model, device="cpu")
    # the modality families: build_model, Engine.run with extras, and the
    # one-shot engine with frame embeddings, for a model on the GPU
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServingEngine

    for arch in ("whisper_medium", "qwen2_vl_2b"):
        for cfg in (get_config(arch), tget(arch)):
            with pytest.raises(RuntimeError, match="CUDA"):
                build_model(cfg)
    wcfg = tget("whisper_medium")
    on_gpu = Model(cfg=wcfg, device=torch.device("cuda"))
    fe = np.zeros((1, wcfg.encoder_seq, wcfg.d_model), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(ContinuousServingEngine(on_gpu, tpolicy.DENSE), EngineConfig()).run(
            None, extras={0: {"frame_embeds": fe}})
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(on_gpu, tpolicy.DENSE).generate(
            None, {"tokens": np.zeros((1, 4), np.int64), "frame_embeds": fe}, 2)


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without a CUDA device — and in a directory holding nothing of the
    repository but the script — chip_smoke.py exits non-zero and prints no
    result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


# ------------------------------------------------- chip_smoke profile families

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cuda_kernels():
    """(source stem, kernel name) of every ``__global__`` function, in the
    sources and in the shared headers."""
    out = []
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                               src.read_text()):
            out.append((src.stem, name))
    return out


# the profile family of each kernel source; the scatter of the paged file is
# a family of its own
_FAMILY_OF_SOURCE = {"flash_attention": "flash_attention", "nm_spmm": "nm_spmm",
                     "nm_prune_matmul": "nm_prune_matmul", "osparse_matmul": "osparse_matmul",
                     "paged_attention": "paged_attention"}


@pytest.mark.parametrize("stem,name", _cuda_kernels(), ids=lambda v: v)
def test_profile_family_of_every_cuda_kernel(stem, name):
    """chip_smoke.py's profiles put every kernel of the port under its own
    family, whatever the profiler's decoration of the name (template
    arguments, signature), and whatever other kernel's name holds it."""
    cs = _chip_smoke()
    # a kernel of a shared header may belong to any family, but to one
    want = "paged_kv_scatter" if name == "paged_kv_scatter_kernel" else _FAMILY_OF_SOURCE.get(stem)
    for key in (name, f"void {name}<128>(int, float)",
                f"void (anonymous namespace)::{name}<__nv_bfloat16>(__nv_bfloat16 const*)"):
        got = cs.kernel_family(key)
        assert got == want if want is not None else got in {f for f, _ in cs.FAMILIES}, key


def test_profile_busy_time_counts_overlap_once():
    """Device busy time is the union of kernel intervals: a kernel launched
    early that waits on another overlaps it and is not counted twice."""
    cs = _chip_smoke()
    assert cs.busy_time([]) == 0.0
    assert cs.busy_time([(0.0, 10.0), (2.0, 12.0), (20.0, 25.0), (21.0, 22.0)]) == 17.0
    assert cs.busy_time(iter([(5.0, 6.0), (0.0, 1.0)])) == 2.0


def test_profile_family_of_library_and_other_kernels():
    cs = _chip_smoke()
    assert len(_cuda_kernels()) >= 15
    assert cs.kernel_family("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64") \
        == "cuBLAS GEMM"
    assert cs.kernel_family("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT") == "cuBLAS GEMM"
    assert cs.kernel_family("void at::native::vectorized_elementwise_kernel<4>(int)") == cs.OTHER
