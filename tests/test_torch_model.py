"""The port's dense transformer against the JAX package's on the LLaMA-3.1
smoke config in float32: the same weights (carried with ``from_jax_params``)
and the same tokens must give allclose logits for the full-sequence pass,
chunked prefill at offsets (with a padded last chunk) and decode, under
DENSE and the paper's policies, on the plain path and through the kernel
wrappers (their plain versions on the CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config
from repro.core import policy as jpolicy
from repro.core.pruner import precompute_scales as jprecompute
from repro.models import build_model as jbuild
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import policy as tpolicy
from repro_torch.models import build_model
from repro_torch.weights import from_jax_params

# float32 logits; differences are summation order only
TOL = dict(rtol=1e-4, atol=1e-4)
POLICIES = {
    "dense": (jpolicy.DENSE, tpolicy.DENSE),
    "paper_8_16": (jpolicy.paper_policy(8, 16, (3,)), tpolicy.paper_policy(8, 16, (3,))),
    "paper_2_4": (jpolicy.paper_policy(2, 4, (3,)), tpolicy.paper_policy(2, 4, (3,))),
}


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")
    tcfg = dataclasses.replace(tget("llama31_8b"), dtype="float32")
    jm = jbuild(cfg)
    return cfg, tcfg, jm, jm.init(jax.random.PRNGKey(0))


PROMPT = np.random.default_rng(2).integers(0, 256, size=21)   # 3 chunks of 8
TOKS = np.random.default_rng(1).integers(0, 256, size=(2, 19))


def _chunks():
    """(tokens (1, 8), chunk_len) — the last chunk padded."""
    for s in range(0, len(PROMPT), 8):
        part = PROMPT[s:s + 8]
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :len(part)] = part
        yield chunk, len(part)


@pytest.fixture(scope="module")
def reference(smoke):
    """JAX logits per policy, computed once: forward, each prefill chunk,
    and four greedy decode steps (with the tokens they fed)."""
    cfg, tcfg, jm, params = smoke
    out = {}
    for name, (jpol, _) in POLICIES.items():
        jp = jprecompute(params, jpol)
        fwd = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(TOKS)}, policy=jpol,
                                    phase="prefill"))
        cache, chunks, steps = jm.init_cache(1, 48), [], []
        for chunk, clen in _chunks():
            jl, cache = jm.prefill_chunk(
                jp, {"tokens": jnp.asarray(chunk), "chunk_len": jnp.asarray(clen, jnp.int32)},
                cache, policy=jpol)
            chunks.append(np.asarray(jl))
        assert int(cache["pos"]) == len(PROMPT)
        for _ in range(4):
            tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
            jl, cache = jm.decode_step(jp, jnp.asarray(tok), cache, policy=jpol)
            steps.append((tok, np.asarray(jl)))
        out[name] = (jax.tree_util.tree_map(np.asarray, jp), fwd, chunks, steps)
    return out


def _port(smoke, reference, name, use_kernels):
    tcfg = smoke[1]
    params_np = reference[name][0]
    tpol = POLICIES[name][1].with_(use_kernels=use_kernels)
    return (build_model(tcfg, device="cpu"), from_jax_params(tcfg, params_np, device="cpu"),
            tpol)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_forward_logits_match(smoke, reference, name, use_kernels):
    tm, tp, tpol = _port(smoke, reference, name, use_kernels)
    got = tm.forward(tp, {"tokens": torch.from_numpy(TOKS)}, policy=tpol).numpy()
    np.testing.assert_allclose(got, reference[name][1], **TOL)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_prefill_chunk_and_decode_logits_match(smoke, reference, name, use_kernels):
    """A 21-token prompt in chunks of 8 (the last padded, chunk_len 5) then
    four greedy decode steps, chunk by chunk and step by step."""
    tm, tp, tpol = _port(smoke, reference, name, use_kernels)
    _, _, chunks, steps = reference[name]
    cache = tm.init_cache(1, 48, block_size=8)
    for (chunk, clen), want in zip(_chunks(), chunks):
        tl, cache = tm.prefill_chunk(
            tp, {"tokens": torch.from_numpy(chunk),
                 "chunk_len": torch.tensor(clen, dtype=torch.int32)}, cache, policy=tpol)
        np.testing.assert_allclose(tl.numpy(), want, **TOL)
    assert int(cache["pos"]) == len(PROMPT)
    for tok, want in steps:
        assert int(torch.argmax(tl, dim=-1)[0]) == int(tok[0, 0])
        tl, cache = tm.decode_step(tp, torch.from_numpy(tok), cache, policy=tpol)
        np.testing.assert_allclose(tl.numpy(), want, **TOL)


def test_bf16_weights_round_trip_exactly(smoke):
    """bf16 arrays reach the port through float32: bf16 → f32 → bf16 is exact."""
    cfg, tcfg, jm, params = smoke
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = jbuild(cfg16).init(jax.random.PRNGKey(0))
    pn = jax.tree_util.tree_map(np.asarray, p16)
    tp = from_jax_params(dataclasses.replace(tcfg, dtype="bfloat16"), pn, device="cpu")
    assert tp.embed.w.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp.embed.w.float().numpy(),
                                  pn["embed"]["w"].astype(np.float32))
    np.testing.assert_array_equal(tp.blocks[2].mlp.down_proj.w.float().numpy(),
                                  pn["periods"]["b0"]["mlp"]["down_proj"]["w"][2]
                                  .astype(np.float32))


def test_unported_configs_raise():
    tcfg = tget("llama31_8b")
    for kw in (dict(attn_type="swa"), dict(family="moe", n_experts=4, top_k=2),
               dict(rope_variant="2d")):
        with pytest.raises(NotImplementedError):
            build_model(dataclasses.replace(tcfg, **kw), device="cpu")
    build_model(dataclasses.replace(tcfg, attn_impl="flash"), device="cpu")
