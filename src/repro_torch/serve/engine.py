"""One-shot batched serving engine (port of ``repro/serve/engine.py``):
Amber-sparse prefill of the whole batch, then dense decode::

    engine = ServingEngine(model, policy, ServeConfig(max_seq=640))
    out = engine.generate(params, {"tokens": prompts}, max_new_tokens=32)

Every request of the batch arrives together: one :func:`~repro_torch.
models.transformer.prefill` over all rows (under the policy — with
``tile_consensus`` and ``use_kernels`` the pruned projections are
``nm_spmm`` launches and, with ``attn_impl="flash"``, the attention is a
``flash_attention`` launch), then ``max_new_tokens - 1`` decode steps with
an EOS ``done`` mask.  Decode runs dense under
``DENSE.with_(use_kernels=policy.use_kernels)``, so with the kernels on the
KV write and read are the paged kernels.  Greedy output (temperature 0)
equals the JAX package's; temperature sampling draws from an explicit
``torch.Generator`` seeded from the config.  Asynchronous arrivals go
through :class:`~repro_torch.serve.continuous.ContinuousServingEngine`.

The counterparts of the JAX engine's jitted prefill and compiled decode
loop are CUDA graphs (``kernels/_capture.Programs``): one prefill graph per
prompt shape ``(B, T)`` and one decode-step graph per ``B``, each captured
after its first (eager) call and replayed from then on, ``max_new_tokens -
1`` times a call for the decode step.  They run on a cache the engine keeps
per ``B`` (``generate`` returns it; the next call with that ``B`` reuses
it), on fixed prompt and current-token buffers, and update the cache's
``pos`` in place; sampling and the EOS ``done`` mask run after each graph,
on its logits.  ``trace_counts`` counts the captures (``prefill_BxT``,
``decode_B``; on the CPU, where the programs run as they are, first uses).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.policy import DENSE, SparsityPolicy
from repro_torch.kernels import _capture

__all__ = ["ServeConfig", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 512
    temperature: float = 0.0       # 0 → greedy
    eos_token: int = -1            # -1 → never stop early
    seed: int = 0


class ServingEngine:
    def __init__(self, model, policy: SparsityPolicy = DENSE,
                 cfg: ServeConfig = ServeConfig()):
        self.model = model
        self.policy = policy
        self.cfg = cfg
        self.decode_policy = DENSE.with_(use_kernels=policy.use_kernels)
        self._graphs = _capture.Programs(model.device)
        self._state: Dict[int, Dict[str, Any]] = {}    # B → cache and input buffers

    @property
    def trace_counts(self) -> Dict[str, int]:
        return self._graphs.trace_counts

    def _buffers(self, b: int, t: int) -> Dict[str, Any]:
        """The cache and the fixed int32 input buffers of batch size ``b``
        (prompts of ``t`` tokens, current tokens)."""
        dev = self.model.device
        st = self._state.get(b)
        if st is None:
            st = self._state[b] = {
                "cache": self.model.init_cache(b, self.cfg.max_seq),
                "cur": torch.zeros((b,), dtype=torch.int32, device=dev), "prompts": {}}
        if t not in st["prompts"]:
            st["prompts"][t] = torch.zeros((b, t), dtype=torch.int32, device=dev)
        return st

    def _sample(self, logits: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    @torch.no_grad()
    def generate(self, params, batch: Dict[str, Any], max_new_tokens: int = 32
                 ) -> Dict[str, Any]:
        """``batch["tokens"]`` is ``(B, T_prompt)``.  Returns ``{"tokens":
        (B, max_new_tokens) int32, "cache": the filled cache}`` (the
        engine's cache of batch size B, rewritten by its next call with
        that B)."""
        dev = self.model.device
        prompts = torch.as_tensor(batch["tokens"], device=dev)
        b, t = prompts.shape
        if t + max_new_tokens > self.cfg.max_seq:
            raise ValueError(f"max_seq {self.cfg.max_seq} < {t} prompt + "
                             f"{max_new_tokens} new tokens")
        st = self._buffers(b, t)
        cache, cur, static = st["cache"], st["cur"], st["prompts"][t]
        model = self.model

        def prefill():
            logits, new = model.prefill(params, {"tokens": static}, cache, policy=self.policy)
            cache["pos"].copy_(new["pos"])
            return logits

        def decode():
            logits, new = model.decode_step(params, cur[:, None], cache,
                                            policy=self.decode_policy)
            cache["pos"].copy_(new["pos"])
            return logits

        cache["pos"].zero_()
        static.copy_(prompts)
        logits = self._graphs.run(f"prefill_{b}x{t}", prefill, params)
        gen = None
        if self.cfg.temperature > 0.0:
            gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
        cur.copy_(self._sample(logits, gen))
        out = [cur.clone()]
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        for _ in range(max_new_tokens - 1):
            logits = self._graphs.run(f"decode_{b}", decode, params)
            nxt = torch.where(done, cur, self._sample(logits, gen))
            done |= nxt == self.cfg.eos_token
            out.append(nxt)
            cur.copy_(nxt)
        return {"tokens": torch.stack(out, dim=1), "cache": cache}
