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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.policy import DENSE, SparsityPolicy

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

    def _sample(self, logits: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    @torch.no_grad()
    def generate(self, params, batch: Dict[str, Any], max_new_tokens: int = 32
                 ) -> Dict[str, Any]:
        """``batch["tokens"]`` is ``(B, T_prompt)``.  Returns ``{"tokens":
        (B, max_new_tokens) int32, "cache": the filled cache}``."""
        dev = self.model.device
        prompts = torch.as_tensor(batch["tokens"], device=dev)
        b, t = prompts.shape
        if t + max_new_tokens > self.cfg.max_seq:
            raise ValueError(f"max_seq {self.cfg.max_seq} < {t} prompt + "
                             f"{max_new_tokens} new tokens")
        cache = self.model.init_cache(b, self.cfg.max_seq)
        logits, cache = self.model.prefill(params, {**batch, "tokens": prompts}, cache,
                                           policy=self.policy)
        gen = None
        if self.cfg.temperature > 0.0:
            gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
        cur = self._sample(logits, gen)
        out = [cur]
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        for _ in range(max_new_tokens - 1):
            logits, cache = self.model.decode_step(params, cur[:, None], cache,
                                                   policy=self.decode_policy)
            nxt = torch.where(done, cur, self._sample(logits, gen))
            done |= nxt == self.cfg.eos_token
            out.append(nxt)
            cur = nxt
        return {"tokens": torch.stack(out, dim=1), "cache": cache}
