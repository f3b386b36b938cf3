"""Sparsity policy: which linear projections get N:M-pruned, and how.

Mirror of ``repro/core/policy.py``: every field keeps its name and meaning
except ``use_pallas_kernels``, which becomes ``use_kernels`` and routes the
pruned projections and the paged KV scatter/attention onto the hand-written
Hopper kernels (``repro_torch.kernels``).  With ``use_kernels=True`` a CUDA
tensor reaches its kernel or the call raises; with ``use_kernels=False`` the
model runs its plain PyTorch path.

The paper's deployment policy (Experiments §Setup): sparsity only in the
prefill phase; k/v/o/up never pruned; down_proj pruned in every layer;
q_proj/gate_proj pruned except in a per-model skip list.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import FrozenSet, Mapping, Tuple

from repro_torch.core.scoring import SCORE_MODES

__all__ = ["SparsityPolicy", "DENSE", "paper_policy", "naive_policy"]

ATTN_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj")
MLP_PROJS = ("gate_proj", "up_proj", "down_proj")
ALL_PROJS = ATTN_PROJS + MLP_PROJS


@dataclasses.dataclass(frozen=True)
class SparsityPolicy:
    """Static description of the Amber Pruner deployment.

    Attributes:
      enabled:        master switch.
      n, m:           the N:M pattern (2:4, 4:8, 8:16).
      score_mode:     'naive' | 'wanda' | 'robust'.
      skip_modules:   projection names never pruned (any layer).
      skip_layers:    mapping module -> layer indices additionally skipped.
      phases:         phases in which sparsity is active.
      moe_plain_score: plain |X| scoring inside routed experts.
      tile_consensus: one shared N:M pattern per token tile (the ``nm_spmm``
                      kernel under ``use_kernels``).
      tile_size:      consensus tile size in tokens.
      use_kernels:    route pruned projections and paged KV traffic through
                      the Hopper kernels.
    """

    enabled: bool = True
    n: int = 8
    m: int = 16
    score_mode: str = "robust"
    skip_modules: Tuple[str, ...] = ("k_proj", "v_proj", "o_proj", "up_proj")
    skip_layers: Mapping[str, FrozenSet[int]] = dataclasses.field(
        default_factory=dict
    )
    phases: Tuple[str, ...] = ("prefill",)
    moe_plain_score: bool = True
    tile_consensus: bool = False
    tile_size: int = 256
    use_kernels: bool = False

    def __post_init__(self):
        if not (isinstance(self.n, numbers.Integral)
                and isinstance(self.m, numbers.Integral)
                and 0 < self.n <= self.m):
            raise ValueError(f"bad N:M {self.n}:{self.m}")
        if self.score_mode not in SCORE_MODES:
            raise ValueError(f"unknown score_mode {self.score_mode!r}; "
                             f"expected one of {SCORE_MODES}")
        if self.tile_size < 1:
            raise ValueError(f"tile_size must be >= 1, got {self.tile_size}")
        # freeze the mapping for hashability
        object.__setattr__(
            self,
            "skip_layers",
            tuple(sorted((k, tuple(sorted(v))) for k, v in dict(self.skip_layers).items())),
        )

    def _skips_for(self, module: str) -> Tuple[int, ...]:
        for name, idxs in self.skip_layers:  # type: ignore[attr-defined]
            if name == module:
                return idxs
        return ()

    def active(self, phase: str) -> bool:
        return self.enabled and phase in self.phases

    def should_prune(self, module: str, layer_idx: int | None = None) -> bool:
        """Static decision: is this projection pruned at this layer?"""
        if not self.enabled:
            return False
        if module in self.skip_modules:
            return False
        if layer_idx is not None and layer_idx in self._skips_for(module):
            return False
        return True

    def with_(self, **kw) -> "SparsityPolicy":
        cur = dataclasses.asdict(self)
        cur["skip_layers"] = dict(self.skip_layers)  # type: ignore[arg-type]
        cur.update(kw)
        return SparsityPolicy(**cur)


DENSE = SparsityPolicy(enabled=False)


def paper_policy(
    n: int = 8,
    m: int = 16,
    qgate_skip_layers: Tuple[int, ...] = (),
    score_mode: str = "robust",
    tile_consensus: bool = False,
    use_kernels: bool = False,
) -> SparsityPolicy:
    """The paper's deployment: Amber-P with q/gate layer skipping."""
    return SparsityPolicy(
        n=n,
        m=m,
        score_mode=score_mode,
        skip_modules=("k_proj", "v_proj", "o_proj", "up_proj"),
        skip_layers={
            "q_proj": frozenset(qgate_skip_layers),
            "gate_proj": frozenset(qgate_skip_layers),
        },
        tile_consensus=tile_consensus,
        use_kernels=use_kernels,
    )


def naive_policy(n: int, m: int) -> SparsityPolicy:
    """Naïve top-k baseline: |X| scores, prune everything, no skipping."""
    return SparsityPolicy(n=n, m=m, score_mode="naive", skip_modules=(), skip_layers={})
