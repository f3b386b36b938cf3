"""Roofline terms of one rank's step, counted on ``meta`` tensors, against
the H100 (port of ``repro/launch/roofline.py``).

The reference reads XLA's ``cost_analysis()`` of a compiled cell and
regexes its collectives out of the HLO text.  The port has no compiler: it
executes one rank's share of the step on ``meta`` tensors (a dry rank,
``distributed.sharding.Mesh.at``) under :func:`count_step`, a
``TorchDispatchMode`` that sees every op that runs, and counts:

* **operations, by class**: the products' operations (``torch.utils.
  flop_counter``'s formulas: mm, addmm, bmm, baddbmm, SDPA; and the grouped
  product, ``2·R·K·N``), each in the class of its operands: ``bf16``
  (bf16 or fp16), ``fp32`` (float32 and float64, outside the tensor cores)
  or ``int8``; elementwise ops are not counted (their bytes are
  intermediates);
* **compulsory HBM bytes**: each byte the step reads of a tensor that
  existed before it, once; each byte it leaves behind (the outputs, and the
  extent written in place into a donated cache or state), once; each
  collective's result, once written and once read; a gather (embedding,
  ``index_select``) reads at most the rows it returns, and a view reads
  nothing (its readers count).  Intermediates are not counted.  This is a
  lower bound, as a roofline's bytes are (a byte that must move), not
  XLA's "bytes accessed", which counts every operand of every fused op;
* **peak live bytes**: the arguments plus the most that the step's own
  tensors held at once (each result's storage followed to its end through
  ``weakref.finalize``): the counterpart of XLA's ``temp``.

Each hand kernel (``kernels.KERNELS``) is one unit on ``meta``
(``kernels/_meta.py``): its plain version never runs, its operands are read
once and its result written once, and it counts the products its inputs
need (per-token N:M the kept ``D·N/M`` of each row, ``nm_spmm`` its
compacted product, the int8 GEMMs int8 operations), so a kernel's bound is
the same whatever implements it.

Rates (:class:`HW`): the H100 SXM data sheet, dense: 989e12 FLOP/s bf16,
67e12 FLOP/s fp32 outside the tensor cores, 1979e12 OP/s int8, 3.35e12 B/s
HBM; NVLink 450e9 B/s one way inside an 8-GPU node, and 50e9 B/s a GPU
between nodes (400 Gb/s NDR).  A collective whose group lies in one node
(8 consecutive ranks) moves at the NVLink rate, a wider one at the
network's.  Collective traffic is the reference's ring model: all-reduce
2 × its result, all-gather 1 ×, reduce-scatter (g − 1) ×, all-to-all and
point-to-point 1 ×.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _meta

__all__ = ["RATES", "card_rates", "HW", "StepCount", "count_step", "collective_bytes",
           "model_flops", "RooflineReport", "analyze", "CLASSES"]

# data-sheet rates (dense): bytes/s, bf16 FLOP/s, fp32 (non-tensor) FLOP/s,
# int8 tensor-core OP/s
RATES = {
    "PCIe": (2.0e12, 756e12, 51e12, 1513e12),
    "NVL": (3.9e12, 835e12, 60e12, 1670e12),
    "SXM": (3.35e12, 989e12, 67e12, 1979e12),
}
CLASSES = ("bf16", "fp32", "int8")


def card_rates(name: str):
    """The data-sheet rates of the H100 named ``name`` (SXM unless the name
    says PCIe or NVL)."""
    for key in ("PCIe", "NVL"):
        if key in name:
            return RATES[key]
    return RATES["SXM"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One H100 SXM and its links (module docstring)."""
    hbm_bw: float = RATES["SXM"][0]
    peak_bf16: float = RATES["SXM"][1]
    peak_fp32: float = RATES["SXM"][2]
    peak_int8: float = RATES["SXM"][3]
    nvlink_bw: float = 450e9
    net_bw: float = 50e9
    node: int = 8

    @classmethod
    def for_card(cls, name: str) -> "HW":
        bw, bf16, fp32, int8 = card_rates(name)
        return cls(hbm_bw=bw, peak_bf16=bf16, peak_fp32=fp32, peak_int8=int8)

    def peak(self, cls: str) -> float:
        return {"bf16": self.peak_bf16, "fp32": self.peak_fp32, "int8": self.peak_int8}[cls]


# ------------------------------------------------------------ the counter

def _grouped_mm_flop(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """``torch._grouped_mm(x (R, K), w (G, K, N), offs)``: each row meets one
    group's weight.  Its backward's two forms count the same ``2·R·K·N``:
    ``dX`` is ``(dY (R, N), wᵀ (G, N, K))``, ``dW`` the 2-D × 2-D
    ``(Xᵀ (K, R), dY (R, N))`` with the offsets along R."""
    return 2 * x_shape[0] * x_shape[-1] * w_shape[-1]


_FLOPS = dict(flop_counter.flop_registry)
_FLOPS[torch.ops.aten._grouped_mm] = flop_counter.shape_wrapper(_grouped_mm_flop)


# ops that read only the rows they gather of their first operand: it counts
# at most their output's bytes
_GATHERS = {torch.ops.aten.embedding, torch.ops.aten.index_select, torch.ops.aten.gather,
            torch.ops.aten.index}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class StepCount:
    """What :func:`count_step` counted (module docstring)."""
    ops: Dict[str, float]
    read_bytes: float
    write_bytes: float
    collectives: List[Tuple[str, int, int, Tuple[str, ...]]]
    args_bytes: float
    peak_live_bytes: float
    output_bytes: float
    units: List[Dict[str, Any]]

    @property
    def flops(self) -> float:
        return float(sum(self.ops.values()))

    @property
    def coll_result_bytes(self) -> float:
        return float(sum(r[1] for r in self.collectives))

    @property
    def hbm_bytes(self) -> float:
        return self.read_bytes + self.write_bytes + 2 * self.coll_result_bytes

    @property
    def peak_bytes(self) -> float:
        return self.args_bytes + self.peak_live_bytes

    def unit_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for u in self.units:
            out[u["kernel"]] = out.get(u["kernel"], 0) + 1
        return out


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = dict.fromkeys(CLASSES, 0)
        self.made: set = set()           # storages the step made
        self.seen: Dict[int, tuple] = {}     # read: storage → (views, bytes, storage)
        self.written: Dict[int, tuple] = {}  # written in place
        self.read_bytes = 0
        self.write_bytes = 0
        self.live = 0
        self.peak = 0
        self.units: List[Dict[str, Any]] = []

    # a pre-existing storage's bytes through a view, each view once, capped
    # at the storage's size; the book holds the storage, so that no storage
    # made later (a constant the step lifts) takes its address
    def _touch(self, book: Dict, t: torch.Tensor, nbytes: Optional[int] = None) -> int:
        key = _key(t)
        if key in self.made:
            return 0
        storage = t.untyped_storage()
        views, total, _ = book.get(key, (set(), 0, storage))
        sig = (t.storage_offset(), tuple(t.shape), tuple(t.stride()), nbytes)
        if sig in views:
            return 0
        views.add(sig)
        add = min(_nbytes(t) if nbytes is None else nbytes, storage.nbytes() - total)
        book[key] = (views, total + add, storage)
        return add

    def _made(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self.made:
            return
        self.made.add(key)
        storage = t.untyped_storage()
        n = storage.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        # the storage, not the tensor: an alias (a view, ``detach``) keeps it
        weakref.finalize(storage, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self.made.discard(key)

    def unit(self, kernel, reads, outs, ops, wrote) -> None:
        nbytes = 0
        for r in reads:
            t, n = r if isinstance(r, tuple) else (r, None)
            self.read_bytes += self._touch(self.seen, t, n)
            nbytes += _nbytes(t) if n is None else n
        for o in outs:
            nbytes += _nbytes(o)
        nbytes += wrote
        self.write_bytes += wrote
        for cls, n in ops.items():
            self.ops[cls] += n
        self.units.append({"kernel": kernel, "bytes": nbytes, "ops": dict(ops)})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        flop = _FLOPS.get(func._overloadpacket)
        if flop is not None:
            first = next(a for a in tree_flatten((args, kwargs))[0]
                         if isinstance(a, torch.Tensor))
            self.ops[_meta.product_class(first.dtype)] += flop(*args, **kwargs, out_val=out)
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns):
            return out              # a view reads nothing; its readers count
        written = set()
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in tree_flatten(val)[0]:
                if isinstance(t, torch.Tensor):
                    written.add(id(t))
                    self.write_bytes += self._touch(self.written, t)
        cap = _nbytes(out) if func._overloadpacket in _GATHERS else None
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor) and id(t) not in written:
                self.read_bytes += self._touch(self.seen, t, cap and min(cap, _nbytes(t)))
                cap = None          # the gathered operand is the first
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for ret, o in zip(schema.returns, outs):
            if isinstance(o, torch.Tensor) and ret.alias_info is None:
                self._made(o)
        return out


def _unique_bytes(tree) -> int:
    seen, n = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and _key(t) not in seen:
            seen.add(_key(t))
            n += t.untyped_storage().nbytes()
    return n


def _leaves(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def count_step(fn, *args, args_bytes: Optional[float] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` (on ``meta`` tensors: nothing is
    allocated) under the counter → ``(result, StepCount)``.  ``args_bytes``:
    the arguments' bytes (default: the unique storages of ``args``' tensors,
    modules' parameters and buffers included)."""
    from repro_torch.distributed import sharding

    counter = _Counter()
    prev, _meta._sink = _meta._sink, counter.unit
    try:
        with sharding.recording() as log, counter:
            out = fn(*args, **kwargs)
    finally:
        _meta._sink = prev
    outputs = _leaves(out)
    left = 0
    seen = set()
    for t in outputs:
        key = _key(t)
        if key in counter.made and key not in seen:
            seen.add(key)
            left += t.untyped_storage().nbytes()
    if args_bytes is None:
        args_bytes = _unique_bytes(_leaves(list(args) + list(kwargs.values())))
    return out, StepCount(ops=dict(counter.ops), read_bytes=float(counter.read_bytes),
                          write_bytes=float(counter.write_bytes + left),
                          collectives=list(log), args_bytes=float(args_bytes),
                          peak_live_bytes=float(counter.peak),
                          output_bytes=float(_unique_bytes(outputs)), units=counter.units)


# ------------------------------------------------------- the reference's terms

_FACTORS = {"all-reduce": lambda g: 2.0, "all-gather": lambda g: 1.0,
            "reduce-scatter": lambda g: float(max(g - 1, 1)), "all-to-all": lambda g: 1.0,
            "collective-permute": lambda g: 1.0, "gather-to-root": lambda g: 1.0}


def _kind(kind: str) -> str:
    return kind.replace("_", "-")


def _in_node(record, mesh, hw: HW) -> bool:
    _, _, size, axes = record
    if mesh is not None and axes:
        members = mesh.members(tuple(axes), mesh.rank or 0)
        return len({r // hw.node for r in members}) == 1
    return size <= hw.node


def collective_bytes(records, mesh=None, hw: HW = HW()) -> Dict[str, float]:
    """Ring-model per-device traffic by collective kind from a dry rank's
    records ``(kind, result bytes, group size, axes)`` (the reference's
    factors), with ``"total"``, and the seconds that traffic takes
    (``"seconds"``: inside a node over NVLink, else the network; ``mesh``
    places a record's group on its ranks)."""
    out: Dict[str, float] = {}
    seconds = 0.0
    links: Dict[tuple, float] = {}      # (size, axes) → the group's rate
    for rec in records:
        kind, nbytes, size, axes = rec
        kind = _kind(kind)
        moved = nbytes * _FACTORS[kind](size)
        out[kind] = out.get(kind, 0.0) + moved
        if (size, axes) not in links:
            links[size, axes] = hw.nvlink_bw if _in_node(rec, mesh, hw) else hw.net_bw
        seconds += moved / links[size, axes]
    out["total"] = sum(out.values())
    out["seconds"] = seconds
    return out


def model_flops(cfg, tokens: int, kind: str) -> float:
    """Analytic useful FLOPs: 6·N·D train / 2·N·D inference (N = active)."""
    n = cfg.n_active_params() if cfg.n_experts else cfg.n_params()
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * n * tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_total: float
    peak_mem_bytes: Optional[float] = None
    ops_per_dev: Optional[Dict[str, float]] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The least time the step can take: the largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted operations — remat/redundancy waste."""
        return self.model_flops_total / max(self.flops_per_dev, 1.0)

    def row(self, n_dev: int) -> str:
        useful = self.model_flops_total / max(self.flops_per_dev * n_dev, 1.0)
        return (
            f"{self.arch:24s} {self.shape:12s} {self.mesh:9s} "
            f"{self.compute_s:10.3e} {self.memory_s:10.3e} "
            f"{self.collective_s:10.3e} {self.dominant:10s} "
            f"{useful:8.3f}"
        )


def analyze(arch: str, shape_name: str, mesh_name: str, count: StepCount, cfg, kind: str,
            tokens: int, hw: HW = HW(), mesh=None) -> RooflineReport:
    """The roofline terms of a step's :class:`StepCount` on ``hw``: compute
    the operations of each class over its peak, summed; memory the
    compulsory bytes over the HBM rate; collective the ring traffic over
    its link."""
    coll = collective_bytes(count.collectives, mesh, hw)
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name,
        flops_per_dev=count.flops, bytes_per_dev=count.hbm_bytes,
        coll_bytes_per_dev=coll["total"],
        compute_s=sum(count.ops[c] / hw.peak(c) for c in CLASSES),
        memory_s=count.hbm_bytes / hw.hbm_bw,
        collective_s=coll["seconds"],
        model_flops_total=model_flops(cfg, tokens, kind),
        peak_mem_bytes=count.peak_bytes, ops_per_dev=dict(count.ops))
