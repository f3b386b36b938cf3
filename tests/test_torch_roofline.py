"""The port's roofline (``repro_torch.launch.roofline``), ``perf`` and
``report``, held to the JAX package's ``repro/launch/`` where the function
is the same: ``model_flops`` for every config and kind, the ring factors of
``collective_bytes`` (the port reads a dry rank's records, the reference
HLO text written from the same collectives), ``RooflineReport``'s row,
``perf``'s variants and ``report``'s skipped and FAIL rows.  The counter's
own rules are checked by hand: a product's operations by class, the
compulsory bytes, the peak, and each hand kernel as one unit on ``meta``
whose plain version never runs.

``repro.launch.perf`` sets ``XLA_FLAGS`` when imported; the test restores
it at once (JAX reads it when its backend starts, which nothing does in
between).
"""
import dataclasses
import os
from pathlib import Path

import pytest
import torch

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import PAPER_ARCH_IDS as J_PAPER_ARCH_IDS
from repro.configs.base import get_config as jget
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro_torch.configs.base import ARCH_IDS, PAPER_ARCH_IDS, get_config
from repro_torch.kernels import _meta as kmeta
from repro_torch.kernels import ops
from repro_torch.kernels import nm_prune_matmul as knm
from repro_torch.kernels import nm_spmm as kns
from repro_torch.kernels import osparse_matmul as kos
from repro_torch.launch import perf, report, roofline
from repro_torch.launch.mesh import abstract_mesh

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(ARCH_IDS) + list(PAPER_ARCH_IDS)
KINDS = ("train", "prefill", "decode")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (the suite runs six
    workers); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_same_thirteen_archs():
    assert ARCHS == list(J_ARCH_IDS) + list(J_PAPER_ARCH_IDS) and len(ARCHS) == 13


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_jax(arch, kind):
    tokens = 4096 * 7
    assert roofline.model_flops(get_config(arch), tokens, kind) == \
        jroofline.model_flops(jget(arch), tokens, kind)


# (kind, result dtype and shape, group size): each written as a record and as
# the HLO line the reference's regex reads
COLLECTIVES = [
    ("all-reduce", "f32", (8, 128), 4),
    ("all-gather", "bf16", (16, 4096), 16),
    ("reduce-scatter", "f32", (1024,), 8),
    ("reduce-scatter", "bf16", (64, 64), 2),
    ("all-to-all", "bf16", (32, 256), 4),
    ("collective-permute", "s8", (4096,), 2),
]
_ITEM = {"f32": 4, "bf16": 2, "s8": 1}


def _hlo(cases):
    lines = []
    for i, (kind, dt, shape, g) in enumerate(cases):
        dims = ",".join(map(str, shape))
        groups = ",".join(map(str, range(g)))
        lines.append(f"  %{kind}.{i} = {dt}[{dims}]{{0}} {kind}(%p.{i}), "
                     f"replica_groups={{{{{groups}}}}}, to_apply=%add")
    return "\n".join(lines)


def _records(cases):
    return [(kind.replace("-", "_"), _ITEM[dt] * int(torch.Size(shape).numel()), g, ())
            for kind, dt, shape, g in cases]


@pytest.mark.parametrize("case", range(len(COLLECTIVES) + 1))
def test_collective_bytes_matches_jax_hlo(case):
    """Each collective alone, then all of them: the same per-kind traffic
    (reduce-scatter's group factor included)."""
    cases = COLLECTIVES if case == len(COLLECTIVES) else [COLLECTIVES[case]]
    want = jroofline.collective_bytes(_hlo(cases))
    got = roofline.collective_bytes(_records(cases))
    assert {k: v for k, v in got.items() if k != "seconds"} == want


def test_collective_seconds_by_link():
    """A group inside one node of 8 ranks moves at the NVLink rate, a wider
    one at the network's; on a mesh a record's axes place its group."""
    hw = roofline.HW()
    rec = ("all_gather", 2**30, 8, ("model",))
    assert roofline.collective_bytes([rec], abstract_mesh((2, 8), ("data", "model")).at(0),
                                     hw)["seconds"] == 2**30 / hw.nvlink_bw
    # the data axis of the same mesh strides over both nodes
    across = ("all_gather", 2**30, 2, ("data",))
    assert roofline.collective_bytes([across], abstract_mesh((2, 8), ("data", "model")).at(3),
                                     hw)["seconds"] == 2**30 / hw.net_bw
    # the production mesh's model axis: 16 ranks, two nodes
    wide = ("all_reduce", 2**20, 16, ("model",))
    prod = abstract_mesh((16, 16), ("data", "model")).at(0)
    assert roofline.collective_bytes([wide], prod, hw)["seconds"] == 2 * 2**20 / hw.net_bw
    assert roofline.collective_bytes([wide[:3] + ((),)], None, hw)["seconds"] == \
        2 * 2**20 / hw.net_bw


def test_hw_is_the_h100_data_sheet_and_chip_smoke_reads_it():
    hw = roofline.HW()
    assert (hw.peak_bf16, hw.peak_fp32, hw.peak_int8, hw.hbm_bw) == (989e12, 67e12, 1979e12,
                                                                     3.35e12)
    assert (hw.nvlink_bw, hw.net_bw, hw.node) == (450e9, 50e9, 8)
    assert roofline.HW.for_card("NVIDIA H100 80GB HBM3") == hw
    assert roofline.card_rates("NVIDIA H100 PCIe") == roofline.RATES["PCIe"]
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert not hasattr(cs, "RATES")          # one table: the roofline's
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 NVL", "NVIDIA H100 PCIe"):
        assert cs.card_rates(name) == roofline.card_rates(name)


def _report_fields():
    return dict(arch="llama31_8b", shape="prefill_32k", mesh="16x16", flops_per_dev=3e15,
                bytes_per_dev=2e11, coll_bytes_per_dev=1e10, compute_s=3.0, memory_s=0.06,
                collective_s=4.0, model_flops_total=1e17, peak_mem_bytes=None)


def test_roofline_report_keeps_the_references_fields_and_row():
    got, want = roofline.RooflineReport(**_report_fields()), \
        jroofline.RooflineReport(**_report_fields())
    assert (got.dominant, got.useful_ratio, got.row(256)) == \
        (want.dominant, want.useful_ratio, want.row(256))
    assert got.bound_s == 4.0


def test_count_step_by_hand():
    """``y = x @ w`` in bf16 and a write of 4 rows into a cache: 2·T·D·N bf16
    operations; x and w read once, y and the rows written once; the peak is
    the arguments plus what the step made."""
    t, d, n = 8, 32, 16
    x = torch.empty(t, d, dtype=torch.bfloat16, device="meta")
    w = torch.empty(d, n, dtype=torch.bfloat16, device="meta")
    cache = torch.empty(64, n, dtype=torch.bfloat16, device="meta")

    def step(x, w, cache):
        y = x @ w
        z = (x @ w).float()           # a second read of x and w counts nothing
        cache[:4] = y[:4]
        return y, z.sum()

    out, c = roofline.count_step(step, x, w, cache)
    assert c.ops == {"bf16": 2 * 2 * t * d * n, "fp32": 0, "int8": 0}
    assert c.read_bytes == (t * d + d * n) * 2
    assert c.write_bytes == 4 * n * 2 + t * n * 2 + 4
    assert c.args_bytes == (t * d + d * n + 64 * n) * 2
    assert c.output_bytes == t * n * 2 + 4
    assert c.peak_live_bytes >= t * n * 2 + t * n * 4 and c.peak_bytes == \
        c.args_bytes + c.peak_live_bytes
    assert c.collectives == [] and c.hbm_bytes == c.read_bytes + c.write_bytes


@pytest.fixture
def no_plain(monkeypatch):
    """Every hand kernel's plain version raises: on ``meta`` it never runs."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on meta")

    for mod, names in ((knm, ("_plain", "nm_prune_matmul_plain")), (kns, ("nm_spmm_plain",)),
                       (kos, ("osparse_matmul_plain", "osparse_quantize_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)


def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_nm_prune_matmul_is_one_unit(no_plain):
    t, d, n = 48, 256, 96
    x, w, b, s = _m(t, d), _m(d, n), _m(n), _m(d, dtype=torch.float32)
    y, c = roofline.count_step(lambda: ops.nm_prune_matmul(x, w, s, 8, 16, bias=b))
    assert y.shape == (t, n) and y.dtype == torch.bfloat16 and y.is_meta
    # the kept half of each row of x meets w
    assert c.ops == {"bf16": 2 * t * (d // 2) * n, "fp32": 0, "int8": 0}
    assert c.units == [{"kernel": "nm_prune_matmul", "ops": {"bf16": 2 * t * (d // 2) * n},
                        "bytes": (t * d + d * n + n + t * n) * 2 + d * 4}]
    assert c.read_bytes == (t * d + d * n + n) * 2 + d * 4 and c.write_bytes == t * n * 2
    assert knm.nm_prune_matmul.launches == 0


def test_nm_prune_matmul_unit_under_autograd(no_plain):
    """``--sparse-train``: the Function's forward is the unit, its backward
    two products the counter sees."""
    t, d, n = 16, 64, 32
    x = _m(t, d).requires_grad_(True)
    w = _m(d, n).requires_grad_(True)

    def step():
        y = knm.nm_prune_matmul(x, w, None, 2, 4)
        return torch.autograd.grad(y.float().sum(), (x, w))

    _, c = roofline.count_step(step)
    assert c.unit_counts() == {"nm_prune_matmul": 1}
    assert c.ops["bf16"] == 2 * t * (d // 2) * n + 2 * (2 * t * d * n)


def test_nm_spmm_is_one_unit(no_plain):
    t, d, n = 512, 128, 64
    x, w = _m(t, d), _m(d, n)
    y, c = roofline.count_step(lambda: ops.nm_spmm(x, w, None, 8, 16, tile=256))
    assert y.shape == (t, n) and y.dtype == torch.bfloat16
    assert c.ops == {"bf16": 2 * t * (d // 2) * n, "fp32": 0, "int8": 0}
    assert c.units[0]["bytes"] == (t * d + d * n + t * n) * 2
    assert kns.nm_spmm.launches == 0


@pytest.mark.parametrize("prune", [True, False])
def test_osparse_matmul_is_one_unit_of_int8_operations(no_plain, prune):
    t, d, n = 32, 128, 64
    x, wq = _m(t, d), _m(d, n, dtype=torch.int8)
    smooth, amber, ws = (_m(d, dtype=torch.float32), _m(d, dtype=torch.float32),
                         _m(n, dtype=torch.float32))
    act = _m(1, dtype=torch.float32)
    y, c = roofline.count_step(lambda: ops.osparse_matmul(x, wq, smooth, amber, ws, 8, 16,
                                                          act_scale=act, prune=prune))
    assert y.shape == (t, n) and y.dtype == torch.float32
    kept = d // 2 if prune else d
    assert c.ops == {"bf16": 0, "fp32": 0, "int8": 2 * t * kept * n}
    assert c.units[0]["bytes"] == t * d * 2 + d * n + (2 * d + n + 1) * 4 + t * n * 4
    assert kos.osparse_matmul.launches == 0


def test_flash_and_paged_attention_units_count_the_kept_pairs():
    b, t, hq, hkv, hd = 2, 8, 4, 2, 16
    q, k = _m(b, t, hq, hd), _m(b, t, hkv, hd)
    from repro_torch.kernels import flash_attention as kfa

    _, c = roofline.count_step(lambda: kfa.flash_attention(q, k, k, causal=True))
    assert c.ops["bf16"] == 4 * b * hq * hd * (t * (t + 1) // 2)
    _, c = roofline.count_step(lambda: kfa.flash_attention(q, k, k, causal=True, window=3))
    assert c.ops["bf16"] == 4 * b * hq * hd * sum(min(i + 1, 3) for i in range(t))
    assert kmeta._pairs(5, 9, False, 0) == 45


@pytest.mark.parametrize("variant", ["dense", "per_token", "tile_consensus", "per_token_24",
                                     "tile_consensus_24", "w8a8"])
def test_perf_variants_match_the_reference(variant):
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf as jperf
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    arch = "llama31_8b"
    if variant == "w8a8":     # named in the reference's docstring, not implemented
        with pytest.raises(ValueError):
            jperf.variant_policy(variant, jget(arch))
        with pytest.raises(ValueError):
            perf.variant_policy(variant, get_config(arch))
        return
    got = dataclasses.asdict(perf.variant_policy(variant, get_config(arch)))
    want = dataclasses.asdict(jperf.variant_policy(variant, jget(arch)))
    assert got.pop("use_kernels") == want.pop("use_pallas_kernels") is False
    assert got == want


def test_report_rows_match_the_reference():
    results = [
        {"arch": "granite_34b", "shape": "long_500k", "mesh": "16x16", "status": "skipped",
         "why": "full-attention arch at 524k context (skip per spec)"},
        {"arch": "mixtral_8x7b", "shape": "train_4k", "mesh": "16x16", "status": "FAIL",
         "error": "RuntimeError: x"},
    ]
    assert report.render(results).splitlines()[2:] == jreport.render(results).splitlines()[2:]
    unported = {"arch": "rwkv6_7b", "shape": "train_4k", "mesh": "2x16x16",
                "status": "unported", "why": "rwkv6_7b: not ported (ROADMAP A4b)"}
    assert report.render([unported], "2x16x16").splitlines()[2] == (
        "| rwkv6_7b | train_4k | UNPORTED (rwkv6_7b: not ported (ROADMAP A4b)) | — | — | — | — "
        "| — | — | — |")
    ok = {"arch": "llama31_8b", "shape": "prefill_32k", "mesh": "16x16", "status": "ok",
          "bytes_per_device": {"args": 2**30, "total": 3 * 2**30},
          "roofline_s": {"compute": 1.0, "memory": 0.5, "collective": 2.0},
          "dominant": "collective", "model_flops": 1e16, "useful_flops_ratio": 0.5}
    assert report.render([ok]).splitlines()[2] == (
        "| llama31_8b | prefill_32k | ok | 3.00 (1.00) | 1.000e+00 | 5.000e-01 | 2.000e+00 | "
        "**collective** | 1.00e+16 | 0.500 |")


def test_report_cli_counts_each_status(tmp_path, capsys):
    rows = [{"arch": "a", "shape": "s", "mesh": "16x16", "status": st, "why": "w",
             "error": "e"} for st in ("skipped", "unported", "FAIL")]
    path = tmp_path / "r.json"
    path.write_text(__import__("json").dumps(rows))
    assert report.main([str(path)]) == 1
    assert "cells: 0 ok / 1 skipped / 1 unported / 1 failed (of 3)" in capsys.readouterr().out
