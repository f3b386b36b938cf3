#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):

1. build   — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
             with nvcc (one process per source, in parallel), print ptxas's
             warnings of serialised wgmma (C7512-C7520), and count the wgmma
             instructions in each library's SASS: HGMMA (bf16) in the
             ``flash_attention``, ``nm_prune_matmul``, ``nm_spmm`` and
             ``paged_attention`` libraries, IGMMA (int8) in
             ``osparse_matmul``; each must have some.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the serving path's LLaMA-3.1-8B shapes in bfloat16 (plus a
             float32 case each); median time with CUDA events, the bound
             from the card's data-sheet rates, the plain version's time and
             one library call's time.  The int8 kernels (``osparse_matmul``,
             ``w8a8_matmul``) and ``nm_prune`` must be bit-exact: int8
             codes, scales and outputs, on every route of
             ``w8a8_matmul.gemm_plan`` (2d prints each case's route and
             times the quantize pass alone beside the whole call; a timed
             main-path case must have taken its wgmma route; at T = 4 the
             library yardstick runs on xq zero-padded to 32 rows, as
             ``torch._int_mm`` takes no fewer than 17).  2b: ``paged_kv_scatter``
             bit-exact, timed alone (a 200-row chunk, a decode step) and as the
             graphs run it: a captured graph of 32 (producer, scatter) pairs
             less a graph of the producers alone, over 32; the replay must be
             bit-exact too.  2c: ``paged_attention`` on
             NaN-poisoned pools: a prefill chunk, decode at LLaMA-3.1-8B's
             heads (G = 4) and at Qwen2-7B's (28 / 4, G = 7), float32; each
             case's route and time, and the chunk's cost per call and per
             64-key tile from three key lengths.  2g/2h: ``flash_attention`` and
             ``nm_spmm`` at the one-shot Qwen2-7B prefill's shapes (4 x 512
             tokens), with ragged, windowed, non-causal and float32 cases;
             ``nm_spmm``'s consensus selection must be bit-exact, and is
             timed alone beside the whole call; its GEMM's routes (k split,
             128- or 256-row blocks) are checked and timed against each
             other where the plan chooses them.
3. serve   — ``Engine.from_config`` at full LLaMA-3.1-8B width (32 layers,
             random weights from a seed, bfloat16) under the paper's
             policy with the kernels on: 8 staggered requests, 32 new tokens
             each, every step a replay of its bucket's CUDA graph after the
             bucket's first (eager, then captured) step; every bucket used
             must read 1 in ``trace_counts``; each kernel of the path must
             have launched (replays counted), ``nm_prune_matmul`` exactly 86
             times per sparse prefill chunk.  Then one prefill chunk and one
             decode step under ``torch.profiler``, eagerly through the model
             and as a replay of the executor's graph: wall time, device busy
             time, kernel time by family and the device's idle share.  Then
             the same requests with every step run through its step program
             eagerly: the tokens must be identical.
3b. serve, Outstanding-sparse — the same weights rewritten to W8A8 on
             q/k/v/o/gate/up of every layer (``QuantConfig()``: alpha 0.10,
             ŝ = 1/s, static per-tensor activation scale, down_proj left
             bf16) from a seeded calibration absmax, served the same way:
             ``osparse_matmul`` 192 times per prefill half and per decode
             half (54 per sparse chunk pruned), every launch on a wgmma
             route (``wgmma`` in prefill, the one-launch ``swap_fused`` in
             decode), ``nm_prune_matmul`` 32 times per sparse chunk; the same
             graphs, profiles and token check.
4. parity  — full width, depth 2, float32: the same requests through the
             kernel path and the plain path (both served through the
             executor's graphs) must emit the same greedy
             tokens, and the last-chunk logits must agree; then in bf16
             (``nm_prune_matmul``'s wgmma GEMM), the logits held within
             twice bf16 rounding's own effect on the plain path; 4b does the
             float32 check for the Outstanding-sparse model.
5. one-shot — ``ServingEngine.generate`` at full Qwen2-7B width (28 layers,
             q/k/v biases, ``attn_impl="flash"``, random weights from a
             seed, bfloat16) under the paper's policy in tile-consensus
             mode with the kernels on: 4 prompts of 512 tokens, 32 new
             tokens each, the prefill and the decode step CUDA graphs
             (``trace_counts`` 1 each); per prefill exactly 74 ``nm_spmm``
             and 28 ``flash_attention`` launches, 28 ``paged_kv_scatter``
             per prefill and per decode step, 28 ``paged_attention`` per
             decode step, no ``nm_prune_matmul`` (replays counted); tokens
             identical to the same generate run without graphs; then the
             prefill and one decode step under ``torch.profiler``, eager and
             replayed.  5b: full width, depth 2,
             float32: kernel path against plain path, identical greedy
             tokens and close last-token logits; then in bf16
             (``flash_attention``'s wgmma kernel), as phase 4's bf16 case.

The last lines are the per-kernel JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Exits non-zero without a
CUDA device, and when run outside the repository (it needs ``src/``).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
# data-sheet rates (dense): bytes/s, bf16 FLOP/s, fp32 (non-tensor) FLOP/s,
# int8 tensor-core OP/s
RATES = {
    "PCIe": (2.0e12, 756e12, 51e12, 1513e12),
    "NVL": (3.9e12, 835e12, 60e12, 1670e12),
    "SXM": (3.35e12, 989e12, 67e12, 1979e12),
}
QPROJS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj")


def card_rates(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return RATES[key]
    return RATES["SXM"]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time over ``reps`` launches with CUDA events.  The L2
    is flushed before each launch (the serving path meets its weights and
    KV cold), and a GPU sleep is queued ahead of the start event so the
    host's launch overhead overlaps it instead of being timed as idle
    device time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)       # ~1 ms of device clock cycles
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


# the libraries whose kernels are written for the tensor cores' wgmma, and
# the SASS opcode their products assemble to (bf16 HGMMA, int8 IGMMA)
WGMMA_LIBRARIES = {"flash_attention.so": "HGMMA", "nm_prune_matmul.so": "HGMMA",
                   "nm_spmm.so": "HGMMA", "paged_attention.so": "HGMMA",
                   "osparse_matmul.so": "IGMMA"}
# ptxas warnings that it serialised a kernel's wgmma (C7512-C7520)
SERIALISED_WGMMA = re.compile(r"C75(1[2-9]|20)")


def check_hgmma(build_dir: str, logs: dict) -> None:
    """The count of wgmma instructions (HGMMA, IGMMA) in each built library's
    SASS, and ptxas's warnings that it serialised wgmma; the redesigned
    kernels' libraries must hold some of their opcode."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for src, log in logs.items():
        for line in log.splitlines():
            if SERIALISED_WGMMA.search(line):
                print(f"  {src}: {line.strip()}")
    for lib in sorted(Path(build_dir).glob("*.so")):
        sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "IGMMA")}
        warned = sum(bool(SERIALISED_WGMMA.search(line))
                     for line in logs.get(lib.stem + ".cu", "").splitlines())
        print(f"  {lib.name}: {counts['HGMMA']} HGMMA and {counts['IGMMA']} IGMMA "
              f"instructions in the SASS, {warned} ptxas warnings of serialised wgmma")
        op = WGMMA_LIBRARIES.get(lib.name)
        if op is not None and counts[op] == 0:
            fail(f"{lib.name} holds no {op} instruction: its kernels do not use wgmma")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check_close(name, got, want, tol_rel: float):
    """max|got - want| <= tol_rel * max|want|; both must be finite."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        fail(f"{name}: kernel output is not finite")
    err = float((got - want).abs().max())
    lim = tol_rel * float(want.abs().max())
    print(f"  {name}: max_abs_err={err:.3e} (limit {lim:.3e})")
    if not err <= lim:
        fail(f"{name}: max_abs_err {err} > {lim}")
    return err


# bfloat16 outputs: kernel and plain version both round a float32 sum to
# bf16, and their sums differ only in order (~1e-6 relative), so they differ
# by at most one bf16 ulp of an element: 2**-7 of the largest magnitude.
BF16_TOL = 2.0**-7
# float32 outputs: summation order alone (K up to 14336 terms).
F32_TOL = 1e-4


def phase_kernels(torch, timer, rates):
    from repro_torch.core import nm, scoring
    from repro_torch.kernels import nm_prune_matmul as knm
    from repro_torch.kernels import paged_attention as kpa

    bw, bf16_peak, f32_peak, _ = rates
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    records = {}

    # ---------------------------------------------------- nm_prune_matmul
    print("phase 2a: nm_prune_matmul (LLaMA-3.1-8B q/gate/down, N:M 8:16)")
    errs = []
    n, m = 8, 16
    for proj, d, n_out in (("q", 4096, 4096), ("gate", 4096, 14336), ("down", 14336, 4096)):
        w = (torch.randn(d, n_out, generator=g, device=dev) * d**-0.5).bfloat16()
        scale = torch.rand(d, generator=g, device=dev) + 0.5
        bias = (torch.randn(n_out, generator=g, device=dev) * 0.1).bfloat16()
        for t in (256, 137):
            x = torch.randn(t, d, generator=g, device=dev).bfloat16()
            plan = knm.gemm_plan(w, t)
            route = f"wgmma, {plan} k slice{'s' if plan > 1 else ''}" if plan else "WMMA"
            for b in (None, bias):
                got = knm.nm_prune_matmul(x, w, scale, n, m, bias=b)
                want = knm.nm_prune_matmul_plain(x, w, scale, n, m, bias=b)
                errs.append(check_close(f"{proj} T={t} bias={b is not None} ({route})", got,
                                        want, BF16_TOL))
            if t == 256:
                xp = nm.apply_nm(x, scoring.score_activations(x, scale), n, m)
                ms = timer.ms(lambda: knm.nm_prune_matmul(x, w, scale, n, m))
                plain_ms = timer.ms(lambda: knm.nm_prune_matmul_plain(x, w, scale, n, m), 5)
                lib_ms = timer.ms(lambda: torch.matmul(xp, w))
                nbytes = (x.numel() + w.numel() + t * n_out) * 2 + d * 4
                ops = 2 * int((xp != 0).sum()) * n_out
                bound = max(nbytes / bw, ops / bf16_peak) * 1e3
                print(f"  {proj} T=256: kernel {ms:.4f} ms, bound {bound:.4f} ms "
                      f"({'bytes' if nbytes / bw >= ops / bf16_peak else 'operations'}), "
                      f"plain {plain_ms:.4f} ms, torch.matmul(x_pruned) {lib_ms:.4f} ms; "
                      f"kernel/library {ms / lib_ms:.2f}, bound/kernel {bound / ms:.3f}")
                if proj == "gate":
                    records["nm_prune_matmul"] = dict(
                        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                        bound_by="bytes" if nbytes / bw >= ops / bf16_peak else "operations")
        del w
    # the WMMA route: a w the TMA cannot take (storage 2 bytes off a 16-byte
    # boundary), and an N_out that is not a multiple of 8
    for case, t, d, n_out, offset in (("w misaligned", 137, 4096, 4096, 1),
                                      ("N_out=4100", 137, 4096, 4100, 0)):
        flat = torch.randn(d * n_out + offset, generator=g, device=dev) * d**-0.5
        w = flat.bfloat16()[offset:].view(d, n_out)
        x = torch.randn(t, d, generator=g, device=dev).bfloat16()
        scale = torch.rand(d, generator=g, device=dev) + 0.5
        if knm.gemm_plan(w, t) != 0:
            fail(f"nm_prune_matmul {case}: expected the WMMA route")
        errs.append(check_close(f"{case} T={t} (WMMA)", knm.nm_prune_matmul(x, w, scale, n, m),
                                knm.nm_prune_matmul_plain(x, w, scale, n, m), BF16_TOL))
    xf = torch.randn(137, 4096, generator=g, device=dev)
    wf = torch.randn(4096, 4096, generator=g, device=dev) * 4096**-0.5
    sf = torch.rand(4096, generator=g, device=dev) + 0.5
    bf = torch.randn(4096, generator=g, device=dev)
    errs.append(check_close("float32 q T=137 bias", knm.nm_prune_matmul(xf, wf, sf, n, m, bf),
                            knm.nm_prune_matmul_plain(xf, wf, sf, n, m, bf), F32_TOL))
    records["nm_prune_matmul"]["max_abs_err"] = max(errs)

    # --------------------------------------------------- paged pools
    hkv, hd, hq, bs, mb = 8, 128, 32, 16, 46
    nb = 4 * mb
    rows = nb + 1                     # + the trailing sentinel row

    def pools(dtype):
        kp = torch.randn(rows, bs, hkv, hd, generator=g, device=dev).to(dtype)
        vp = torch.randn(rows, bs, hkv, hd, generator=g, device=dev).to(dtype)
        return kp, vp

    perm = torch.randperm(nb, generator=g, device=dev).to(torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)

    # ------------------------------------------------------- scatter
    print("phase 2b: paged_kv_scatter (bit-exact)")
    kp, vp = pools(torch.bfloat16)
    tab1 = perm[:mb].reshape(1, mb).contiguous()
    kn = torch.randn(1, 256, hkv, hd, generator=g, device=dev).bfloat16()
    vn = torch.randn(1, 256, hkv, hd, generator=g, device=dev).bfloat16()
    pos1, cl1 = torch.tensor([37], **i32), torch.tensor([200], **i32)
    tab4 = perm.reshape(4, mb).clone()
    tab4[1] = -1                      # an empty slot: every write dropped
    posd = torch.tensor([700, 513, 64, 31], **i32)
    tab4[2, 64 // bs] = -1            # this slot's current block unallocated
    kd = torch.randn(4, 1, hkv, hd, generator=g, device=dev).bfloat16()
    vd = torch.randn(4, 1, hkv, hd, generator=g, device=dev).bfloat16()
    ones = torch.ones(4, **i32)
    for case, args in (("prefill chunk pos=37 len=200", (kn, vn, tab1, pos1, cl1)),
                       ("decode B=4 with -1 rows", (kd, vd, tab4, posd, ones))):
        k_a, v_a, k_b, v_b = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        kpa.paged_kv_scatter(args[0], args[1], k_a, v_a, *args[2:])
        kpa.paged_kv_scatter_plain(args[0], args[1], k_b, v_b, *args[2:])
        torch.cuda.synchronize()
        same = torch.equal(k_a, k_b) and torch.equal(v_a, v_b)
        print(f"  {case}: bit-exact={same}")
        if not same:
            fail(f"paged_kv_scatter {case}: kernel and plain version differ")
    # timing: the prefill chunk's 200 kept rows
    kflat, vflat = kp.view(rows * bs, hkv, hd), vp.view(rows * bs, hkv, hd)
    wpos = 37 + torch.arange(200, device=dev)
    dst = tab1[0].long()[wpos // bs] * bs + wpos % bs
    ksrc, vsrc = kn[0, :200], vn[0, :200]
    ms = timer.ms(lambda: kpa.paged_kv_scatter(kn, vn, kp, vp, tab1, pos1, cl1))
    plain_ms = timer.ms(lambda: kpa.paged_kv_scatter_plain(kn, vn, kp, vp, tab1, pos1, cl1))

    def index_put():
        kflat.index_put_((dst,), ksrc)
        vflat.index_put_((dst,), vsrc)

    lib_ms = timer.ms(index_put)
    nbytes = 2 * 200 * hkv * hd * 2 * 2 + (mb + 2) * 4
    bound = nbytes / bw * 1e3
    print(f"  prefill chunk: kernel {ms:.4f} ms, bound {bound:.4f} ms (bytes), plain "
          f"{plain_ms:.4f} ms, index_put_ K+V {lib_ms:.4f} ms")
    dec_ms = timer.ms(lambda: kpa.paged_kv_scatter(kd, vd, kp, vp, tab4, posd, ones))
    dec_bound = (2 * 2 * hkv * hd * 2 * 2 + 2 * 4 * 4 + 4 * 4) / bw * 1e3
    print(f"  decode B=4 (2 kept rows): kernel {dec_ms:.4f} ms, bound {dec_bound:.5f} ms")
    records["paged_kv_scatter"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by="bytes",
        max_abs_err=0.0, decode_ms=dec_ms, decode_bound_ms=dec_bound,
        in_graph_ms=scatter_in_graph(torch, timer, "prefill chunk", kn, vn, kp, vp, tab1,
                                     pos1, cl1),
        decode_in_graph_ms=scatter_in_graph(torch, timer, "decode B=4", kd, vd, kp, vp,
                                            tab4, posd, ones))

    # ----------------------------------------------------- attention
    print("phase 2c: paged_attention")
    errs = []
    kp, vp = pools(torch.bfloat16)

    def poisoned(kp, vp, tab, kvl):
        """Pools where every row no table row may read is NaN: blocks no
        row owns, and rows at or past each row's kv_len."""
        kpn, vpn = kp.clone(), vp.clone()
        live = torch.zeros(kp.shape[:2], dtype=torch.bool)
        tab_h, kvl_h = tab.cpu(), kvl.cpu()
        for r in range(tab_h.shape[0]):
            for i in range(int(kvl_h[r])):
                pb = int(tab_h[r, i // bs])
                if pb >= 0:
                    live[pb, i % bs] = True
        live = live.to(dev)
        kpn[~live], vpn[~live] = float("nan"), float("nan")
        return kpn, vpn

    def route(q, kp, tab):
        b, tq, hq_, hd_ = q.shape
        return kpa.attention_plan(q.dtype, b, tq, hq_, kp.shape[2], hd_, bs, tab.shape[1],
                                  True)

    def decode_case(hq_, qpos):
        """Decode rows of ``hq_`` query heads at positions ``qpos``: each row
        owns the blocks it needs, the rest of its table row is -1."""
        b = len(qpos)
        posv = torch.tensor(qpos, **i32)
        kvld = posv + 1
        tabd = torch.full((b, mb), -1, **i32)
        for r in range(b):
            need = int(kvld[r] + bs - 1) // bs
            tabd[r, :need] = perm[r * mb:r * mb + need]
        q = torch.randn(b, 1, hq_, hd, generator=g, device=dev).bfloat16()
        return q, tabd, posv, kvld

    q1 = torch.randn(1, 256, hq, hd, generator=g, device=dev).bfloat16()
    qoff1, kvl1 = torch.tensor([300], **i32), torch.tensor([500], **i32)
    kp1, vp1 = poisoned(kp, vp, tab1, kvl1)
    got = kpa.paged_attention(q1, kp1, vp1, tab1, qoff1, kvl1, causal=True)
    want = kpa.paged_attention_plain(q1, kp1, vp1, tab1, qoff1, kvl1, causal=True)
    errs.append(check_close(f"prefill chunk q_offset=300 kv_len=500 NaN-poisoned "
                            f"{route(q1, kp, tab1)}", got, want, BF16_TOL))
    # decode, LLaMA-3.1-8B heads (G = 4) and Qwen2-7B heads (28 / 4, G = 7):
    # some rows own few blocks, the rest of each table row is -1
    qd, tabd, posv, kvld = decode_case(hq, [700, 513, 64, 0])
    kpn, vpn = poisoned(kp, vp, tabd, kvld)
    got = kpa.paged_attention(qd, kpn, vpn, tabd, posv, kvld, causal=False)
    want = kpa.paged_attention_plain(qd, kpn, vpn, tabd, posv, kvld, causal=False)
    errs.append(check_close(f"decode B=4 G=4 NaN-poisoned {route(qd, kp, tabd)}", got, want,
                            BF16_TOL))
    q32 = qd.float()
    errs.append(check_close(
        f"float32 decode NaN-poisoned {route(q32, kp, tabd)}",
        kpa.paged_attention(q32, kpn.float(), vpn.float(), tabd, posv, kvld, causal=False),
        kpa.paged_attention_plain(q32, kpn.float(), vpn.float(), tabd, posv, kvld,
                                  causal=False), F32_TOL))
    kq = torch.randn(rows, bs, 4, hd, generator=g, device=dev).bfloat16()
    vq = torch.randn(rows, bs, 4, hd, generator=g, device=dev).bfloat16()
    q7, tab7, pos7, kvl7 = decode_case(28, [543, 512, 300, 31])
    kq7, vq7 = poisoned(kq, vq, tab7, kvl7)
    errs.append(check_close(
        f"decode B=4 G=7 (Qwen2-7B heads) NaN-poisoned {route(q7, kq, tab7)}",
        kpa.paged_attention(q7, kq7, vq7, tab7, pos7, kvl7, causal=False),
        kpa.paged_attention_plain(q7, kq7, vq7, tab7, pos7, kvl7, causal=False), BF16_TOL))
    # timing at the serving shapes; the record keeps the prefill chunk's and,
    # beside it, each decode case's
    cases = (("prefill chunk", q1, kp, vp, tab1, qoff1, kvl1, True),
             ("decode B=4 G=4", qd, kp, vp, tabd, posv, kvld, False),
             ("decode B=4 G=7", q7, kq, vq, tab7, pos7, kvl7, False))
    for case, q, kpool, vpool, tab, qo, kvl, causal in cases:
        b, tq, hq_ = q.shape[:3]
        hkv_ = kpool.shape[2]
        ms = timer.ms(lambda: kpa.paged_attention(q, kpool, vpool, tab, qo, kvl, causal=causal))
        plain_ms = timer.ms(
            lambda: kpa.paged_attention_plain(q, kpool, vpool, tab, qo, kvl, causal=causal), 5)
        s_len = mb * bs
        kpos = torch.arange(s_len, device=dev)
        qpos = qo.long()[:, None] + torch.arange(tq, device=dev)[None, :]
        mask = kpos[None, None, :] < kvl.long()[:, None, None]
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
        kg = kpool[tab.long().clamp(0, rows - 1)].reshape(b, s_len, hkv_, hd)
        vg = vpool[tab.long().clamp(0, rows - 1)].reshape(b, s_len, hkv_, hd)
        # KV heads repeated to the query heads outside the timed call
        qt = q.transpose(1, 2)
        kt = kg.transpose(1, 2).repeat_interleave(hq_ // hkv_, dim=1)
        vt = vg.transpose(1, 2).repeat_interleave(hq_ // hkv_, dim=1)
        am = mask[:, None]
        lib_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am))
        pairs = int(mask.sum()) * hq_
        nbytes = (2 * q.numel() + 2 * int(kvl.sum()) * hkv_ * hd) * 2
        ops = 4 * hd * pairs
        bound = max(nbytes / bw, ops / bf16_peak) * 1e3
        by = "bytes" if nbytes / bw >= ops / bf16_peak else "operations"
        print(f"  {case} {route(q, kpool, tab)}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}), plain {plain_ms:.4f} ms, SDPA on the gathered view {lib_ms:.4f} ms; "
              f"kernel/library {ms / lib_ms:.2f}")
        if case == "prefill chunk":
            records["paged_attention"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                              bound_ms=bound, bound_by=by)
        else:
            key = "decode_g4" if "G=4" in case else "decode_g7"
            records["paged_attention"].update({f"{key}_ms": ms, f"{key}_bound_ms": bound,
                                               f"{key}_library_ms": lib_ms})
    # what a chunk costs per 64-key tile and per call: the same 256 queries,
    # causal, ending at kv_len 256, 512 and 736 (the longest query tile walks
    # 4, 8 and 12 tiles); a least-squares line through the three times
    walks, times = [], []
    for kvl_s in (256, 512, mb * bs):
        qo_s, kv_s = torch.tensor([kvl_s - 256], **i32), torch.tensor([kvl_s], **i32)
        walks.append(-(-kvl_s // 64))
        times.append(timer.ms(lambda: kpa.paged_attention(q1, kp, vp, tab1, qo_s, kv_s)))
    slope, icept = np.polyfit(walks, times, 1)
    print(f"  chunk vs its walk: {[f'{w} tiles {t:.4f} ms' for w, t in zip(walks, times)]}: "
          f"{icept * 1e3:.2f} us a call + {slope * 1e3:.2f} us a 64-key tile")
    records["paged_attention"]["max_abs_err"] = max(errs)
    return records


def scatter_in_graph(torch, timer, case, kn, vn, kp, vp, tab, pos, clen, pairs=32):
    """``paged_kv_scatter`` as the main path's graphs run it: a captured
    graph of ``pairs`` (producer, scatter) pairs, the producer a copy that
    writes ``k_new`` just before each scatter (as the model's RoPE does),
    against a graph of the producers alone; the scatter's share per launch
    is the difference over ``pairs``.  The replayed pools must equal the
    plain version's, bit for bit (the programmatic edge of the capture)."""
    from repro_torch.kernels import _capture
    from repro_torch.kernels import paged_attention as kpa

    src = kn.clone()
    k_a, v_a, k_b, v_b = kp.clone(), vp.clone(), kp.clone(), vp.clone()

    def body(with_scatter, kpool, vpool):
        for _ in range(pairs):
            kn.copy_(src)
            if with_scatter:
                kpa.paged_kv_scatter(kn, vn, kpool, vpool, tab, pos, clen)

    both = _capture.Graph(kp.device, None)
    both.capture(lambda: body(True, k_a, v_a))
    producers = _capture.Graph(kp.device, None)
    producers.capture(lambda: body(False, k_a, v_a))
    src.copy_(torch.randn(src.shape, device="cuda").to(src.dtype))
    both.replay()
    kpa.paged_kv_scatter_plain(src, vn, k_b, v_b, tab, pos, clen)
    torch.cuda.synchronize()
    if not (torch.equal(k_a, k_b) and torch.equal(v_a, v_b)):
        fail(f"paged_kv_scatter {case}: the graph's replay and the plain version differ")
    t_both, t_prod = timer.ms(both.replay), timer.ms(producers.replay)
    share = (t_both - t_prod) / pairs
    print(f"  {case} in a graph: {pairs} (producer, scatter) pairs {t_both:.4f} ms, the "
          f"producers alone {t_prod:.4f} ms: {share:.5f} ms a scatter (replay bit-exact)")
    return share


def calib_absmax(rng, d: int) -> np.ndarray:
    """A calibration absmax over 64 seeded tokens with four outlier
    channels, as ``examples/deploy_outstanding_sparse.py`` makes them."""
    x = rng.standard_normal((64, d), dtype=np.float32)
    x *= np.where(np.arange(d) < 4, 11, 1).astype(np.float32)
    return np.abs(x).max(axis=0)


def int_mm_ms(torch, timer, xq, wq, scale, w_scale):
    """The library yardstick of the int8 GEMM: ``torch._int_mm`` (cuBLASLt)
    plus the dequant, and its label.  ``_int_mm`` takes more than 16 rows
    only, so at T <= 16 ``xq`` is zero-padded to 32 rows ("padded") and the
    pad's rows dropped after; K and N must be multiples of 8, else None."""
    t, d = xq.shape
    if d % 8 or wq.shape[1] % 8:
        return None, "n/a (K or N not a multiple of 8)"
    label = "torch._int_mm + dequant"
    if t <= 16:
        pad = torch.zeros((32, d), dtype=torch.int8, device=xq.device)
        pad[:t] = xq
        xq, label = pad, "torch._int_mm on xq zero-padded to 32 rows (padded) + dequant"
    try:
        return timer.ms(lambda: torch._int_mm(xq, wq)[:t].float() * scale * w_scale), label
    except RuntimeError as e:          # a yardstick only: report, do not fail
        print(f"  torch._int_mm refused {tuple(xq.shape)} @ {tuple(wq.shape)}: {e}")
        return None, label


def expect_routes(name, fn, want):
    """Every launch counted on ``fn`` since its counts were reset took route
    ``want``, and ``want`` runs on wgmma (not the simple dp4a route)."""
    got = {r: c for r, c in fn.route_launches.items() if c}
    if want == "simple" or set(got) != {want}:
        fail(f"{name}: launches by route {got}, expected all on a wgmma route ({want})")


def phase_int8_kernels(torch, timer, rates):
    """osparse_matmul, w8a8_matmul and nm_prune, bit-exact against their
    plain versions (int8 codes, scales and outputs), on every route."""
    from repro_torch import kernels
    from repro_torch.core import quant
    from repro_torch.kernels import nm_prune as knp
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.kernels import w8a8_matmul as kw8

    bw, _, _, int8_peak = rates
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    dev = "cuda"
    n, m = 8, 16
    records = {}

    def exact(name, a, b):
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        if not same:
            fail(f"{name}: kernel and plain version differ")
        return same

    # ----------------------------------------------------- osparse_matmul
    print("phase 2d: osparse_matmul (LLaMA-3.1-8B q/k/gate, W8A8, 8:16 where pruned; "
          "bit-exact codes, scales, outputs; wq K-major)")
    for proj, d, n_out in (("q", 4096, 4096), ("k", 4096, 1024), ("gate", 4096, 14336)):
        w = (torch.randn(d, n_out, generator=g, device=dev) * d**-0.5).bfloat16()
        am = torch.from_numpy(calib_absmax(rng, d)).to(dev)
        ql = quant.make_quantized_linear(w, am, quant.QuantConfig())
        del w
        amber = torch.rand(d, generator=g, device=dev) + 0.5
        for t in (256, 4):
            x = torch.randn(t, d, generator=g, device=dev).bfloat16()
            cases = [(pt, pr) for pt in (False, True) for pr in (True, False)]
            for per_token, prune in cases:
                args = (x, ql.wq, ql.smooth, amber, ql.w_scale, n, m)
                kw = dict(act_scale=ql.act_scale, prune=prune, per_token=per_token)
                plan = kw8.gemm_plan(t, d, n_out, x.dtype, per_token, prune, m)
                got = (kos.osparse_matmul(*args, **kw),
                       *kos.osparse_quantize(x, ql.smooth, amber, n, m, ql.act_scale, prune,
                                             per_token))
                want = (kos.osparse_matmul_plain(*args, **kw),
                        *kos.osparse_quantize_plain(x, ql.smooth, amber, n, m, ql.act_scale,
                                                    prune, per_token))
                torch.cuda.synchronize()
                same = exact(f"osparse_matmul {proj} T={t} per_token={per_token} "
                             f"prune={prune}", got, want)
                print(f"  {proj} T={t} per_token={per_token} prune={prune}: route "
                      f"{plan.route} split {plan.splits}, bit-exact={same}")
            # timing at the main path's setting: q/gate pruned in prefill, else
            # dense, static per-tensor scale; the whole call and its quantize
            # pass alone (the swap_fused route has none: it quantizes inside)
            prune = t == 256 and proj != "k"
            plan = kw8.gemm_plan(t, d, n_out, x.dtype, False, prune, m)
            args = (x, ql.wq, ql.smooth, amber, ql.w_scale, n, m)
            kw = dict(act_scale=ql.act_scale, prune=prune)
            xq, _ = kos.osparse_quantize_plain(x, ql.smooth, amber, n, m, ql.act_scale, prune)
            kernels.reset_launch_counts()
            ms = timer.ms(lambda: kos.osparse_matmul(*args, **kw))
            expect_routes(f"osparse_matmul {proj} T={t}", kos.osparse_matmul, plan.route)
            q_ms = timer.ms(lambda: kos.osparse_quantize(x, ql.smooth, amber, n, m,
                                                         ql.act_scale, prune))
            plain_ms = timer.ms(lambda: kos.osparse_matmul_plain(*args, **kw), 5)
            lib_ms, lib_label = int_mm_ms(torch, timer, xq, ql.wq, ql.act_scale, ql.w_scale)
            nbytes = x.numel() * 2 + ql.wq.numel() + 2 * d * 4 + n_out * 4 + 4 + t * n_out * 4
            ops = 2 * int((xq != 0).sum()) * n_out
            bound = max(nbytes / bw, ops / int8_peak) * 1e3
            by = "bytes" if nbytes / bw >= ops / int8_peak else "operations"
            lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            share = ("not run on this route, which quantizes inside its GEMM"
                     if plan.route == "swap_fused" else f"{q_ms / ms:.1%} of the call")
            print(f"  {proj} T={t} prune={prune}: route {plan.route} split {plan.splits}: "
                  f"kernel {ms:.4f} ms, quantize pass alone {q_ms:.4f} ms ({share}), bound "
                  f"{bound:.4f} ms ({by}), plain {plain_ms:.4f} ms, {lib_label} {lib}")
            if proj == "gate" and t == 256:
                records["osparse_matmul"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                                 bound_ms=bound, bound_by=by, max_abs_err=0.0)
        del ql
    # float32 activations at a ragged T on both routes, per tensor and per
    # token, pruned (k's width: the swap route's deepest split)
    w = torch.randn(4096, 1024, generator=g, device=dev) * 4096**-0.5
    ql = quant.make_quantized_linear(w, torch.from_numpy(calib_absmax(rng, 4096)).to(dev),
                                     quant.QuantConfig())
    for t in (137, 5):
        xf = torch.randn(t, 4096, generator=g, device=dev)
        for per_token in (False, True):
            args = (xf, ql.wq, ql.smooth, amber, ql.w_scale, n, m)
            kw = dict(act_scale=ql.act_scale, per_token=per_token)
            same = exact("osparse_matmul float32", (kos.osparse_matmul(*args, **kw),),
                         (kos.osparse_matmul_plain(*args, **kw),))
            plan = kw8.gemm_plan(t, 4096, 1024, xf.dtype, per_token, True, m)
            print(f"  float32 k T={t} per_token={per_token}: route {plan.route}, "
                  f"bit-exact={same}")

    # -------------------------------------------------------- w8a8_matmul
    print("phase 2e: w8a8_matmul (bit-exact; wq K-major)")
    for t, d, n_out in ((256, 4096, 14336), (4, 4096, 1024), (37, 200, 130)):
        xq = torch.randint(-127, 128, (t, d), generator=g, device=dev).to(torch.int8)
        wq = torch.randint(-127, 128, (n_out, d), generator=g, device=dev).to(torch.int8).t()
        ws = torch.rand(n_out, generator=g, device=dev) * 1e-3
        xs = torch.tensor(0.013, device=dev)
        plan = kw8.gemm_plan(t, d, n_out, torch.int8)
        same = exact(f"w8a8_matmul {t}x{d}x{n_out}", (kw8.w8a8_matmul(xq, wq, xs, ws),),
                     (kw8.w8a8_matmul_plain(xq, wq, xs, ws),))
        print(f"  T={t} D={d} N={n_out}: route {plan.route} split {plan.splits}, "
              f"bit-exact={same}")
        if t == 256:
            kernels.reset_launch_counts()
            ms = timer.ms(lambda: kw8.w8a8_matmul(xq, wq, xs, ws))
            expect_routes("w8a8_matmul gate T=256", kw8.w8a8_matmul, plan.route)
            plain_ms = timer.ms(lambda: kw8.w8a8_matmul_plain(xq, wq, xs, ws), 5)
            lib_ms, lib_label = int_mm_ms(torch, timer, xq, wq, xs, ws)
            nbytes = xq.numel() + wq.numel() + n_out * 4 + 4 + t * n_out * 4
            ops = 2 * t * d * n_out
            bound = max(nbytes / bw, ops / int8_peak) * 1e3
            by = "bytes" if nbytes / bw >= ops / int8_peak else "operations"
            lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            print(f"  gate T=256: route {plan.route}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
                  f"({by}), plain {plain_ms:.4f} ms, {lib_label} {lib}")
            records["w8a8_matmul"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                          bound_ms=bound, bound_by=by, max_abs_err=0.0)

    # ----------------------------------------------------------- nm_prune
    print("phase 2f: nm_prune (bit-exact)")
    # the group widths of the vectorised selection, and one (6) it leaves to
    # the one-thread-per-group kernel
    for nn, mm, d in ((2, 4, 4096), (4, 8, 4096), (16, 32, 4096), (3, 6, 4092)):
        x = torch.randn(256, d, generator=g, device=dev).bfloat16()
        scale = torch.rand(d, generator=g, device=dev) + 0.5
        same = exact("nm_prune", (knp.nm_prune(x, scale, nn, mm),),
                     (knp.nm_prune_plain(x, scale, nn, mm),))
        print(f"  D={d} T=256 {nn}:{mm}: bit-exact={same}")
    for d in (4096, 14336):
        scale = torch.rand(d, generator=g, device=dev) + 0.5
        for dtype, t in ((torch.bfloat16, 256), (torch.bfloat16, 137), (torch.float32, 37)):
            x = torch.randn(t, d, generator=g, device=dev).to(dtype)
            for sc in (scale, None):
                same = exact("nm_prune", (knp.nm_prune(x, sc, n, m),),
                             (knp.nm_prune_plain(x, sc, n, m),))
            print(f"  D={d} T={t} {dtype}: bit-exact={same}")
        x = torch.randn(256, d, generator=g, device=dev).bfloat16()
        ms = timer.ms(lambda: knp.nm_prune(x, scale, n, m))
        plain_ms = timer.ms(lambda: knp.nm_prune_plain(x, scale, n, m), 5)
        copy_ms = timer.ms(x.clone)
        bound = (2 * x.numel() * 2 + d * 4) / bw * 1e3
        print(f"  D={d} T=256: kernel {ms:.4f} ms, bound {bound:.4f} ms (bytes), plain "
              f"{plain_ms:.4f} ms, no single library call (x.clone(), the same bytes "
              f"moved, {copy_ms:.4f} ms)")
        if d == 14336:
            records["nm_prune"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                       bound_ms=bound, bound_by="bytes", max_abs_err=0.0)
    return records


def sdpa_ms(torch, timer, q, k, v, causal: bool):
    """The library yardstick of ``flash_attention``: one
    ``scaled_dot_product_attention`` call on the (B, H, T, hd) views, GQA
    by ``enable_gqa``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return timer.ms(lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True))


# the one-shot prefill's tile-consensus projections of Qwen2-7B: (name, D, N_out)
QWEN_SPARSE_PROJS = (("q", 3584, 3584), ("gate", 3584, 18944), ("down", 18944, 3584))


def time_nm_spmm(timer, kns, x, w, scale, n=8, m=16, tile=256):
    """``nm_spmm``'s whole call and its selection pass alone (CUDA events,
    L2 flushed): (call ms, selection ms)."""
    return (timer.ms(lambda: kns.nm_spmm(x, w, scale, n, m, tile)),
            timer.ms(lambda: kns.consensus_select(x, scale, n, m, tile)))


def nm_spmm_selection_split(torch, timer):
    """The split of ``nm_spmm``'s time between its selection pass and the
    rest at the one-shot prefill's shapes (T = 2048, 8:16, tile 256), for
    whichever ``repro_torch`` is first on ``sys.path``: a checkout of an
    earlier commit can be timed beside this one on the same card."""
    from repro_torch.kernels import nm_spmm as kns

    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for proj, d, n_out in QWEN_SPARSE_PROJS:
        w = (torch.randn(d, n_out, generator=g, device="cuda") * d**-0.5).bfloat16()
        scale = torch.rand(d, generator=g, device="cuda") + 0.5
        x = torch.randn(2048, d, generator=g, device="cuda").bfloat16()
        ms, sel_ms = time_nm_spmm(timer, kns, x, w, scale)
        print(f"  nm_spmm {proj} T=2048 ({kns.__file__}): call {ms:.4f} ms, selection "
              f"{sel_ms:.4f} ms ({sel_ms / ms:.1%}), the rest {ms - sel_ms:.4f} ms")


# nm_spmm's GEMM routes against each other: (projection, T, tile, the other
# route).  A short one-shot prefill (a single prompt of 256 or 512 tokens, or
# consensus tiles of 100 or 128 tokens), where the plan splits k or takes
# 128-row blocks, against one slice of 256-row blocks; and the T = 2048
# prefill's 256-row blocks against 128-row ones
_UNSPLIT_256, _BM_128 = ("wgmma", 256, 1), ("wgmma", 128, 1)
ROUTE_SWEEP = (("q", 256, 256, _UNSPLIT_256), ("down", 256, 256, _UNSPLIT_256),
               ("q", 512, 256, _UNSPLIT_256), ("down", 512, 256, _UNSPLIT_256),
               ("q", 512, 100, _UNSPLIT_256), ("gate", 512, 100, _UNSPLIT_256),
               ("down", 512, 100, _UNSPLIT_256), ("q", 512, 128, _UNSPLIT_256),
               ("down", 512, 128, _UNSPLIT_256), ("gate", 2048, 256, _BM_128),
               ("down", 2048, 256, _BM_128))


def nm_spmm_route_sweep(torch, timer, kns, g):
    """Each shape of ``ROUTE_SWEEP`` on the route ``gemm_plan`` gives it and
    on the other route, both checked against the plain version and timed in
    turn, plan / other / plan / other (each a median of 10 with the L2
    flushed); a route's time is the mean of its two medians."""
    dims = {proj: (d, n_out) for proj, d, n_out in QWEN_SPARSE_PROJS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = []
    for proj, t, tile, other in ROUTE_SWEEP:
        d, n_out = dims[proj]
        w = (torch.randn(d, n_out, generator=g, device="cuda") * d**-0.5).bfloat16()
        scale = torch.rand(d, generator=g, device="cuda") + 0.5
        x = torch.randn(t, d, generator=g, device="cuda").bfloat16()
        plan = kns.gemm_plan(x.dtype, t, d, n_out, 8, 16, tile, True, sms)
        want = kns.nm_spmm_plain(x, w, scale, 8, 16, tile)
        runs = {}
        for route in (plan, other, plan, other):
            fn = lambda: kns._launch(x, w, scale, 8, 16, tile, route)  # noqa: E731
            if route not in runs:
                errs.append(check_close(f"{proj} T={t} tile {tile} {route}", fn(), want,
                                        BF16_TOL))
            runs.setdefault(route, []).append(timer.ms(fn))
        a, b = (statistics.mean(runs[r]) for r in (plan, other))
        print(f"  route {proj} T={t} tile {tile}: plan {plan} {a:.4f} ms, {other} {b:.4f} ms "
              f"(plan/other {a / b:.2f})")
    return max(errs)


def phase_oneshot_kernels(torch, timer, rates):
    """flash_attention and nm_spmm against their plain versions at the
    one-shot Qwen2-7B prefill's shapes (4 prompts of 512 tokens)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import nm_spmm as kns

    bw, bf16_peak, f32_peak, _ = rates
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    dev = "cuda"
    records = {}

    # ----------------------------------------------------- flash_attention
    print("phase 2g: flash_attention (Qwen2-7B prefill: B=4, Hq=28, Hkv=4, hd=128)")
    b, hq, hkv, hd = 4, 28, 4, 128
    errs = []
    cases = (("T=512 causal", 512, True, 0, torch.bfloat16, hd),
             ("ragged T=300 causal", 300, True, 0, torch.bfloat16, hd),
             ("T=512 causal window=128", 512, True, 128, torch.bfloat16, hd),
             ("T=512 non-causal", 512, False, 0, torch.bfloat16, hd),
             ("head_dim 64 T=512 causal", 512, True, 0, torch.bfloat16, 64),
             ("head_dim 64 ragged T=300 non-causal", 300, False, 0, torch.bfloat16, 64),
             ("float32 T=300 causal", 300, True, 0, torch.float32, hd))
    for case, t, causal, window, dtype, hd_ in cases:
        q = torch.randn(b, t, hq, hd_, generator=g, device=dev).to(dtype)
        k = torch.randn(b, t, hkv, hd_, generator=g, device=dev).to(dtype)
        v = torch.randn(b, t, hkv, hd_, generator=g, device=dev).to(dtype)
        got = kfa.flash_attention(q, k, v, causal=causal, window=window)
        want = kfa.flash_attention_plain(q, k, v, causal=causal, window=window)
        errs.append(check_close(case, got, want,
                                BF16_TOL if dtype == torch.bfloat16 else F32_TOL))
        if case == "T=512 causal":
            ms = timer.ms(lambda: kfa.flash_attention(q, k, v, causal=True))
            plain_ms = timer.ms(lambda: kfa.flash_attention_plain(q, k, v, causal=True), 5)
            lib_ms = sdpa_ms(torch, timer, q, k, v, True)
            pairs = b * hq * t * (t + 1) // 2          # visible (query, key) pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            ops = 4 * hd * pairs
            bound = max(nbytes / bw, ops / bf16_peak) * 1e3
            by = "bytes" if nbytes / bw >= ops / bf16_peak else "operations"
            print(f"  T=512 causal: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), plain "
                  f"{plain_ms:.4f} ms, SDPA (is_causal, GQA) {lib_ms:.4f} ms; kernel/library "
                  f"{ms / lib_ms:.2f}, bound/kernel {bound / ms:.3f}")
            records["flash_attention"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                              bound_ms=bound, bound_by=by)
    records["flash_attention"]["max_abs_err"] = max(errs)

    # ------------------------------------------------------------- nm_spmm
    print("phase 2h: nm_spmm (Qwen2-7B q/gate/down, T=4x512, 8:16, tile 256)")
    n, m, tile = 8, 16, 256
    errs = []

    def check_selection(label, x, scale, t_tile):
        idx, xc = kns.consensus_select(x, scale, n, m, t_tile)
        idx0, xc0 = kns.consensus_select_plain(x, scale, n, m, t_tile)
        torch.cuda.synchronize()
        same = torch.equal(idx, idx0) and torch.equal(xc, xc0)
        print(f"  {label}: kept channels and compacted x bit-exact={same}")
        if not same:
            fail(f"nm_spmm {label}: the kernel's consensus selection differs from the plain "
                 "version's")

    for proj, d, n_out in QWEN_SPARSE_PROJS:
        w = (torch.randn(d, n_out, generator=g, device=dev) * d**-0.5).bfloat16()
        scale = torch.rand(d, generator=g, device=dev) + 0.5
        for t in (2048, 300):
            x = torch.randn(t, d, generator=g, device=dev).bfloat16()
            check_selection(f"{proj} T={t}", x, scale, tile)
            plan = kns.gemm_plan(x.dtype, t, d, n_out, n, m, tile, w.data_ptr() % 16 == 0)
            errs.append(check_close(f"{proj} T={t} {plan}", kns.nm_spmm(x, w, scale, n, m, tile),
                                    kns.nm_spmm_plain(x, w, scale, n, m, tile), BF16_TOL))
            if t != 2048:
                continue
            ms, sel_ms = time_nm_spmm(timer, kns, x, w, scale)
            plain_ms = timer.ms(lambda: kns.nm_spmm_plain(x, w, scale, n, m, tile), 5)
            idx, xc = kns.consensus_select_plain(x, scale, n, m, tile)
            wcs = [w.index_select(0, r) for r in idx]
            lib_ms = timer.ms(lambda: [torch.matmul(xc[i * tile:(i + 1) * tile], wc)
                                       for i, wc in enumerate(wcs)])
            rows = int(torch.unique(idx).numel())       # weight rows some tile reads
            kc = idx.shape[1]
            nbytes = (x.numel() + rows * n_out + t * n_out) * 2 + d * 4
            ops = 2 * t * kc * n_out
            bound = max(nbytes / bw, ops / bf16_peak) * 1e3
            by = "bytes" if nbytes / bw >= ops / bf16_peak else "operations"
            print(f"  {proj} T=2048: kernel {ms:.4f} ms = selection {sel_ms:.4f} ms + the rest "
                  f"{ms - sel_ms:.4f} ms (selection {sel_ms / ms:.1%} of the call); bound "
                  f"{bound:.4f} ms ({by}), plain {plain_ms:.4f} ms, torch.matmul(xc, w[idx]) "
                  f"per tile (gather and selection untimed) {lib_ms:.4f} ms; kernel/library "
                  f"{ms / lib_ms:.2f}, rest/library {(ms - sel_ms) / lib_ms:.2f}")
            rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                       bound_by=by, select_ms=sel_ms)
            # the record's own keys are gate's; q's and down's carry their prefix
            records.setdefault("nm_spmm", {}).update(
                rec if proj == "gate" else {f"{proj}_{k}": v for k, v in rec.items()
                                            if k != "bound_by"})
            del wcs
    errs.append(nm_spmm_route_sweep(torch, timer, kns, g))
    xf = torch.randn(300, 3584, generator=g, device=dev)
    wf = torch.randn(3584, 3584, generator=g, device=dev) * 3584**-0.5
    sf = torch.rand(3584, generator=g, device=dev) + 0.5
    check_selection("float32 q T=300", xf, sf, tile)
    errs.append(check_close("float32 q T=300", kns.nm_spmm(xf, wf, sf, n, m, tile),
                            kns.nm_spmm_plain(xf, wf, sf, n, m, tile), F32_TOL))
    errs.append(check_close("float32 q T=300 scale=None", kns.nm_spmm(xf, wf, None, n, m, tile),
                            kns.nm_spmm_plain(xf, wf, None, n, m, tile), F32_TOL))
    records["nm_spmm"]["max_abs_err"] = max(errs)
    return records


def make_requests(rng, n, lo, hi, vocab):
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(0, vocab, size=int(l)).astype(np.int32) for l in lens]


def serve_requests(torch, model, params, policy, label, eager=False):
    """8 staggered requests (64-700 prompt tokens, 32 new tokens each) through
    ``Engine.from_config`` after one warm-up request, with the launch counts
    set to 0 just before and read just after.  Every request must end
    ``done`` with its tokens, and every step bucket used must have been
    captured once (``trace_counts``).  ``eager``: every step runs its bucket's
    step program directly (``step_program``), with no graph, for the token
    comparison.  Returns (launches, per-path step counts, engine, outputs)."""
    from repro_torch import kernels
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.serve import ContinuousConfig, Engine, EngineConfig

    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    prompts = make_requests(rng, 8, 64, 700, cfg.vocab_size)
    arrivals = [0, 0, 1, 2, 4, 6, 9, 12]
    new = 32
    bsz = 16
    max_seq = -(-(max(len(p) for p in prompts) + new) // bsz) * bsz
    scfg = ContinuousConfig(num_slots=4, chunk_size=256, block_size=bsz, max_seq=max_seq)
    eng = Engine.from_config(model, EngineConfig(serving=scfg), policy=policy)
    if eager:       # the executor's step programs, each step run as it is
        eng.replica.exec._graphs.run = lambda name, fn, params: fn()
    # warm-up (library handles, allocator, and the graphs of the three buckets
    # the stream uses: a 40-token request decodes while a 300-token one is
    # prefilled), then the measured stream
    eng.submit(rng.integers(0, cfg.vocab_size, size=40), max_new_tokens=4)
    eng.submit(rng.integers(0, cfg.vocab_size, size=300), max_new_tokens=2, arrival=1)
    eng.run(params)
    eng.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rids = [eng.submit(p, max_new_tokens=new, arrival=a) for p, a in zip(prompts, arrivals)]
    res = eng.run(params)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    launches["osparse_matmul (prune=True)"] = kos.osparse_matmul.pruned_launches
    launches["osparse_matmul routes"] = dict(kos.osparse_matmul.route_launches)
    met = res["metrics"]
    states = {r["rid"]: r["state"] for r in met["requests"]}
    for rid in rids:
        out = res["outputs"][rid]
        if states[rid] != "done" or len(out) != new:
            fail(f"{label}: request {rid}: state {states[rid]}, {len(out)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in out):
            fail(f"{label}: request {rid}: token outside the vocabulary")
    bk = met["buckets"]
    outputs = [res["outputs"][rid] for rid in rids]
    if eager:
        print(f"  {label}, eager step programs: the same requests, tokens[0][:8] "
              f"{outputs[0][:8]}, wall {met['wall_s']:.3f} s")
        return launches, None, eng, outputs
    traces = eng.replica.trace_counts
    print(f"  trace_counts {traces} (graph captures per step bucket)")
    if set(bk) - set(traces) or any(n != 1 for n in traces.values()):
        fail(f"{label}: trace_counts {traces}: every bucket used ({sorted(bk)}) must be "
             "captured exactly once")

    def agg(names, key):
        return sum(bk[n][key] for n in names if n in bk)

    steps = dict(
        sparse_chunks=agg(("step_prefill", "step_prefill_decode"), "calls"),
        prefill_halves=agg(("step_prefill", "step_prefill_decode", "step_replay",
                            "step_replay_decode"), "calls"),
        decode_halves=agg(("step_decode", "step_prefill_decode", "step_replay_decode"),
                          "calls"))
    print(f"  prompts {[len(p) for p in prompts]}, arrivals {arrivals}, {new} new tokens each")
    print(f"  buckets {json.dumps(bk)}")
    print(f"  launches (replays counted) {launches}; {steps}")
    pf_tok = agg(("step_prefill", "step_prefill_decode"), "prefill_tokens")
    pf_s = agg(("step_prefill", "step_prefill_decode"), "seconds")
    dec_tok = agg(("step_decode",), "decode_tokens")
    dec_s = agg(("step_decode",), "seconds")
    print(f"  wall {met['wall_s']:.3f} s, {met['generated_tokens']} tokens generated, "
          f"{met['iterations']} iterations, dispatches/iteration "
          f"{met['dispatches_per_iteration']:.2f}")
    print(f"  prefill {pf_tok} tokens in {pf_s:.3f} s of prefill steps = "
          f"{pf_tok / pf_s:.1f} tok/s; decode-only steps {dec_tok} tokens in {dec_s:.3f} s "
          f"= {dec_tok / dec_s:.1f} tok/s")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"allocated (weights, cache, live activations), "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved (with the graph "
          f"pool's free blocks); held after the run {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB")
    return launches, steps, eng, outputs


def check_graphed_tokens(torch, model, params, policy, label, outputs):
    """The graphed run's tokens against the same requests run through the
    executor's step programs eagerly: identical."""
    _, _, eng, eager = serve_requests(torch, model, params, policy, label, eager=True)
    del eng
    if eager != outputs:
        diff = [i for i, (a, b) in enumerate(zip(outputs, eager)) if a != b]
        fail(f"{label}: graphed tokens differ from the eager step programs' in "
             f"requests {diff}")
    print(f"  {label}: graphed tokens identical to the eager step programs' "
          f"({len(outputs)} requests x {len(outputs[0])})")


def check_launches(label, launches, want):
    """Each kernel of the path launched, and exactly as often as expected."""
    for name, count in want.items():
        if launches[name] <= 0:
            fail(f"{label}: kernel {name} was never launched on the serving path")
        if launches[name] != count:
            fail(f"{label}: {name} launched {launches[name]} times, expected {count}")


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model

    cfg = get_config("llama31_8b")
    print(f"phase 3: serve {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype})")
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(SEED)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(use_kernels=True)
    precompute_scales(params, policy)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_w = sum(p.numel() for p in params.parameters())
    print(f"  random weights: {n_w / 1e9:.3f}B parameters in {t1 - t0:.1f} s; "
          f"Amber scales in {t2 - t1:.1f} s")
    per_chunk = sum(policy.should_prune(mod, i) for i in range(cfg.n_layers)
                    for mod in ("q_proj", "gate_proj", "down_proj"))
    if per_chunk != 86:
        fail(f"paper policy prunes {per_chunk} projections per chunk, expected 86")
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, "phase 3")
    per_step = cfg.n_layers * (st["prefill_halves"] + st["decode_halves"])
    check_launches("phase 3", launches, {
        "nm_prune_matmul": per_chunk * st["sparse_chunks"],
        "paged_kv_scatter": per_step, "paged_attention": per_step})
    profile_steps(torch, model, params, policy, eng)
    del eng
    check_graphed_tokens(torch, model, params, policy, "phase 3", outputs)
    return launches, model, params, policy


def phase_serve_osparse(torch, model, params, policy):
    """Phase 3's weights and Amber scales, rewritten to W8A8 on
    q/k/v/o/gate/up of every layer, served the same way."""
    from repro_torch.core import quant
    from repro_torch.weights import quantize_linears

    cfg = model.cfg
    qcfg = quant.QuantConfig()
    print(f"phase 3b: serve {cfg.name} Outstanding-sparse at full width (W8A8 "
          f"alpha={qcfg.alpha} outstanding={qcfg.outstanding} per_token="
          f"{qcfg.per_token_act} skip_modules={qcfg.skip_modules} skip_layers="
          f"{qcfg.skip_layers}; Amber 8:16 under the paper policy)")
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    absmax = {(i, name): calib_absmax(rng, cfg.d_model)
              for i in range(cfg.n_layers) for name in QPROJS}
    quantize_linears(params, absmax, qcfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_q = sum(b.numel() for n_, b in params.named_buffers() if n_.endswith(".wq"))
    print(f"  rewrite in {time.perf_counter() - t0:.1f} s: {n_q / 1e9:.3f}B int8 weights; "
          f"device memory held {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pruned = sum(policy.should_prune(mod, i) for i in range(cfg.n_layers)
                 for mod in ("q_proj", "gate_proj"))
    if pruned != 54:
        fail(f"paper policy prunes {pruned} quantized projections per chunk, expected 54")
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, "phase 3b")
    halves = st["prefill_halves"] + st["decode_halves"]
    per_step = cfg.n_layers * halves
    check_launches("phase 3b", launches, {
        "osparse_matmul": len(QPROJS) * cfg.n_layers * halves,
        "osparse_matmul (prune=True)": pruned * st["sparse_chunks"],
        "nm_prune_matmul": cfg.n_layers * st["sparse_chunks"],
        "paged_kv_scatter": per_step, "paged_attention": per_step})
    # decode projections in one fused launch, prefill chunks on wgmma: never
    # the per-token swap route or the simple dp4a route
    routes = {r: c for r, c in launches["osparse_matmul routes"].items() if c}
    print(f"  osparse_matmul launches by route {routes}")
    if not routes or not set(routes) <= {"wgmma", "swap_fused"}:
        fail(f"phase 3b: osparse_matmul launches by route {routes}, expected wgmma "
             "(prefill) and swap_fused (decode) only")
    profile_steps(torch, model, params, policy, eng)
    del eng
    check_graphed_tokens(torch, model, params, policy, "phase 3b", outputs)
    return launches


def profile_steps(torch, model, params, policy, eng):
    """One sparse 256-token prefill chunk (at offset 256) and one dense
    4-slot decode step at full width, through :func:`profile_cases`: each
    eagerly through the model, and as the executor of ``eng`` runs it, a
    replay of the bucket's graph (``Executor.step``: operands in, replay,
    sampling, one host read) on its own cache, with the same positions."""
    from types import SimpleNamespace

    from repro_torch.core.policy import DENSE
    from repro_torch.serve.scheduler import DecodeWork, PrefillWork, StepPlan

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(SEED)
    pcache = model.init_cache(1, 1024)
    pcache["pos"] = torch.tensor(256, dtype=torch.int32, device="cuda")
    ptoks = torch.randint(0, cfg.vocab_size, (1, 256), generator=g, device="cuda")
    dcache = model.init_cache(4, 1024)
    dpos = torch.tensor([700, 500, 300, 100], dtype=torch.int32, device="cuda")
    dcache["pos"] = dpos.clone()
    dtoks = torch.randint(0, cfg.vocab_size, (4, 1), generator=g, device="cuda")
    dense = DENSE.with_(use_kernels=True)
    ex = eng.replica.exec
    slots, mb = ex.cache["block_table"].shape
    ex.cache["block_table"].copy_(torch.arange(slots * mb, dtype=torch.int32,
                                               device="cuda").reshape(slots, mb))
    ppos = torch.tensor([256] + [0] * (slots - 1), dtype=torch.int32, device="cuda")
    prefill_plan = StepPlan(prefill=PrefillWork(
        SimpleNamespace(slot=0), ptoks.cpu().numpy().astype(np.int32), 256, False))
    decode_plan = StepPlan(decode=DecodeWork(
        [], dtoks[:, 0].cpu().numpy().astype(np.int32), np.ones(slots, dtype=bool)))

    def replay(plan, pos):
        ex.cache["pos"].copy_(pos)
        ex.step(params, plan)

    profile_cases(torch, {
        "prefill chunk (256 tokens, paper policy), eager":
            lambda: model.prefill_chunk(params, {"tokens": ptoks}, pcache, policy=policy),
        "prefill chunk, step_prefill graph replay":
            lambda: replay(prefill_plan, ppos),
        "decode step (4 slots, dense), eager":
            lambda: model.decode_step(params, dtoks, dcache, policy=dense),
        "decode step, step_decode graph replay":
            lambda: replay(decode_plan, dpos),
    })
    if any(n != 1 for n in ex.trace_counts.values()):
        fail(f"profile: trace_counts {ex.trace_counts}: a bucket was captured again")


# kernel families of the profiles: name → the full names of the port's CUDA
# kernels in it.  A profiler key belongs to a family when it holds one of
# these names as a whole identifier, so a kernel whose name holds another's
# is not taken for it; library kernels go by a fragment of their names.
FAMILIES = (("osparse_matmul", ("osparse_quant_kernel", "osparse_quant_vec_kernel",
                                "w8a8_wgmma_kernel", "w8a8_swap_kernel",
                                "w8a8_simple_kernel")),
            ("nm_prune_matmul", ("nm_select_kernel", "nm_select_vec_kernel",
                                 "nm_matmul_wgmma_kernel", "nm_splitk_reduce_kernel",
                                 "nm_matmul_bf16_kernel", "nm_matmul_f32_kernel",
                                 "wgmma_probe_kernel")),
            ("nm_spmm", ("consensus_select_kernel", "spmm_wgmma_kernel",
                         "spmm_splitk_reduce_kernel", "spmm_bf16_kernel", "spmm_f32_kernel")),
            ("flash_attention", ("flash_bf16_kernel", "attention_rows_kernel")),
            ("paged_attention", ("paged_wgmma_kernel", "paged_attention_kernel",
                                 "paged_attention_combine_kernel")),
            ("paged_kv_scatter", ("paged_kv_scatter_kernel",)))
LIBRARY_GEMM = ("cuBLAS GEMM", ("gemm", "nvjet", "cutlass", "xmma", "gemv"))
OTHER = "other (elementwise, norms, copies)"


def kernel_family(key: str) -> str:
    """The profile family of one profiler kernel key."""
    names = set(re.findall(r"[A-Za-z_]\w*", key))
    for name, kernels in FAMILIES:
        if names.intersection(kernels):
            return name
    low = key.lower()
    return LIBRARY_GEMM[0] if any(k in low for k in LIBRARY_GEMM[1]) else OTHER


def busy_time(spans) -> float:
    """Length of the union of ``(start, end)`` intervals: device time during
    which at least one kernel ran.  Kernels overlap where one is launched as
    a programmatic dependent of another (it starts early and waits), so the
    sum of kernel durations overstates it."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_cases(torch, cases):
    """Each case timed on the host (median of 5 synchronised runs after a
    warm-up) and traced once with ``torch.profiler``: device busy time (the
    union of the kernels' intervals), kernel time by family (summed
    durations, which count a kernel's wait on the one it depends on), kernel
    count, the device's idle share of the wall time, and the gaps between
    kernels (the span from the first kernel's start to the last one's end,
    less the busy time; the rest of the idle time lies outside that span,
    on the host).  The launch counts
    of a graph replay are its capture's.  Where the profiler records no
    device kernel (as it might inside a replay), the step's device time from
    CUDA events around it stands in for its busy time, an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.kernels import osparse_matmul as kos

    print("profile: one step of each kind, full width, bf16")
    for case, fn in cases.items():
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_ms = statistics.median(walls[1:]) * 1e3
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        calls = {k: v for k, v in kernels.launch_counts().items() if v}
        routes = {r: c for r, c in kos.osparse_matmul.route_launches.items() if c}
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = busy_time(spans) / 1e3
        span_ms = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3 if spans else 0.0
        summed_ms = sum(e.self_device_time_total for e in kern) / 1e3
        by_family = {name: 0.0 for name, _ in FAMILIES + (LIBRARY_GEMM,)}
        by_family[OTHER] = 0.0
        family_kernels = dict.fromkeys(by_family, 0)
        for e in kern:
            by_family[kernel_family(e.key)] += e.self_device_time_total / 1e3
            family_kernels[kernel_family(e.key)] += e.count
        if not kern:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            ev_ms = ev[0].elapsed_time(ev[1])
            print(f"  {case}: wall {wall_ms:.3f} ms (median of 5); the profiler recorded no "
                  f"device kernels: CUDA events around the step {ev_ms:.3f} ms (busy at most "
                  f"that), device idle share at least {max(0.0, 1 - ev_ms / wall_ms):.3f}; "
                  f"launches {calls}")
            continue
        print(f"  {case}: wall {wall_ms:.3f} ms (median of 5), device busy {busy_ms:.3f} ms "
              f"over {sum(e.count for e in kern)} kernels (their durations sum to "
              f"{summed_ms:.3f} ms), device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; "
              f"first kernel start to last kernel end {span_ms:.3f} ms: "
              f"{span_ms - busy_ms:.3f} ms of gaps between kernels")
        print(f"    launches {calls}; osparse_matmul launches by route {routes}")
        for name, ms in by_family.items():
            print(f"    {name}: {ms:.3f} ms, {family_kernels[name]} kernels")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"    top: {e.key[:90]} x{e.count}: {e.self_device_time_total / 1e3:.3f} ms")


# bfloat16 end to end (phases 4 and 5b, depth 2).  bf16 keeps 8 significant
# bits, and its rounding alone moves the plain path's last-token logits away
# from the float32 plain path on the same (bf16) weights: by e_ref, measured
# in the same run (a one-ulp change of an activation flips an N:M choice
# between two nearly equal scores, so the random-weight models amplify it
# well past one ulp of a logit).  The kernel path rounds in other places
# (its products and attention weights against cuBLAS and the plain loops),
# so it carries a noise of the same size, and the two bf16 paths may then
# differ by up to about twice e_ref; a wrong tile, row or head moves the
# logits by their own size.  Greedy tokens are reported, not checked: a
# near-tie picks either token, and the continuations then part.
BF16_E2E_FACTOR = 2.0


def check_bf16_logits(got, want, ref):
    """Kernel-path and plain-path bf16 logits (lists of tensors) against the
    float32 plain path's ``ref``: max |got - want| over all rows must be at
    most BF16_E2E_FACTOR times max |want - ref|, bf16 rounding's own effect."""
    e_ref = max(float((w.float() - r.float()).abs().max()) for w, r in zip(want, ref))
    e_kr = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    if not all(bool(g.float().isfinite().all()) for g in got):
        fail("bf16 logits: kernel path output is not finite")
    lim = BF16_E2E_FACTOR * e_ref
    print(f"  last-token logits: kernel vs plain max_abs_err={err:.3e} (limit {lim:.3e} = "
          f"{BF16_E2E_FACTOR} x the plain path's bf16 rounding effect {e_ref:.3e}; kernel path "
          f"vs float32 {e_kr:.3e}; largest |logit| "
          f"{max(float(r.float().abs().max()) for r in ref):.3e})")
    if not err <= lim:
        fail(f"bf16 logits: kernel vs plain {err} > {lim}")
    return err


def report_bf16_agreement(got, want, margins):
    """Greedy-token agreement of two bf16 paths and the smallest top-2 logit
    margin of the reference path (printed, not checked)."""
    pairs = [(a, b) for r in range(len(got)) for a, b in zip(got[r], want[r])]
    agree = sum(a == b for a, b in pairs)
    print(f"  greedy-token agreement {agree}/{len(pairs)} = {agree / len(pairs):.3f}; "
          f"smallest top-2 logit margin {min(margins):.3e}")


def phase_parity(torch, quantized: bool, dtype: str = "float32"):
    """Full width, depth 2: the same staggered requests through two paths,
    and each prompt's last-chunk logits (chunk by chunk on fresh caches).

    Phase 4 (bf16 weights' float32 twin): the kernel path against the plain
    path must emit the same greedy tokens; the logits agree within 2% of the
    largest.  Phase 4 bf16: the same in bfloat16, where the kernel path runs
    nm_prune_matmul's wgmma GEMM; logits held by :func:`check_bf16_logits`,
    greedy agreement printed.  Phase 4b
    (Outstanding-sparse): the kernel path against the same path with
    ``osparse_matmul``'s plain version in place of its kernel; the logits
    are bit-identical.  Against the fully plain path the W8A8 model cannot
    be held to token identity: the float kernels' summation order (~1e-5 in
    a ``down_proj`` output) moves int8 codes and N:M selections a step in
    the next layer, which these random weights and seeded scales amplify to
    ~0.5 in the logits, above the top-2 margin of some tokens; that
    comparison is printed, not checked."""
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.kernels import ops
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
    from repro_torch.weights import quantize_linears

    cfg = dataclasses.replace(get_config("llama31_8b"), n_layers=2, dtype=dtype)
    bf16 = dtype == "bfloat16"
    model = build_model(cfg)
    params = model.init(SEED + 1)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers)
    precompute_scales(params, policy)
    if bf16:
        print("phase 4 bf16: kernel path vs plain path, full width, depth 2, bfloat16")
    elif quantized:
        print("phase 4b: Outstanding-sparse kernel path vs the same path with "
              "osparse_matmul's plain version, full width, depth 2, float32")
        rng = np.random.default_rng(SEED + 4)
        quantize_linears(params, {(i, name): calib_absmax(rng, cfg.d_model)
                                  for i in range(cfg.n_layers) for name in QPROJS},
                         quant.QuantConfig())
    else:
        print("phase 4: kernel path vs plain path, full width, depth 2, float32")
    rng = np.random.default_rng(SEED + 1)
    prompts = make_requests(rng, 3, 64, 600, cfg.vocab_size)
    arrivals, new, bsz = [0, 1, 3], 8, 16
    max_seq = -(-(max(len(p) for p in prompts) + new) // bsz) * bsz
    scfg = ContinuousConfig(num_slots=2, chunk_size=256, block_size=bsz, max_seq=max_seq)
    kernel_osparse = ops.osparse_matmul

    def run(path, mdl=model, prm=params):
        """(greedy tokens, per-prompt last-chunk logits) on one path."""
        uk = path != "plain"
        if path == "plain osparse":
            ops.osparse_matmul = kos.osparse_matmul_plain
        try:
            pol = policy.with_(use_kernels=uk)
            eng = Engine.from_config(mdl, EngineConfig(serving=scfg), policy=pol)
            for p, a in zip(prompts, arrivals):
                eng.submit(p, max_new_tokens=new, arrival=a)
            outs = eng.run(prm)["outputs"]
            logits = []
            for prompt in prompts:
                cache = mdl.init_cache(1, max_seq, block_size=bsz)
                for s in range(0, len(prompt), 256):
                    chunk = torch.from_numpy(prompt[s:s + 256][None, :]).cuda()
                    lg, cache = mdl.prefill_chunk(prm, {"tokens": chunk}, cache, policy=pol)
                logits.append(lg)
            return outs, logits
        finally:
            ops.osparse_matmul = kernel_osparse

    got, got_logits = run("kernel")
    print(f"  prompts {[len(p) for p in prompts]}: kernel path {got}")
    want, want_logits = run("plain osparse" if quantized else "plain")
    margins = []
    for i, (a, b) in enumerate(zip(got_logits, want_logits)):
        top2 = torch.topk(b[0].float(), 2).values
        margins.append(float(top2[0] - top2[1]))
        print(f"  prompt {i}: top-2 logit margin {margins[-1]:.3e}")
        if bf16:
            continue
        if quantized:
            same = torch.equal(a, b)
            print(f"  prompt {i} last-chunk logits: bit-identical={same}")
            if not same:
                fail(f"prompt {i}: osparse_matmul kernel and plain version part in serving")
        else:
            # Tolerance: the kernel sums in another order than cuBLAS (~1e-6
            # relative in float32), and such a rounding-level difference in
            # an earlier layer's output can flip an N:M selection between two
            # nearly equal scores, swapping one of ~2048 kept channels of one
            # token's projection; 2% of the largest logit covers that and
            # nothing larger.
            check_close(f"prompt {i} last-chunk logits", a, b, 2e-2)
    if bf16:
        # the float32 plain path on the same bf16 weights, the reference
        model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        _, ref_logits = run("plain", model32, copy.deepcopy(params).float())
        check_bf16_logits(got_logits, want_logits, ref_logits)
        report_bf16_agreement([got[r] for r in sorted(got)], [want[r] for r in sorted(want)],
                              margins)
    elif got != want:
        fail(f"greedy tokens differ: kernel {got} vs plain {want}")
    else:
        print("  greedy tokens identical")
    if quantized:
        plain, plain_logits = run("plain")
        errs = [float((a - b).abs().max()) for a, b in zip(got_logits, plain_logits)]
        agree = [sum(x == y for x, y in zip(got[r], plain[r])) for r in got]
        print(f"  fully plain path (reported, not checked): last-chunk logits max_abs_err "
              f"{['%.3e' % e for e in errs]}, greedy tokens agreeing {agree} of {new}")
    del params, model
    torch.cuda.empty_cache()


def qwen_oneshot(torch, n_layers=None, dtype=None):
    """Qwen2-7B with ``attn_impl="flash"`` (depth and dtype optionally cut),
    random weights from ``SEED`` plus seeded q/k/v biases (the init leaves
    them zero, which would not exercise the bias add), the paper's policy in
    tile-consensus mode with Amber scales, and 4 seeded 512-token prompts."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen2_7b"), attn_impl="flash")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers, dtype=dtype)
    model = build_model(cfg)
    params = model.init(SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for blk in params.blocks:
        for lin in (blk.q_proj, blk.k_proj, blk.v_proj):
            lin.b.copy_(torch.randn(lin.b.shape, generator=g, device="cuda") * 0.1)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers, tile_consensus=True)
    precompute_scales(params, policy)
    rng = np.random.default_rng(SEED + 7)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 512))).cuda()
    return cfg, model, params, policy, prompts


def timed_generate(torch, eng, params, prompts, new):
    """Wall seconds of ``eng.generate`` (greedy) with 1 new token (the
    prefill replay and its sample) and with ``new`` tokens, each ended by a
    synchronise: (tokens, prefill seconds, decode seconds = the difference)."""
    batch = {"tokens": prompts}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(params, batch, max_new_tokens=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = eng.generate(params, batch, max_new_tokens=new)["tokens"]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return toks, t1 - t0, (t2 - t1) - (t1 - t0)


def phase_serve_oneshot(torch):
    """Phase 5: ``ServingEngine.generate`` at full Qwen2-7B width, one shot:
    4 prompts of 512 tokens, 32 new tokens each, launch counts exact."""
    from repro_torch import kernels
    from repro_torch.serve import ServeConfig, ServingEngine

    t0 = time.perf_counter()
    cfg, model, params, policy, prompts = qwen_oneshot(torch)
    policy = policy.with_(use_kernels=True)
    torch.cuda.synchronize()
    print(f"phase 5: one-shot serve {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, qkv_bias, {cfg.dtype}, attn_impl={cfg.attn_impl}); "
          f"tile-consensus 8:16, tile {policy.tile_size}; weights and scales in "
          f"{time.perf_counter() - t0:.1f} s")
    per_prefill = sum(policy.should_prune(mod, i) for i in range(cfg.n_layers)
                      for mod in ("q_proj", "gate_proj", "down_proj"))
    if per_prefill != 74:
        fail(f"paper policy prunes {per_prefill} projections per prefill, expected 74")
    b, t = prompts.shape
    new = 32
    eng = ServingEngine(model, policy, ServeConfig(max_seq=t + new))
    eng.generate(params, {"tokens": prompts[:, :64]}, max_new_tokens=4)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(params, {"tokens": prompts}, max_new_tokens=new)["tokens"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    peak_reserved = torch.cuda.max_memory_reserved() / 2**30
    if out.shape != (b, new) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"phase 5: tokens {tuple(out.shape)} outside ({b}, {new}) or the vocabulary")
    steps = new - 1
    want = {"nm_spmm": per_prefill, "flash_attention": cfg.n_layers,
            "paged_kv_scatter": cfg.n_layers * (1 + steps),
            "paged_attention": cfg.n_layers * steps}
    print(f"  launches (replays counted) {launches}")
    check_launches("phase 5", launches, want)
    if launches["nm_prune_matmul"] != 0:
        fail(f"phase 5: nm_prune_matmul launched {launches['nm_prune_matmul']} times")
    # prefill and decode timed from generate's wall time, three runs
    runs = [timed_generate(torch, eng, params, prompts, new) for _ in range(3)]
    for toks, _, _ in runs:
        if not torch.equal(toks, out):
            fail("phase 5: a timed run's greedy tokens differ from generate's")
    traces = eng.trace_counts
    print(f"  trace_counts {traces} (graph captures: prefill per (B, T), decode per B)")
    if set(traces) != {f"prefill_{b}x64", f"prefill_{b}x{t}", f"decode_{b}"} or any(
            n != 1 for n in traces.values()):
        fail(f"phase 5: trace_counts {traces}: each graph must be captured exactly once")
    pf = statistics.median(r[1] for r in runs)
    dec = statistics.median(r[2] for r in runs)
    print(f"  generate wall {wall:.3f} s; timed runs (prefill ms, decode s): "
          f"{[(round(r[1] * 1e3, 3), round(r[2], 4)) for r in runs]}; median prefill "
          f"{pf * 1e3:.3f} ms = {b * t / pf:.1f} prefill tok/s; median decode {b * steps} "
          f"tokens in {dec:.4f} s = {b * steps / dec:.1f} tok/s; peak device memory "
          f"{peak:.2f} GiB allocated (weights, the engine's cache, live activations), "
          f"{peak_reserved:.2f} GiB reserved (with the graph pool's free blocks)")
    print(f"  tokens[0][:8] {out[0, :8].tolist()}")
    # the same generate with every program run as it is, no graph
    eager = ServingEngine(model, policy, ServeConfig(max_seq=t + new))
    eager._graphs.run = lambda name, fn, params: fn()
    eager_out = eager.generate(params, {"tokens": prompts}, max_new_tokens=new)["tokens"]
    if not torch.equal(eager_out, out):
        fail("phase 5: graphed tokens differ from the eager programs' tokens")
    print("  graphed tokens identical to the eager programs' tokens")
    del eager
    cache = model.init_cache(b, t + new)
    dcache = model.init_cache(b, t + new)
    _, dcache = model.prefill(params, {"tokens": prompts}, dcache, policy=policy)
    dtoks = out[:, :1].contiguous()
    ecache = eng._state[b]["cache"]

    def decode_replay():
        ecache["pos"].fill_(t)
        eng._graphs.run(f"decode_{b}", None, params)

    profile_cases(torch, {
        "one-shot prefill (4 x 512 tokens, tile consensus, flash), eager":
            lambda: model.prefill(params, {"tokens": prompts}, cache, policy=policy),
        "one-shot prefill, graph replay (generate with 1 new token)":
            lambda: eng.generate(params, {"tokens": prompts}, max_new_tokens=1),
        "one-shot decode step (4 rows at 512, dense), eager":
            lambda: model.decode_step(params, dtoks, dcache, policy=eng.decode_policy),
        "one-shot decode step, graph replay":
            decode_replay,
    })
    if any(n != 1 for n in eng.trace_counts.values()):
        fail(f"phase 5: trace_counts {eng.trace_counts}: a graph was captured again")
    del params, model, eng, cache, dcache, ecache
    torch.cuda.empty_cache()
    return launches


def phase_parity_oneshot(torch, dtype: str = "float32"):
    """Phase 5b: Qwen2-7B at full width, depth 2, one shot: the kernel path
    (flash_attention, nm_spmm, paged kernels in decode) against the plain
    path (the chunked attention, nm_spmm's plain version, the paged
    oracles).  In float32: identical greedy tokens, and last-token prefill
    logits within 2% of the largest.  In bfloat16 (flash_attention's wgmma
    kernel): logits held by :func:`check_bf16_logits`, greedy agreement
    printed."""
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServingEngine

    bf16 = dtype == "bfloat16"
    print("phase 5b: one-shot kernel path vs plain path, Qwen2-7B full width, depth 2, "
          f"{dtype}")
    cfg, model, params, policy, prompts = qwen_oneshot(torch, n_layers=2, dtype=dtype)
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="chunked"))
    b, t = prompts.shape
    new = 16
    res = {}
    for path, mdl, uk in (("kernel", model, True), ("plain", plain_model, False)):
        pol = policy.with_(use_kernels=uk)
        eng = ServingEngine(mdl, pol, ServeConfig(max_seq=t + new))
        toks = eng.generate(params, {"tokens": prompts}, max_new_tokens=new)["tokens"]
        logits, _ = mdl.prefill(params, {"tokens": prompts}, mdl.init_cache(b, t + new),
                                policy=pol)
        res[path] = (toks.tolist(), logits)
    got, want = res["kernel"], res["plain"]
    margins = []
    for i in range(b):
        top2 = torch.topk(want[1][i].float(), 2).values
        margins.append(float(top2[0] - top2[1]))
        print(f"  row {i}: top-2 logit margin {margins[-1]:.3e}")
    if bf16:
        # the float32 plain path on the same bf16 weights, the reference
        model32 = build_model(dataclasses.replace(cfg, attn_impl="chunked", dtype="float32"))
        ref, _ = model32.prefill(copy.deepcopy(params).float(), {"tokens": prompts},
                                 model32.init_cache(b, t + new),
                                 policy=policy.with_(use_kernels=False))
        check_bf16_logits(list(got[1]), list(want[1]), list(ref))
        report_bf16_agreement(got[0], want[0], margins)
        del params, model, plain_model, model32
        torch.cuda.empty_cache()
        return
    # Tolerance: the kernels sum in another order than the plain path
    # (~1e-6 relative in float32), and such a difference can move a tile's
    # L2-pooled score across a near-tie and swap one kept channel of a group
    # for all 256 tokens of a tile; 2% of the largest logit covers that and
    # nothing larger.
    check_close("last-token prefill logits", got[1], want[1], 2e-2)
    if got[0] != want[0]:
        fail(f"phase 5b: greedy tokens differ: kernel {got[0]} vs plain {want[0]}")
    print(f"  greedy tokens identical ({b} rows x {new})")
    del params, model, plain_model
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run it from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 "
          f"matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; bf16 reduced-precision reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    print(f"rates used for bounds: {rates[0] / 1e12:.2f} TB/s, {rates[1] / 1e12:.0f} "
          f"TFLOP/s bf16, {rates[2] / 1e12:.0f} TFLOP/s fp32, {rates[3] / 1e12:.0f} TOP/s int8")

    t = time.perf_counter()
    info = _build.build()
    print(f"phase 1: kernels built in {info['seconds']:.1f} s into {info['dir']}")
    for src, log in info["logs"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    check_hgmma(info["dir"], info["logs"])
    timer = Timer(torch)
    t1 = time.perf_counter()
    records = phase_kernels(torch, timer, rates)
    records.update(phase_int8_kernels(torch, timer, rates))
    records.update(phase_oneshot_kernels(torch, timer, rates))
    del timer
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    launches, model, params, policy = phase_serve(torch)
    t3 = time.perf_counter()
    q_launches = phase_serve_osparse(torch, model, params, policy)
    del model, params
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    phase_parity(torch, quantized=False)
    phase_parity(torch, quantized=False, dtype="bfloat16")
    phase_parity(torch, quantized=True)
    t5 = time.perf_counter()
    o_launches = phase_serve_oneshot(torch)
    t6 = time.perf_counter()
    phase_parity_oneshot(torch)
    phase_parity_oneshot(torch, dtype="bfloat16")
    t7 = time.perf_counter()
    print(f"phase seconds: build {t1 - t:.1f}, kernels {t2 - t1:.1f}, serve {t3 - t2:.1f}, "
          f"serve osparse {t4 - t3:.1f}, parity {t5 - t4:.1f}, one-shot serve {t6 - t5:.1f}, "
          f"one-shot parity {t7 - t6:.1f}")

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import nm_prune as knp
    from repro_torch.kernels import nm_prune_matmul as knm
    from repro_torch.kernels import nm_spmm as kns
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import w8a8_matmul as kw8
    # launches: each kernel's count in the serving run of its path (phase 3,
    # 3b for osparse_matmul, 5 for flash_attention and nm_spmm); w8a8_matmul
    # and nm_prune are entry points that no serving path calls
    meta = {
        "nm_prune_matmul": (knm.SOURCE, knm.REPLACES, launches),
        "paged_kv_scatter": (kpa.SOURCE, kpa.SCATTER_REPLACES, launches),
        "paged_attention": (kpa.SOURCE, kpa.ATTENTION_REPLACES, launches),
        "osparse_matmul": (kos.SOURCE, kos.REPLACES, q_launches),
        "w8a8_matmul": (kw8.SOURCE, kw8.REPLACES, q_launches),
        "nm_prune": (knp.SOURCE, knp.REPLACES, q_launches),
        "flash_attention": (kfa.SOURCE, kfa.REPLACES, o_launches),
        "nm_spmm": (kns.SOURCE, kns.REPLACES, o_launches),
    }
    line = {"kernels": [dict(name=k, route="cuda", source=src, replaces=rep,
                             launches=counts[k], **records[k])
                        for k, (src, rep, counts) in meta.items()]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
