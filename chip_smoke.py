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
             heads (G = 4), at Qwen2-7B's (28 / 4, G = 7) and at
             Qwen3-30B-A3B's (32 / 4, G = 8: decode and a chunk), float32;
             each case's route and time, and the chunk's cost per call and
             per 64-key tile from three key lengths.  2f: ``nm_prune``
             bit-exact, also at the MoE path's expert inputs (T = 256 x
             D = 2048, T = 2048 x D = 768, and T = 2048 x D = 2048, no
             scale), and its ``torch.autograd.Function``'s backward at the
             first two with a zero group kept: output and ``dX``
             bit-exact against ``where(mask, dY, 0)``, the forward with the
             keep-mask timed beside the one without.  2i: the grouped product of the MoE layers (one
             ``torch._grouped_mm`` call, a library call) against its
             per-expert loop at Qwen3-30B-A3B's widths, with empty groups,
             timed beside its bound, and its backward at 13f's 4 x 512 x 8
             routed rows (``dX`` and ``dW`` within ``BF16_TOL`` of the loop's,
             an empty group's ``dW`` 0); its profiler kernels must fall in the
             profiles' "grouped product" family.  2g/2h: ``flash_attention`` and
             ``nm_spmm`` at the one-shot Qwen2-7B prefill's shapes (4 x 512
             tokens), with ragged, windowed, non-causal and float32 cases;
             ``nm_spmm``'s consensus selection must be bit-exact, and is
             timed alone beside the whole call; its GEMM's routes (k split,
             128- or 256-row blocks) are checked and timed against each
             other where the plan chooses them.  2j: the dense variants'
             shapes: ``paged_attention`` chunk and decode at G = 5, 16 and
             48 and at head_dim 80 (wgmma, head_dim 80 on the 128-column
             tile) over NaN-poisoned pools, ``paged_kv_scatter`` at 80 x 32
             KV heads and at one KV head, ``flash_attention`` at head_dim 80
             and G = 16 and at RecurrentGemma-2B's heads (10 / 1 at head_dim
             256, T = 4096, window 2048: the 256-column tile), each with its
             route printed, ``nm_prune_matmul`` at their q/gate/down widths,
             ``osparse_matmul`` at Qwen2.5-32B q and k with their biases
             (bit-exact), each timed beside its bound and library call.
             2k: ``nm_prune_matmul`` at the widths of all seven of
             LLaMA-3.1-8B's projections and the scan's 512 rows, 8:16 with
             an Amber scale (9a's probes) and 2:4 with none (9c's Naive
             run), and ``osparse_matmul`` at
             Qwen3-30B-A3B's attention (q/k/v/o at a chunk and a decode
             step, q per-token; bit-exact), timed the same way.  2l: the
             sliding-window band: ``paged_attention`` with ``window`` over
             NaN-poisoned pools at ``tests/test_kernels.py``'s window case
             (head_dim 16, the rows kernel, bf16 and float32) and at
             Mixtral-8x7B's heads (G = 4, window 4096, 6144-row tables): a
             256-row chunk at q_offset 4800 and a B = 4 decode around 5000,
             bf16 on the wgmma kernel and float32 on the rows kernel, timed
             beside their bounds and SDPA with the same band;
             ``flash_attention`` at B = 1, T = 6144, window 4096;
             ``nm_prune_matmul`` at Mixtral's q and ``nm_prune`` at its
             routed experts' inputs (bit-exact).  2m: ``nm_prune_matmul``
             at RWKV6-7B's (4096², 4096 x 14336, 14336 x 4096) and
             RecurrentGemma-2B's (2560², 2560 x 7680, 7680 x 2560) pruned
             widths, at 256 rows and the dyadic tails 64, 8 and 1.  2n:
             ``flash_attention`` non-causal over keys of another length,
             Whisper-medium's cross-attention (16 / 16 heads of 64 over
             S = 1500 encoder rows, an edge key tile): a 256-query chunk
             and a decode batch of 4, bf16 on the wgmma and the rows route
             (a misaligned q) and float32 on rows, against SDPA;
             ``paged_attention`` at Qwen2-VL-2B's G = 6 (12 / 2 heads of
             128), chunk and decode; ``nm_prune_matmul`` at Whisper-medium's
             (1024², 1024 x 4096, 4096 x 1024, biased) and Qwen2-VL-2B's
             (1536² biased, 1536 x 8960, 8960 x 1536) widths at 256 and
             1500 rows.  2o: ``osparse_matmul`` (8:16 pruned, the static
             scale) at the W8A8 rewrites' widths: RWKV6-7B's 4096² and 4096 x
             14336 at 256 rows and the dyadic tails 64, 8 and 1 (swap_fused at
             8 and 1), Whisper-medium's biased 1024² and 1024 x 4096 at 256
             and 1500 rows; bit-exact, each on its plan's route, timed beside
             its bound and ``torch._int_mm`` with the dequant.
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
6. serve CLI and serving lifecycle — 6b-6e run right after phase 3, on
             its model, weights and requests (3b rewrites the weights): 6b
             the legacy two-program split (``fused_step=False``): tokens
             identical to phase 3's, the ``prefill`` and ``decode`` programs
             captured once each, more than one dispatch per work iteration,
             launch counts exact; 6c a ``FaultInjector`` crash in a decode
             iteration and one in a prefill iteration, each restored from
             the last snapshot (``snapshot_every=1``) into a new engine after
             the crashed one was dropped (and must be gone): tokens
             identical, ``restores`` = 2, every engine's programs captured
             once; 6d ``pool.alloc`` exhausted at the first two admissions
             and ``admit`` transient at the third: tokens identical,
             admission retries; 6e a ``nonfinite`` decode fault at iteration
             10, after a warm-up that captured every bucket, must raise
             ``FloatingPointError`` from the replay, and nothing else passes;
             6g two replicas behind the router (``EngineConfig(dp=2)``, one
             after another on the card), each warmed up, phase 3's stream:
             tokens identical, both replicas served, each replica's every
             bucket captured once, 86 ``nm_prune_matmul`` a sparse chunk
             summed over the two, merged and per-replica tok/s and peak
             memory; 6h the same at ``dp=2`` with a crash at decode iteration
             3: one crash, its requests transplanted to the survivor, the
             others' tokens identical to phase 3's; a transplanted request's
             tokens emitted before the crash identical, and every token after
             it the argmax of the eager replay path (``eager_rows``: the
             prompt's chunks, the emitted tokens as one dense chunk, then one
             decode step a token, fed the served tokens) or within one ulp
             of it (``near_tie``); where it parts from phase 3's tokens,
             phase 3's token within one ulp of the served one on the eager
             decode and replay paths (a 4-slot batch rounds otherwise than
             one row); how many of those positions a replay that lost the
             emitted tokens' K/V would fail printed; the degraded fleet's
             snapshot refused.
             After phase 5b: 6a ``repro_torch.launch.serve.main`` in this
             process, ``--trace`` at full LLaMA-3.1-8B width (16 Poisson
             requests, 64-700 tokens behind a 128-token shared prefix, 32
             new tokens, 4 slots, chunk 256): rc 0, every ``# traces:``
             entry 1, ``1.00 per work iteration``, prefix-cache hits, all 16
             requests done, and ``nm_prune_matmul``, ``paged_kv_scatter`` and
             ``paged_attention`` launched (counts set to 0 just before); its
             report lines are echoed; 6f the one-shot CLI on Qwen2-7B (4 x
             512 tokens, 32 new): rc 0 and its agreement line; 6a' the
             ``--trace`` CLI with ``--dp 2`` (6a's flags without the shared
             prefix, which affinity would send to one replica): both replicas
             served, each replica's programs captured once, launches exact.

7. MoE    — Qwen3-30B-A3B, the paper's MoE model, after phases 3-6 freed
             their models.  7a: ``Engine`` at full width and depth (48
             layers, 128 experts top-8, random weights from a seed made on
             the card, ~57 GiB of bf16) under ``paper_policy(8, 16, (41,
             46, 47))`` with the kernels, phase 3's stream and warm-up:
             every bucket captured once, launches exact (per sparse chunk
             45 ``nm_prune_matmul`` (q in 48 - 3 layers) and 96 ``nm_prune``
             (the routed experts' gate and down inputs in all 48 layers:
             the skip list does not reach them); 48 ``paged_kv_scatter`` and
             48 ``paged_attention`` per prefill or decode half), graphed
             tokens equal to the eager programs'.  7b: the profiles of
             phase 3 with the grouped product as a family of its own, its
             device time beside its bound for each case's own routing.  7c:
             full width, depth 4, bf16, q/gate skipped in layer 3: kernel
             path against plain path (``nm_prune_plain``, the per-expert
             loop, the plain attention) and float32: logits within twice
             the plain path's own bf16 effect; each layer alone on the
             plain path's inputs routes identically on both paths and is
             held to the same gate.  7e: 7a's weights with q/k/v/o
             rewritten Outstanding-sparse in place (``QuantConfig()``, the
             static per-tensor scale, 3b's seeded calibration; the routed
             experts stay bf16, as the reference's), served with phase 3's
             stream: launches exact (``osparse_matmul`` 4 a layer per prefill
             or decode half, 45 of them pruned a sparse chunk; 96
             ``nm_prune``; no ``nm_prune_matmul``), every ``osparse_matmul``
             launch on its wgmma or swap_fused route, the peak allocated
             memory at most 7a's, the int8 bytes printed, a chunk and a
             decode step profiled, graphed tokens equal to the eager
             programs'.  7e': 7c's depth-4 model in W8A8,
             static and per-token activation scales: kernel path against
             plain path, logits within 7c's bf16 gate, and each quantized
             projection's int8 codes and scales bit-exact on the plain
             path's inputs.  7d: the ``--trace`` CLI at full width with
             phase 6a's flags, its launches exact.
8. dense variants — after phase 7 freed its model (less than 1 GiB may
             still be allocated), each bf16 from a seed with seeded
             nonzero LayerNorm and q/k/v biases, under ``paper_policy(8,
             16, ())`` with the kernels (q, gate and down pruned in every
             layer), served as phase 3 serves LLaMA-3.1-8B (its stream and
             warm-up, every bucket captured once, launches exact, a chunk
             and a decode step profiled, graphed tokens equal to the eager
             programs', peak memory printed), with ``attention_plan``'s
             route of its chunk and decode step: 8a Qwen2.5-32B at full
             width, depth 16 of its 64 layers (cut to make room for
             phases 14 and 15 in the run's time; 40/8 heads, q/k/v
             biases; 48 ``nm_prune_matmul`` a chunk); 8b the same weights rewritten
             Outstanding-sparse as in 3b, every ``osparse_matmul`` launch on
             its wgmma or swap_fused route with the q/k/v biases in the
             epilogue; 8c ChatGLM3-6B (depth 16 of 28 layers, 2-D RoPE,
             G = 16); 8d StableLM-3B (depth 16 of 32 layers, LayerNorm,
             head_dim 80: the wgmma kernel's 128-column tile; both at full
             depth until phase 15 needed the time); every served model's
             ``paged_attention`` launches all on the wgmma route, none on
             rows; 8e Granite-34B at full width and depth 8 (MQA,
             G = 48: its 88 layers take 88 GiB of bf16, which no one
             80 GB card holds).  8f: phases 4 and 4 bf16 for each of the
             four at full width and depth 2 (the float32 kernel path's
             ``paged_attention`` launches all on the rows route, the bf16
             path's none).  Each subphase's seconds are
             printed.  Phases 4 and 8f (float32) count the N:M flips
             between the kernel and plain paths on prompt 0, per projection
             and layer.
9. layer skipping — the paper's tooling (``core.sensitivity``,
             ``core.weight_sparsity``, ``data.pipeline``) on LLaMA-3.1-8B at
             full width, bf16, random weights from a seed with
             ``benchmarks/common.py``'s outlier channels (8 embedding
             channels x 12), every projection's Amber scale, after phase 8
             freed its models.  9a: ``sensitivity_scan`` over all 7
             projections of the 32 layers on 2 x 256 tokens of ``lm_batch``
             with the kernels: exactly one ``nm_prune_matmul`` launch per
             probe (224) and none in the dense pass; the ``sensitivity/*``
             rows, ``select_qgate_skips`` at a 0.55 target (its coverage
             must reach 0.55) and ``coverage/*`` of the paper's three
             models; then the q_proj and gate_proj probes (all that the
             selection reads) on the plain path, its skips printed beside.
             9b: phase 3's stream served under
             ``paper_policy(8, 16, <9a's skips>)``: tokens valid, launches
             exact, graphed tokens equal to the eager programs', tok/s beside
             phase 3's.  9c: ``magnitude_nm``, ``wanda_nm`` and
             ``sparsegpt_nm`` at 2:4 on every projection (statistics from one
             ``calibration_stream`` batch), every mask a valid 2:4 pattern
             along d_in, and the ``appendix_a/*`` perturbations beside
             ``naive_policy(2, 4)``'s (224 ``nm_prune_matmul``).  9a': depth
             2, float32, kernel path against plain path: e within
             ``SCAN_RTOL``, identical skips, N:M flips per probe.
10. Mixtral-8x7B and the dense slab — after phase 9 freed its models.
             10a: ``Engine`` at full width (d_model 4096, 32 / 8 heads, 8
             experts x d_ff 14336 top-2, window 4096), depth 8 of 32 (all 32
             layers are 87 GiB of bf16, more than one card holds; 16 until
             phase 15 needed the time), on the dense per-slot slab (its
             rings are never paged: 4 slots x 8 layers x 4096 rows) under
             ``paper_policy(8, 16, ())`` with the kernels: phase 3's 8
             requests plus two of 4500-5000 tokens (their rings wrap), 32
             new tokens each, chunk 256, max_seq 6144; every bucket
             captured once, launches exact (per sparse chunk 16
             ``nm_prune_matmul`` and 32 ``nm_prune``; no paged kernel: the
             ring's attention and writes are plain torch, as the reference
             computes them outside Pallas), tok/s and peak memory, a chunk at
             4800 and a decode step profiled with the grouped product beside
             the bound of its own routing, graphed tokens equal to the eager
             programs'.  10b: one-shot ``generate`` with
             ``attn_impl="flash"`` at B = 1, T = 6144 (``flash_attention``
             with the window band, 16 a prefill) on the ring layout, 32 new
             tokens, graphs captured once, tokens equal to the run without
             graphs.  10c: depth 2, a 4600-token and a 300-token prompt,
             kernel path against plain path: float32 greedy tokens
             identical, bf16 logits within phase 4's gate.  10d:
             LLaMA-3.1-8B ``--trace --no-paged`` through the CLI at full
             width (phase 6a's stream without its shared prefix): its report
             with ``# paged KV: disabled``, launches exact; then depth 2 in
             float32: the slab's greedy tokens equal the paged pool's.
11. the recurrent families — after phase 10 freed its models, on the
             dense slab in exact dyadic chunks (every prefill chunk a power
             of two; each step program captured once per chunk length it
             ran, which ``trace_counts`` must equal, counted from the plans),
             under ``paper_policy(8, 16, ())`` with the kernels.  11a:
             RWKV6-7B at full width, depth 8 of its 32 layers (cut to
             make room for phases 14 and 15 in the run's time; all 32: 7.53B
             parameters),
             phase 3's stream: launches exact (48 ``nm_prune_matmul`` a
             sparse chunk: r/k/v/g as q_proj, the channel mix's gate and
             down; no attention kernel), tok/s, peak memory and the seconds
             spent capturing; a 256-token chunk and a decode step profiled
             eagerly and replayed, with the recurrence as a family of its
             own (its calls recorded and timed alone, eager and as one
             graph), layer 0's chunked WKV held to its token loop within
             ``F32_TOL``; graphed tokens equal to the eager programs'.  11b:
             RecurrentGemma-2B at full width, depth 14 of its 26 layers
             (4 periods and the 2-layer tail; cut for phase 15's time) the
             same way, with two more requests of 2300-2600 tokens so that
             its 2048-row rings wrap (max_seq 4096): 52 ``nm_prune_matmul``
             a sparse chunk.  11c: its one-shot ``generate`` with
             ``attn_impl="flash"`` at B = 1, T = 4096: 4 ``flash_attention``
             (the 256-column tile) and 52 ``nm_prune_matmul`` a prefill,
             graphs captured once, tokens equal to the run without graphs.
             11d: both at full width, depth 2 (RWKV6-7B) and 5
             (RecurrentGemma-2B): float32 kernel path against plain path,
             identical greedy tokens (N:M flips printed); bf16 logits within
             phase 4's gate; W8A8 (``QuantConfig()``) in float32: on the
             kernel path's N:M selections and int8 codes identical greedy
             tokens and logits within ``FORCED_W8A8_TOL`` (0.1%) of the
             largest, free-running identical tokens for RWKV6-7B (the
             difference printed for RecurrentGemma-2B, whose float32
             selections already flip).  11e (after 11a, on its weights): RWKV6-7B
             rewritten to W8A8 from a seeded calibration absmax, 11a's stream:
             per layer 7 ``osparse_matmul`` a step half (r/k/v/g as q_proj, o,
             the channel mix's gate and up), 5 of them pruned a sparse chunk,
             and ``nm_prune_matmul`` for the value projection (``down_proj``,
             left bf16), every int8 launch on wgmma (chunks) or swap_fused
             (decode, tails of at most 16 rows), profiled as 11a, graphed
             tokens equal to the eager programs'.
12. the modality families — after phase 11 freed its models, with
             seeded nonzero biases, under ``paper_policy(8, 16, ())`` with
             the kernels, through ``Engine.run(params, extras)``: every
             request's seeded stub goes with its first prefill chunk, and
             ``trace_counts`` must read 2 for each prefill program (with
             and without extras) and 1 for decode.  12a: Whisper-medium at
             full width, 6 + 6 of its 24 + 24 layers (cut to make room
             for phases 14 and 15 in the run's time; 16 heads of 64,
             encoder_seq 1500)
             on the dense slab, phase 3's stream with ``frame_embeds (1,
             1500, 1024)``: launches exact (``nm_prune_matmul`` 42 a first
             chunk, 24 a later one: the encoder-decoder passes no layer
             index, so q, fc1 and fc2 prune in every encoder layer and self
             q, cross q, fc1 and fc2 in every decoder layer; no attention
             kernel: the reference's encoder-decoder attention is plain),
             tok/s, peak memory, a first chunk (with the encoder), a later
             chunk and a decode step profiled, graphed tokens equal to the
             eager programs'.  12b: its one-shot ``generate`` at B = 4,
             T = 256 with ``frame_embeds``: 84 ``nm_prune_matmul`` a
             prefill, graphs captured once, tokens equal to the run
             without graphs.  12c: Qwen2-VL-2B at full width, depth 14 of
             its 28 layers (cut to make room for phase 15; 12 / 2 heads of
             128, M-RoPE), paged, phase 3's stream with
             ``pixel_embeds (1, 64, 1536)`` behind two text-only requests
             sharing a 32-token prefix: 42 ``nm_prune_matmul`` a sparse
             chunk, 14 ``paged_kv_scatter`` and 14 ``paged_attention`` a
             step half, every one on wgmma, prefix hits from the text-only
             pair alone; profiled and token-checked as 12a.  12d: both at
             full width, depth 2: float32 kernel path against plain path
             (identical greedy tokens, logits within 2%, N:M flips
             printed), bf16 logits within phase 4's gate; Whisper-medium in
             W8A8, float32: each prompt's last-chunk logits against the plain
             path on the kernel path's N:M selections and int8 codes within
             ``FORCED_W8A8_TOL`` (0.1%).  12e (after 12b, on 12a's weights):
             Whisper-medium rewritten to W8A8 (every attention's q/k/v/o and
             fc1; fc2 left bf16), served as 12a: per decoder layer 7
             ``osparse_matmul`` a step half (3 pruned) and 1
             ``nm_prune_matmul`` a sparse chunk, on a first chunk 5 + 1 more
             per encoder layer and the cross k/v per decoder layer, every
             int8 launch on its route, profiled and token-checked as 12a.
13. training — after phase 12 freed its models (``phase_training``).
             13a: LLaMA-3.1-8B at full width, depth 4 of 32 (32 layers'
             weights, gradients and float32 AdamW moments, ~100 GiB, do
             not fit the card; 16 until phase 15, 8 until 13f-13h needed
             the time), bf16, remat, dense:
             six ``make_train_step`` steps at ``DataConfig(seq_len=512,
             global_batch=4)``, ``OptConfig(lr=3e-4, warmup_steps=2,
             total_steps=6)``: a finite loss and ``grad_norm`` every step,
             every leaf's AdamW moment moved by step 1 and every leaf whose
             step exceeds half a bf16 ulp moved; the step's wall time
             (median of steps 2-6), tokens/s, its model FLOPs against the
             bf16 peak, the optimizer pass alone against its byte bound (22
             B a parameter), peak memory, a checkpoint's write rate and one
             step profiled.  13b: the same with ``--sparse-train``'s policy
             on the kernels: ``nm_prune_matmul`` exactly 24 times a step
             (q, gate and down in 4 layers, run again by remat), nothing
             else.  13c: full width, depth 2, float32, one batch of 1 x 256
             with a 16-channel group of layer 0's RMSNorm weight zeroed (a
             zero group in every row of its q input, whose first 8 are
             kept): every gradient of the kernel path (``PruneMatmul``)
             within ``F32_TOL`` of the plain path's on the kernel path's
             N:M selections; the free-running flips printed.  13d: the CPU
             tests' crash and resume on the card (smoke width, 12 steps, a
             crash at 7, resume from 5): the final loss within rel 1e-5 of
             the uninterrupted run; bit-identity printed.  13e: ``python -m
             repro_torch.launch.train --arch llama31_8b --smoke --steps 20
             --sparsity 8:16 --sparse-train`` rc 0, then ``--steps 30``
             resumes from 20.  13f: Qwen3-30B-A3B at full width, depth 4 of
             48 (``MOE_TRAIN_DEPTH``; 3.11B parameters, ~40-45 GiB with
             remat; depth 8 would need ~70 GiB), bf16, remat, dense, four
             steps of 4 x 512 ``lm_batch`` tokens at ``OptConfig(3e-4,
             warmup 2)``: finite losses, every leaf's AdamW moment (the
             expert stacks and float32 routers too) nonzero after step 1,
             step wall (median of steps 2-4), tokens/s, peak memory and
             the grouped product's share of a profiled step.  13g: the same
             under ``paper_policy(8, 16, ())`` active in ``"train"`` on the
             kernels: per step exactly 8 ``nm_prune_matmul`` (q through
             ``PruneMatmul``) and 16 ``nm_prune`` (the expert gate and down
             inputs through ``nm_prune``'s Function), 1 and 2 a layer a
             forward and remat's second forward as many.  13h: depth 2,
             float32, 1 x 256 tokens: the kernel path's loss and every
             gradient (expert stacks and routers included) within
             ``F32_TOL`` of the plain path's on the kernel path's N:M
             selections, the experts' included.  13i (``FAMILY_TRAIN``):
             RWKV6-7B at full width and depth 4, RecurrentGemma-2B at depth 5
             (a period and two rglru layers) and Whisper-medium whole (24 +
             24, no remat, as the reference), bf16, ``FAMILY_TRAIN_STEPS``
             steps of ``lm_batch`` (4 x 512; Whisper-medium 2 x 256 over
             2 x 1500 seeded frames) at ``OptConfig(3e-4, warmup 2)``,
             dense: finite losses, every leaf's AdamW moment nonzero after
             step 1, step wall (median of steps 2 onward), tokens/s, the
             model-FLOP share, peak memory, one step profiled, and the
             family's own part (RWKV6's WKV, the RG-LRU scan, Whisper's
             encoder) run apart at the step's shapes as often as the step
             runs it, its busy time against the step's.  13j: the same
             (unprofiled) under
             ``paper_policy(8, 16, ())`` active in ``"train"`` on the
             kernels: ``nm_prune_matmul`` (``PruneMatmul``) exactly as often
             as the pruned projections a forward, twice under remat (48, 38
             and 168 a step), nothing else.  13k (``FAMILY_GATE_DEPTH``):
             each at depth 2 (RecurrentGemma-2B 3, its attention layer
             included), float32, 1 x 256 tokens: the kernel path's loss and
             every gradient within ``F32_TOL`` of the plain path's on the
             kernel path's N:M selections.
14. tensor parallelism — after phase 13 freed its models
             (``phase_tp``).  14a: each sharded entry point at
             LLaMA-3.1-8B's shapes at tp = 2 and 4, every rank's shard
             computed in this process on the unsharded call's plan (the
             plan ``kernels.ops`` and ``models.attention`` hand a shard
             under a TP scope) and concatenated: ``nm_prune_matmul`` q
             4096², gate 4096 x 14336 and down 14336 x 4096 at T = 256;
             ``osparse_matmul`` on the same widths pruned at T = 256 and
             with ``prune=False`` at T = 4 (each K-major ``wq`` shard a
             view); ``nm_spmm`` (2h's Qwen2-7B shapes, T = 2048) and
             ``w8a8_matmul`` (2e's); ``paged_attention`` chunk (Tq 256) and
             decode (B = 4) at 32 / 8 heads of 128 over each rank's heads;
             ``paged_kv_scatter`` of a 256-row chunk into each rank's
             pools.  Each bit-identical to the unsharded launch, each
             shard's plan printed beside the one it would pick alone.
             14b: two ranks on this card over gloo (``launch.mesh.spawn``;
             NCCL refuses two ranks of one communicator on one device), each
             serving LLaMA-3.1-8B at full width and ``TP_DEPTH`` (2) layers
             with phase 3's weights, policy and stream through ``Engine``
             at ``EngineConfig(tp=2)``, every step eager (a CUDA graph
             cannot hold a gloo collective): every request's tokens equal
             the same model's at tp = 1 (served in this process first) on
             both ranks; each rank's pools hold 4 of the 8 KV heads; per
             rank the launches exact, counted from the layers
             (``nm_prune_matmul`` on q, gate and down a sparse chunk,
             ``paged_kv_scatter`` and ``paged_attention`` once a layer a
             step half, each a shard) and the gathers exact (a chunk alone:
             q, gate, down and attention; a decode step's), with the
             gathered bytes, eager wall time per chunk and per decode step
             and peak memory printed.  14c: the same with 3b's W8A8 rewrite
             on 3b's stream (tokens equal to tp = 1's; ``osparse_matmul``
             on q/k/v/o/gate/up a step half, the pruned ones a sparse
             chunk, ``nm_prune_matmul`` on down).  14d: ``python
             -m repro_torch.launch.serve --tp 2`` on the card (the smoke
             LLaMA-3.1 config, 6 requests) exits 0 with the ``--tp 1`` run's
             token digest.
15. sharded cells — after phase 14 (``phase_cells``), two ranks on this
             card over gloo (one start; the collectives split across
             ``launch.mesh.LANES`` groups), ``launch.cells.build_cell`` /
             ``Cell.materialize`` / ``Cell.run``.  15a: Qwen3-30B-A3B at
             full width and depth 48 on a (data 1, model 2) cell mesh, its
             ``prefill_32k`` cell cut to ``CELL_MOE_BT`` (2 x 1024), under
             ``paper_policy(8, 16, (41, 46, 47))`` with the kernels: each
             rank holds half of every expert's d_ff (~29 GiB), the experts
             run through ``_moe_shard_map``; per rank the launches exact
             (96 ``nm_prune``: the slot tensors' gate and down inputs; 45
             ``nm_prune_matmul``: q column-parallel outside the skips), the
             wall time, peak memory, all-reduces and all-gathers with their
             MiB, the capacity and the share of (token, expert) pairs
             dropped; at depth 4 both ranks' logits within ``BF16_TOL`` of
             the one-rank cell's (``_moe_shard_map`` on a 1 x 1 mesh) and
             layer 0's expert-input keep-masks bit-identical.  15b:
             LLaMA-3.1-8B's ``train_4k`` cell at full width, depth 2, on
             (data 2, model 1), cut to 4 x 512 tokens, ``grad_accum`` 2, 1
             step: weights, moments and the accumulator halved against the
             one-rank cell, the loss and grad norm within
             ``CELL_TRAIN_RTOL``, the parameters' slices' sums of squares too.
             15c:
             LLaMA-3.1-8B's ``decode_32k`` cell at depth 2 on (1, 2): B = 4
             over a 4096-deep cache holding 4 of the 8 KV heads a rank,
             ``CELL_DECODE``'s greedy steps, tokens equal to the one-rank
             cell's.  15d / 15e (``CELL_FAMILIES``): RWKV6-7B at full width,
             depth 8, and Whisper-medium at full width and depth, on (1, 2),
             ``paper_policy(8, 16, ())`` with the kernels: the prefill cell
             (RWKV6-7B 2 x 1024; Whisper-medium 2 x 256 decoder tokens over
             2 x 1500 seeded frames), then the decode cell (B = 4, seeded
             states, 2 greedy steps); a rank's cache holds 32 of RWKV6's 64
             heads of ``S``, 8 of Whisper's 16 heads of self and cross K/V;
             ``nm_prune_matmul`` launches exact (48 and 168 a prefill, 0 in
             decode); what a rank holds against the one-rank cell; the
             logits within ``BF16_TOL`` of the one-rank cell's (a decode step
             fed the ranks' greedy tokens), except Whisper-medium's decode,
             held at float32 and depth 2 (``F32_TOL``; at bf16 its float32
             attention over half the heads takes another reduction order on
             the card, printed).  15f: Qwen3-30B-A3B's ``train_4k`` cell at
             full width, depth 2, on (1, 2), cut to 2 x 512 tokens, 2 steps:
             each rank holds half of every expert's d_ff (the stacks on
             (D over data, d_ff over model), gathered over data alone), the
             losses, grad norms and parameter slices within
             ``CELL_TRAIN_RTOL`` of the one-rank cell's (``_moe_shard_map``
             on a 1 x 1 mesh); held and peak GiB, collectives, capacity and
             the dropped share printed.  15g (``CELL_FAMILY_TRAIN``): the
             ``train_4k`` cells of RWKV6-7B (depth 2) and RecurrentGemma-2B
             (depth 3) on (1, 2), cut to 2 x 512 tokens, and Whisper-medium
             (2 + 2 layers) on (2, 1), cut to 2 x 256 tokens over 2 x 1500
             seeded frames, full width, 2 steps each: RWKV6's WKV on the
             rank's 32 of 64 heads, RecurrentGemma-2B's attention whole on
             each rank; the losses, grad norms and parameter slices within
             ``CELL_TRAIN_RTOL`` of the one-rank cell's; Whisper-medium's
             state checkpointed whole by its ranks after 1 step, restored in
             this process, whose step 2 loss equals the ranks'.  2p (with
             the kernels of phase 2): ``nm_prune`` at the
             slot tensors 15a launches it on, (128 x 160, 2048) and
             (128 x 160, 384), bit-exact and timed.
16. launch tooling — after phase 15 (``phase_tooling``).  16a: the
             dry-run (``repro_torch.launch.dryrun.run_cell``: one rank's
             share of the step executed on ``meta`` tensors, every
             collective recorded, none run) of phase 15's eleven cells at
             their run shapes and meshes, both ranks: the bytes a dry rank
             holds equal what phase 15's ranks held (their records), its
             arguments' bytes from the specs equal that (train: and the
             rank's batch shard of tokens), its collectives equal the ranks'
             counted ones by kind, count and bytes (15a's whole prefill, the
             first step of 15b, 15f and 15g's three, the backward's
             collectives included, 15c's steps); predicted peak over
             measured peak
             printed, not gated.  16b: roofline shares on one rank (1 x 1):
             LLaMA-3.1-8B at full width and depth, its ``prefill_32k`` cell
             cut to ``DRY_PREFILL`` (1 x 2048) under ``paper_policy(8, 16,
             cfg.qgate_skip_layers)`` with the kernels, its
             ``decode_32k`` cell cut to ``DRY_DECODE`` (B = 4 over 4096),
             and phase 13a's train step: the dry-run's bound (the largest
             of its compute, memory and collective terms at the card's
             rates) over the device busy time of one profiled step, the
             bounding term and ``model_flops / (busy x peak)``; a share
             above ``DRY_SHARE_LIMIT`` (1.05) fails (a bound above the
             measured time is a counting fault).  16c: the CLIs and the
             examples, each exiting 0 with its key lines checked:
             ``dryrun --both`` for ``llama31_8b``, ``qwen3_30b_a3b``,
             ``rwkv6_7b`` and ``whisper_medium``, ``report`` on their JSON,
             ``perf --arch qwen2_5_32b --shape prefill_32k``,
             ``roofline_exact --arch llama31_8b --shape prefill_32k``
             (these six count on the host and start, niced,
             when the run starts; phase 16 collects them), and the four
             ``examples/torch_*.py`` on the card, started when the phase
             starts and run beside 16a; 16b profiles once they have
             exited.

The last lines are the per-kernel JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is
its count in the run of the path that first served it (phase 3, 3b, 5 or
7a); ``launches_by_run`` holds its count in each main-path run that
launched it (3, 3b, 5, 6g over both replicas, 7a, 7e, 9a, 9b, 9c's Naive run,
10a, 10b, 11a, 11e, 11b, 11c, 12a, 12b, 12e, 12c, 13b, 13g, 13j's three, and 14b, 14c
and 15a on rank 0), each counted from 0.  Exits non-zero without a
CUDA device, and when run outside the repository (it needs ``src/``).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
QPROJS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj")


def card_rates(name: str):
    """The card's data-sheet rates (dense): bytes/s, bf16 FLOP/s, fp32
    (non-tensor) FLOP/s, int8 tensor-core OP/s, from the one table,
    ``repro_torch.launch.roofline.RATES``."""
    from repro_torch.launch.roofline import card_rates as rates

    return rates(name)


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
    print("phase 2a: nm_prune_matmul (LLaMA-3.1-8B and Qwen2-7B q/gate/down, N:M 8:16)")
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
    # the one-shot CLI's prefill (phase 6f): Qwen2-7B, 4 x 512 rows, q with
    # Qwen's bias
    for proj, d, n_out, biased in (("q", 3584, 3584, True), ("gate", 3584, 18944, False),
                                   ("down", 18944, 3584, False)):
        w = (torch.randn(d, n_out, generator=g, device=dev) * d**-0.5).bfloat16()
        scale = torch.rand(d, generator=g, device=dev) + 0.5
        b = (torch.randn(n_out, generator=g, device=dev) * 0.1).bfloat16() if biased else None
        x = torch.randn(2048, d, generator=g, device=dev).bfloat16()
        plan = knm.gemm_plan(w, 2048)
        route = f"wgmma, {plan} k slice{'s' if plan > 1 else ''}" if plan else "WMMA"
        errs.append(check_close(f"Qwen2-7B {proj} T=2048 bias={biased} ({route})",
                                knm.nm_prune_matmul(x, w, scale, n, m, bias=b),
                                knm.nm_prune_matmul_plain(x, w, scale, n, m, bias=b), BF16_TOL))
        del w, x
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
    t = scatter_times(torch, timer, bw, kn, vn, kp, vp, tab1, pos1, cl1)
    ms, plain_ms, lib_ms, bound = (t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms"))
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
        return poisoned_pools(torch, kp, vp, tab, kvl)

    route = attention_route

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
    # Qwen3-30B-A3B's heads (32 / 4, G = 8; phase 7): decode, and a prefill
    # chunk, whose wgmma route packs 8 query tokens a tile
    q8, tab8, pos8, kvl8 = decode_case(32, [700, 401, 129, 5])
    kq8, vq8 = poisoned(kq, vq, tab8, kvl8)
    errs.append(check_close(
        f"decode B=4 G=8 (Qwen3-30B-A3B heads) NaN-poisoned {route(q8, kq, tab8)}",
        kpa.paged_attention(q8, kq8, vq8, tab8, pos8, kvl8, causal=False),
        kpa.paged_attention_plain(q8, kq8, vq8, tab8, pos8, kvl8, causal=False), BF16_TOL))
    qc8 = torch.randn(1, 256, 32, hd, generator=g, device=dev).bfloat16()
    kqc8, vqc8 = poisoned(kq, vq, tab1, kvl1)
    errs.append(check_close(
        f"prefill chunk G=8 q_offset=300 kv_len=500 NaN-poisoned {route(qc8, kq, tab1)}",
        kpa.paged_attention(qc8, kqc8, vqc8, tab1, qoff1, kvl1, causal=True),
        kpa.paged_attention_plain(qc8, kqc8, vqc8, tab1, qoff1, kvl1, causal=True), BF16_TOL))
    # timing at the serving shapes; the record keeps the prefill chunk's and,
    # beside it, each other case's
    cases = (("prefill chunk", q1, kp, vp, tab1, qoff1, kvl1, True),
             ("decode B=4 G=4", qd, kp, vp, tabd, posv, kvld, False),
             ("decode B=4 G=7", q7, kq, vq, tab7, pos7, kvl7, False),
             ("decode B=4 G=8", q8, kq, vq, tab8, pos8, kvl8, False),
             ("prefill chunk G=8", qc8, kq, vq, tab1, qoff1, kvl1, True))
    for case, q, kpool, vpool, tab, qo, kvl, causal in cases:
        r = paged_attention_times(torch, timer, rates, q, kpool, vpool, tab, qo, kvl, causal)
        ms, plain_ms, lib_ms, bound, by = (r[k] for k in ("ms", "plain_ms", "library_ms",
                                                          "bound_ms", "bound_by"))
        print(f"  {case} {route(q, kpool, tab)}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}), plain {plain_ms:.4f} ms, SDPA on the gathered view {lib_ms:.4f} ms; "
              f"kernel/library {ms / lib_ms:.2f}")
        if case == "prefill chunk":
            records["paged_attention"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                              bound_ms=bound, bound_by=by)
        else:
            key = ("chunk_g8" if case.startswith("prefill") else
                   "decode_g" + case.split("G=")[1])
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


def attention_route(q, kp, tab):
    """``attention_plan``'s route for ``q`` over the pool ``kp`` through
    ``tab`` (16-byte-aligned tensors)."""
    from repro_torch.kernels import paged_attention as kpa

    b, tq, hq, hd = q.shape
    return kpa.attention_plan(q.dtype, b, tq, hq, kp.shape[2], hd, kp.shape[1], tab.shape[1],
                              True)


def poisoned_pools(torch, kp, vp, tab, kvl):
    """Copies of the pools where every row no table row may read is NaN:
    blocks no row owns, and rows at or past each row's kv_len."""
    bs = kp.shape[1]
    kpn, vpn = kp.clone(), vp.clone()
    live = torch.zeros(kp.shape[:2], dtype=torch.bool)
    tab_h, kvl_h = tab.cpu(), kvl.cpu()
    for r in range(tab_h.shape[0]):
        for i in range(int(kvl_h[r])):
            pb = int(tab_h[r, i // bs])
            if pb >= 0:
                live[pb, i % bs] = True
    live = live.to(kp.device)
    kpn[~live], vpn[~live] = float("nan"), float("nan")
    return kpn, vpn


def paged_attention_times(torch, timer, rates, q, kpool, vpool, tab, qo, kvl, causal,
                          window=0):
    """One ``paged_attention`` case timed: the kernel, the plain version,
    SDPA on the gathered view (KV heads repeated to the query heads outside
    the timed call, the same band mask) and the bound (each K/V row some
    query sees read once, q read and the output written once; 4 hd
    operations a visible (query head, key) pair)."""
    from repro_torch.kernels import paged_attention as kpa

    bw, bf16_peak = rates[0], rates[1]
    dev = q.device
    b, tq, hq, hd = q.shape
    rows, bs, hkv = kpool.shape[:3]
    mb = tab.shape[1]
    ms = timer.ms(lambda: kpa.paged_attention(q, kpool, vpool, tab, qo, kvl, causal=causal,
                                              window=window))
    plain_ms = timer.ms(
        lambda: kpa.paged_attention_plain(q, kpool, vpool, tab, qo, kvl, causal=causal,
                                          window=window), 5)
    s_len = mb * bs
    kpos = torch.arange(s_len, device=dev)
    qpos = qo.long()[:, None] + torch.arange(tq, device=dev)[None, :]
    mask = kpos[None, None, :] < kvl.long()[:, None, None]
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    if window:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
    kg = kpool[tab.long().clamp(0, rows - 1)].reshape(b, s_len, hkv, hd)
    vg = vpool[tab.long().clamp(0, rows - 1)].reshape(b, s_len, hkv, hd)
    qt = q.transpose(1, 2)
    kt = kg.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    vt = vg.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    am = mask[:, None]
    lib_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=am))
    pairs = int(mask.sum()) * hq
    nbytes = (2 * q.numel() + 2 * int(mask.any(dim=1).sum()) * hkv * hd) * 2
    ops = 4 * hd * pairs
    bound = max(nbytes / bw, ops / bf16_peak) * 1e3
    by = "bytes" if nbytes / bw >= ops / bf16_peak else "operations"
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)


def scatter_times(torch, timer, bw, kn, vn, kp, vp, tab, pos, clen):
    """One ``paged_kv_scatter`` case timed: the kernel, the plain version,
    ``index_put_`` of the kept rows into the flattened pools (the rows the
    plain version keeps) and the bound (each kept K and V row read and
    written once, the table and the two index vectors read)."""
    from repro_torch.kernels import paged_attention as kpa

    b, t = kn.shape[:2]
    rows, bs = kp.shape[:2]
    mb = tab.shape[1]
    ms = timer.ms(lambda: kpa.paged_kv_scatter(kn, vn, kp, vp, tab, pos, clen))
    plain_ms = timer.ms(lambda: kpa.paged_kv_scatter_plain(kn, vn, kp, vp, tab, pos, clen))
    i = torch.arange(t, device=kn.device)
    wpos = pos.long()[:, None] + i[None, :]
    pb = tab.long().gather(1, (wpos // bs).clamp(0, mb - 1))
    kept = (i[None, :] < clen.long()[:, None]) & (pb >= 0) & (wpos // bs < mb)
    bi, ti = kept.nonzero(as_tuple=True)
    dst = pb[bi, ti] * bs + wpos[bi, ti] % bs
    kflat, vflat = kp.view(rows * bs, *kp.shape[2:]), vp.view(rows * bs, *vp.shape[2:])
    ksrc, vsrc = kn[bi, ti], vn[bi, ti]

    def index_put():
        kflat.index_put_((dst,), ksrc)
        vflat.index_put_((dst,), vsrc)

    lib_ms = timer.ms(index_put)
    n_kept = int(kept.sum())
    row_bytes = kn[0, 0].numel() * kn.element_size()
    bound = (2 * 2 * n_kept * row_bytes + (tab.numel() + 2 * b) * 4) / bw * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, rows=n_kept)


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
        records["nm_prune"] = {f"d{d}_ms": ms, f"d{d}_bound_ms": bound,
                               **records.get("nm_prune", {})}
    # the MoE path's prunes (phase 7), plain |X| scores (no scale): a prefill
    # chunk's expert gate input (256 tokens x d_model 2048, pruned before the
    # rows are gathered) and its down input h (256 x 8 routed rows x
    # moe_d_ff 768), and 2048 rows at D = 2048.  The record keeps the down
    # input's time, the larger of the two a chunk launches
    for name, t, d in (("expert gate input", 256, 2048), ("expert down input", 2048, 768),
                       ("T=2048 D=2048", 2048, 2048)):
        x = torch.randn(t, d, generator=g, device=dev).bfloat16()
        same = exact("nm_prune", (knp.nm_prune(x, None, n, m),),
                     (knp.nm_prune_plain(x, None, n, m),))
        ms = timer.ms(lambda: knp.nm_prune(x, None, n, m))
        plain_ms = timer.ms(lambda: knp.nm_prune_plain(x, None, n, m), 5)
        copy_ms = timer.ms(x.clone)
        bound = 2 * x.numel() * 2 / bw * 1e3
        print(f"  {name} T={t} D={d} (no scale): bit-exact={same}; kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms (bytes), plain {plain_ms:.4f} ms, x.clone() {copy_ms:.4f} ms")
        if name == "expert down input":
            records["nm_prune"].update(ms=ms, plain_ms=plain_ms, library_ms=None,
                                       bound_ms=bound, bound_by="bytes", max_abs_err=0.0)
        elif name == "expert gate input":
            records["nm_prune"].update(gate_ms=ms, gate_bound_ms=bound)
    nm_prune_backward(torch, timer, rates, records, g)
    return records


def nm_prune_backward(torch, timer, rates, records, g):
    """2f, training: ``nm_prune``'s ``torch.autograd.Function`` at the MoE
    expert inputs (T = 256 x D = 2048, the gate input; T = 2048 x D = 768,
    the down input), no scale, with a whole 16-group of exact zeros in row
    0: the output and ``dX`` bit-exact against the plain version's
    ``where(mask, dY, 0)`` (the kept zeros pass their gradient); the forward
    that writes the keep-mask timed beside the one that does not, and the
    backward beside its bound."""
    from repro_torch.kernels import nm_prune as knp

    bw, n, m = rates[0], 8, 16
    for name, t, d in (("expert gate input", 256, 2048), ("expert down input", 2048, 768)):
        x = torch.randn(t, d, generator=g, device="cuda").bfloat16()
        x[0, :16] = 0.0
        dy = torch.randn(t, d, generator=g, device="cuda").bfloat16()
        xa = x.clone().requires_grad_()
        y = knp.nm_prune(xa, None, n, m)
        if "Prune" not in type(y.grad_fn).__name__:
            fail(f"2f {name}: nm_prune under autograd took {type(y.grad_fn).__name__}")
        dx, = torch.autograd.grad(y, [xa], dy)
        want, keep = knp._plain(x, None, n, m)
        zero = torch.zeros((), dtype=dy.dtype, device="cuda")
        if not (torch.equal(y.detach(), want) and torch.equal(dx, torch.where(keep, dy, zero))):
            fail(f"2f {name}: nm_prune's backward differs from where(mask, dY, 0)")
        if not torch.equal(dx[0, :8], dy[0, :8]):
            fail(f"2f {name}: the kept zeros of row 0 did not pass their gradient")
        kmask = knp._launch(x, None, n, m, with_keep=True)[1]
        fwd_ms = timer.ms(lambda: knp._launch(x, None, n, m, with_keep=False))
        keep_ms = timer.ms(lambda: knp._launch(x, None, n, m, with_keep=True))
        bwd_ms = timer.ms(lambda: torch.where(kmask.view(torch.bool), dy, zero))
        fwd_bound = 2 * x.numel() * 2 / bw * 1e3
        keep_bound = 5 * x.numel() / bw * 1e3          # + one mask byte an element
        bwd_bound = 5 * x.numel() / bw * 1e3           # mask and dY read, dX written
        print(f"  2f backward, {name} T={t} D={d} (no scale, a zero group in row 0): output "
              f"and dX bit-exact against where(mask, dY, 0), the kept zeros pass; forward "
              f"{fwd_ms:.4f} ms (bound {fwd_bound:.4f}), with the keep-mask {keep_ms:.4f} ms "
              f"(bound {keep_bound:.4f}), backward where(keep, dY, 0) {bwd_ms:.4f} ms (bound "
              f"{bwd_bound:.4f})")
        if name == "expert down input":
            records["nm_prune"].update(keep_ms=keep_ms, keep_bound_ms=keep_bound,
                                       bwd_ms=bwd_ms, bwd_bound_ms=bwd_bound)


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


def serving_stream(torch, vocab, **serving):
    """Phase 3's requests: (rng after the prompts, prompts, arrivals, new
    tokens, ``ContinuousConfig``: 4 slots, chunk 256, blocks of 16)."""
    from repro_torch.serve import ContinuousConfig

    rng = np.random.default_rng(SEED)
    prompts = make_requests(rng, 8, 64, 700, vocab)
    arrivals = [0, 0, 1, 2, 4, 6, 9, 12]
    new = 32
    bsz = 16
    max_seq = -(-(max(len(p) for p in prompts) + new) // bsz) * bsz
    return rng, prompts, arrivals, new, ContinuousConfig(
        num_slots=4, chunk_size=256, block_size=bsz, max_seq=max_seq, **serving)


def warm_up(eng, params, rng, vocab, extras_fn=None):
    """Library handles, the allocator, and the programs of the three buckets
    phase 3's stream uses (a 40-token request decodes while a 300-token one
    is prefilled); then the engine is cleared for the measured stream.
    Under exact chunks a program runs at every dyadic length, so two
    requests of ``2 * chunk - 1`` tokens instead: the first's chunks (every
    power of two up to ``chunk``) run alone, the second's while the first
    decodes, so the measured stream replays graphs only.  With modality
    extras (``extras_fn(i)``: request ``i``'s) every prefill program runs with
    and without them: two 300-token requests with extras, the second
    arriving while the first decodes (first and later chunks alone, then
    beside a decode).  ``eng``: an ``Engine`` of one replica, or one replica
    (a ``ContinuousServingEngine``) of a larger fleet."""
    ex = eng.exec if hasattr(eng, "exec") else eng.replica.exec
    if extras_fn is not None:
        for i, (arrival, new) in enumerate(((0, 4), (2, 2))):
            eng.submit(rng.integers(0, vocab, size=300), max_new_tokens=new, arrival=arrival)
        eng.run(params, extras={i: extras_fn(1000 + i) for i in range(2)})
        eng.clear()
        return
    if ex.exact_chunks:
        n = 2 * ex.cfg.chunk_size - 1
        eng.submit(rng.integers(0, vocab, size=n), max_new_tokens=n.bit_length() + 3)
        eng.submit(rng.integers(0, vocab, size=n), max_new_tokens=2, arrival=1)
    else:
        eng.submit(rng.integers(0, vocab, size=40), max_new_tokens=4)
        eng.submit(rng.integers(0, vocab, size=300), max_new_tokens=2, arrival=1)
    eng.run(params)
    eng.clear()


def bucket_sum(bk, names, key):
    return sum(bk[n][key] for n in names if n in bk)


def step_counts(bk, fused: bool):
    """From a run's per-bucket calls: the buckets of sparse prefill chunks
    and of decode-only steps, and the calls of sparse chunks, of prefill
    halves and of decode halves, which fix the kernels' launch counts."""
    if fused:
        sparse, decode_only = ("step_prefill", "step_prefill_decode"), ("step_decode",)
        prefills = sparse + ("step_replay", "step_replay_decode")
        decodes = ("step_decode", "step_prefill_decode", "step_replay_decode")
    else:           # the legacy split: every decode step is decode-only
        sparse, decode_only = ("prefill",), ("decode",)
        prefills, decodes = ("prefill", "prefill_replay"), ("decode",)
    steps = dict(sparse_chunks=bucket_sum(bk, sparse, "calls"),
                 prefill_halves=bucket_sum(bk, prefills, "calls"),
                 decode_halves=bucket_sum(bk, decodes, "calls"))
    return sparse, decode_only, steps


def serve_requests(torch, model, params, policy, label, eager=False, stream_fn=None,
                   extras_fn=None, **serving):
    """8 staggered requests (64-700 prompt tokens, 32 new tokens each) through
    ``Engine.from_config`` after one warm-up request, with the launch counts
    set to 0 just before and read just after.  Every request must end
    ``done`` with its tokens, and every step program used must have been
    captured once (``trace_counts``).  ``eager``: every step runs its
    program directly (``step_program``), with no graph, for the token
    comparison.  ``serving``: more ``ContinuousConfig`` fields
    (``fused_step=False``: the legacy split's ``prefill`` and ``decode``
    programs).  ``stream_fn(vocab, **serving)``: another stream in
    :func:`serving_stream`'s form.  ``extras_fn(i)``: request ``i``'s modality
    arrays, or None for a request without any (every request is asked;
    the warm-up too).  Returns (launches, per-path step counts with the
    stream's prefill and decode tok/s and peak memory, engine,
    outputs)."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.serve import Engine, EngineConfig

    cfg = model.cfg
    if stream_fn is None:
        rng, prompts, arrivals, new, scfg = serving_stream(torch, cfg.vocab_size, **serving)
    else:
        rng, prompts, arrivals, new, scfg = stream_fn(cfg.vocab_size, **serving)
    eng = Engine.from_config(model, EngineConfig(serving=scfg), policy=policy)
    shapes = program_shapes(eng.replica.exec)
    if eager:       # the executor's step programs, each step run as it is
        eng.replica.exec._graphs.run = lambda name, fn, params, shape=None: fn()
    warm_up(eng, params, rng, cfg.vocab_size, extras_fn)
    extras = {}
    if extras_fn is not None:
        extras = {i: ex for i in range(len(prompts)) if (ex := extras_fn(i)) is not None}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rids = [eng.submit(p, max_new_tokens=new, arrival=a) for p, a in zip(prompts, arrivals)]
    res = eng.run(params, extras=extras)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    launches["osparse_matmul (prune=True)"] = kos.osparse_matmul.pruned_launches
    launches["osparse_matmul routes"] = dict(kos.osparse_matmul.route_launches)
    launches["paged_attention routes"] = dict(kpa.paged_attention.route_launches)
    launches["flash_attention routes"] = dict(kfa.flash_attention.route_launches)
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
    want = {name: len(lens) for name, lens in shapes.items()}
    print(f"  trace_counts {traces} (graph captures per step bucket)")
    if eng.replica.exec.exact_chunks:
        ran = {k: sorted(v, key=str) for k, v in shapes.items()}
        print(f"  exact chunks: the chunk lengths each program ran {ran}")
    if set(bk) - set(traces) or traces != want:
        fail(f"{label}: trace_counts {traces}: every bucket used ({sorted(bk)}) must be "
             f"captured once for each chunk length it ran ({want})")

    sparse, decode_only, steps = step_counts(bk, scfg.fused_step)
    agg = functools.partial(bucket_sum, bk)
    print(f"  prompts {[len(p) for p in prompts]}, arrivals {arrivals}, {new} new tokens each")
    print(f"  buckets {json.dumps(bk)}")
    print(f"  launches (replays counted) {launches}; {steps}")
    pf_tok = agg(sparse, "prefill_tokens")
    pf_s = agg(sparse, "seconds")
    dec_tok = agg(decode_only, "decode_tokens")
    dec_s = agg(decode_only, "seconds")
    print(f"  wall {met['wall_s']:.3f} s, {met['generated_tokens']} tokens generated, "
          f"{met['iterations']} iterations, dispatches/iteration "
          f"{met['dispatches_per_iteration']:.2f}")
    print(f"  prefill {pf_tok} tokens in {pf_s:.3f} s of prefill steps = "
          f"{pf_tok / pf_s:.1f} tok/s; {'/'.join(decode_only)} steps {dec_tok} tokens in "
          f"{dec_s:.3f} s = {dec_tok / dec_s:.1f} tok/s")
    steps.update(prefill_tok_s=pf_tok / pf_s, decode_tok_s=dec_tok / dec_s,
                 peak_alloc_gib=torch.cuda.max_memory_allocated() / 2**30,
                 peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30)
    print(f"  peak device memory {steps['peak_alloc_gib']:.2f} GiB "
          f"allocated (weights, cache, live activations), "
          f"{steps['peak_reserved_gib']:.2f} GiB reserved (with the graph "
          f"pool's free blocks); held after the run {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB")
    return launches, steps, eng, outputs


def program_shapes(ex):
    """Record, from the plans themselves, the chunk lengths each step
    program of the executor ``ex`` runs: ``{name: {length, ...}}`` (None for
    a program of one shape: no exact chunks, or no prefill half; a chunk
    with modality extras as ``(length, their names)``), filled as the engine
    runs.  Under exact chunks every length, and a chunk with extras, is a
    graph of its own, so ``trace_counts`` must equal these sets' sizes.  The wrapper holds the
    executor weakly: a cycle would keep a dropped engine's graphs alive until
    a collection, which may fall inside another engine's capture."""
    import weakref

    shapes = {}
    exact, real, ref = ex.exact_chunks, type(ex)._run, weakref.ref(ex)

    def run(params, plan, name, fault, extras=None):
        length = plan.prefill.chunk_len if plan.prefill is not None and exact else None
        ex = tuple(sorted(extras)) if extras and plan.prefill is not None else ()
        shapes.setdefault(name, set()).add((length, ex) if ex else length)
        return real(ref(), params, plan, name, fault, extras)

    ex._run = run
    return shapes


def check_graphed_tokens(torch, model, params, policy, label, outputs, stream_fn=None,
                         extras_fn=None):
    """The graphed run's tokens against the same requests run through the
    executor's step programs eagerly: identical."""
    _, _, eng, eager = serve_requests(torch, model, params, policy, label, eager=True,
                                      stream_fn=stream_fn, extras_fn=extras_fn)
    del eng
    if eager != outputs:
        diff = [i for i, (a, b) in enumerate(zip(outputs, eager)) if a != b]
        fail(f"{label}: graphed tokens differ from the eager step programs' in "
             f"requests {diff}")
    print(f"  {label}: graphed tokens identical to the eager step programs' "
          f"({len(outputs)} requests x {len(outputs[0])})")


def check_launches(label, launches, want):
    """Each kernel of the path launched, and exactly as often as expected
    (a count of 0: a kernel the path must not launch)."""
    for name, count in want.items():
        if count and launches[name] <= 0:
            fail(f"{label}: kernel {name} was never launched on the serving path")
        if launches[name] != count:
            fail(f"{label}: {name} launched {launches[name]} times, expected {count}")


def w8a8_rewrite(cfg, params) -> None:
    """Phase 3b's rewrite, in place: q/k/v/o/gate/up of every layer to W8A8
    (``QuantConfig()``) from a calibration absmax seeded ``SEED + 3``."""
    from repro_torch.core import quant
    from repro_torch.weights import quantize_linears

    rng = np.random.default_rng(SEED + 3)
    absmax = {(i, name): calib_absmax(rng, cfg.q_dim if name == "o_proj" else cfg.d_model)
              for i in range(cfg.n_layers) for name in QPROJS}
    quantize_linears(params, absmax, quant.QuantConfig())


def phase_serve_osparse(torch, model, params, policy, label="3b"):
    """Phase 3's (or 8a's) weights and Amber scales, rewritten to W8A8 on
    q/k/v/o/gate/up of every layer, served the same way; the q/k/v biases
    of a model that has them go into the int8 epilogue."""
    from repro_torch.core import quant
    from repro_torch.layers.linear import QuantLinear

    cfg = model.cfg
    qcfg = quant.QuantConfig()
    print(f"phase {label}: serve {cfg.name} Outstanding-sparse at full width (W8A8 "
          f"alpha={qcfg.alpha} outstanding={qcfg.outstanding} per_token="
          f"{qcfg.per_token_act} skip_modules={qcfg.skip_modules} skip_layers="
          f"{qcfg.skip_layers}; Amber 8:16 under the paper policy)")
    t0 = time.perf_counter()
    w8a8_rewrite(cfg, params)
    if cfg.qkv_bias and not all(isinstance(lin, QuantLinear) and lin.b is not None
                                for blk in params.blocks
                                for lin in (blk.q_proj, blk.k_proj, blk.v_proj)):
        fail(f"phase {label}: a quantized q/k/v projection lost its bias")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_q = sum(b.numel() for n_, b in params.named_buffers() if n_.endswith(".wq"))
    print(f"  rewrite in {time.perf_counter() - t0:.1f} s: {n_q / 1e9:.3f}B int8 weights; "
          f"device memory held {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pruned = sum(policy.should_prune(mod, i) for i in range(cfg.n_layers)
                 for mod in ("q_proj", "gate_proj"))
    want = 2 * cfg.n_layers - 2 * len(cfg.qgate_skip_layers)
    if pruned != want:
        fail(f"paper policy prunes {pruned} quantized projections per chunk, expected {want}")
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, f"phase {label}")
    halves = st["prefill_halves"] + st["decode_halves"]
    per_step = cfg.n_layers * halves
    check_launches(f"phase {label}", launches, {
        "osparse_matmul": len(QPROJS) * cfg.n_layers * halves,
        "osparse_matmul (prune=True)": pruned * st["sparse_chunks"],
        "nm_prune_matmul": cfg.n_layers * st["sparse_chunks"],
        "paged_kv_scatter": per_step, "paged_attention": per_step})
    # decode projections in one fused launch, prefill chunks on wgmma: never
    # the per-token swap route or the simple dp4a route
    routes = {r: c for r, c in launches["osparse_matmul routes"].items() if c}
    print(f"  osparse_matmul launches by route {routes}")
    if not routes or not set(routes) <= {"wgmma", "swap_fused"}:
        fail(f"phase {label}: osparse_matmul launches by route {routes}, expected wgmma "
             "(prefill) and swap_fused (decode) only")
    profile_steps(torch, model, params, policy, eng)
    del eng
    check_graphed_tokens(torch, model, params, policy, f"phase {label}", outputs)
    return launches, outputs


def fresh_engine(torch, model, policy, faults=None, **serving):
    """An engine over phase 3's ``ContinuousConfig`` (plus ``serving``),
    and phase 3's requests submitted to it, no warm-up.  Returns (engine,
    rids)."""
    from repro_torch.serve import Engine, EngineConfig

    _, prompts, arrivals, new, scfg = serving_stream(torch, model.cfg.vocab_size, **serving)
    eng = Engine.from_config(model, EngineConfig(serving=scfg), policy=policy, faults=faults)
    return eng, [eng.submit(p, max_new_tokens=new, arrival=a)
                 for p, a in zip(prompts, arrivals)]


def check_tokens(label, outputs, want, of="phase 3's"):
    if outputs != want:
        diff = [i for i, (a, b) in enumerate(zip(outputs, want)) if a != b]
        fail(f"{label}: tokens differ from {of} in requests {diff}")
    print(f"  {label}: tokens identical to {of} ({len(want)} requests x {len(want[0])})")


def phase_lifecycle(torch, model, params, policy, want):
    """Phases 6b-6e, on phase 3's model, weights and requests (before 3b
    rewrites the weights); ``want`` is phase 3's tokens."""
    import weakref

    from repro_torch.serve.faults import EngineCrash, FaultInjector, FaultSpec

    cfg = model.cfg
    print("phase 6b: phase 3's requests through the legacy two-program split "
          "(fused_step=False)")
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, "phase 6b",
                                                fused_step=False)
    traces, m = eng.replica.trace_counts, eng.metrics
    if set(traces) - {"prefill", "prefill_replay"} != {"decode"} or "prefill" not in traces:
        fail(f"phase 6b: trace_counts {traces}: expected the prefill and decode programs")
    if not m.dispatches_per_iteration > 1.0:
        fail(f"phase 6b: {m.dispatches_per_iteration} dispatches per work iteration, "
             "expected more than 1 on the legacy split")
    per_chunk = sum(policy.should_prune(mod, i) for i in range(cfg.n_layers)
                    for mod in ("q_proj", "gate_proj", "down_proj"))
    per_step = cfg.n_layers * (st["prefill_halves"] + st["decode_halves"])
    check_launches("phase 6b", launches, {
        "nm_prune_matmul": per_chunk * st["sparse_chunks"],
        "paged_kv_scatter": per_step, "paged_attention": per_step})
    check_tokens("phase 6b", outputs, want)
    del eng

    print("phase 6c: phase 3's requests, a crash in a decode iteration and one in a "
          "prefill iteration, each restored from the last snapshot into a new engine")
    inj = FaultInjector(seed=SEED, schedule=[
        FaultSpec("decode", "crash", iters=tuple(range(5, 40)), limit=1),
        FaultSpec("prefill", "crash", iters=tuple(range(12, 60)), limit=1)])
    t0 = time.perf_counter()
    eng, rids = fresh_engine(torch, model, policy, inj, snapshot_every=1)
    crashes, freed = 0, True
    while True:
        try:
            res = eng.run(params)
            break
        except EngineCrash:
            crashes += 1
        if crashes > 2:
            fail(f"phase 6c: {crashes} crashes from a schedule of two")
        traces = eng.replica.trace_counts
        if any(n != 1 for n in traces.values()):
            fail(f"phase 6c: crashed engine's trace_counts {traces}")
        snap, dead = eng.last_snapshot, weakref.ref(eng.replica.exec)
        del eng
        freed = freed and dead() is None
        eng, _ = fresh_engine(torch, model, policy, inj, snapshot_every=1)
        eng.restore(snap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traces = eng.replica.trace_counts
    print(f"  fired {inj.fired}; restores {eng.replica.restores}; last engine's "
          f"trace_counts {traces}; wall {wall:.3f} s with the captures of "
          f"{crashes + 1} engines")
    if crashes != 2 or eng.metrics.lifecycle.restores != crashes:
        fail(f"phase 6c: {crashes} crashes, {eng.metrics.lifecycle.restores} restores")
    if any(n != 1 for n in traces.values()):
        fail(f"phase 6c: restored engine's trace_counts {traces}")
    if not freed:
        fail("phase 6c: a crashed engine was still alive after it was dropped")
    check_tokens("phase 6c", [res["outputs"][r] for r in rids], want)
    del eng

    print("phase 6d: phase 3's requests under pool.alloc exhausted (the first two "
          "admissions) and admit transient (the third admission)")
    inj = FaultInjector(seed=SEED, schedule=[
        FaultSpec("pool.alloc", "exhausted", calls=(0, 1)),
        FaultSpec("admit", "transient", calls=(2,))])
    eng, rids = fresh_engine(torch, model, policy, inj)
    res = eng.run(params)
    lc = eng.metrics.lifecycle
    print(f"  fired {inj.fired}; admission_retries {lc.admission_retries}, "
          f"preemptions {eng.metrics.paged.preemptions}")
    if not lc.admission_retries > 0 or inj.total_fired != 3:
        fail(f"phase 6d: admission_retries {lc.admission_retries}, {inj.total_fired} fired")
    check_tokens("phase 6d", [res["outputs"][r] for r in rids], want)
    del eng

    print("phase 6e: a nonfinite decode fault at iteration 10 of phase 3's stream, after "
          "a warm-up that captured every bucket: the replayed step must raise")
    from repro_torch.serve import Engine, EngineConfig

    rng, prompts, arrivals, new, scfg = serving_stream(torch, cfg.vocab_size)
    inj = FaultInjector(seed=SEED, schedule=[FaultSpec("decode", "nonfinite", iters=(10,))])
    eng = Engine.from_config(model, EngineConfig(serving=scfg), policy=policy, faults=inj)
    warm_up(eng, params, rng, cfg.vocab_size)
    captured = dict(eng.replica.trace_counts)
    for p, a in zip(prompts, arrivals):
        eng.submit(p, max_new_tokens=new, arrival=a)
    try:
        eng.run(params)
    except FloatingPointError as e:
        err = str(e)
    else:
        fail("phase 6e: the nonfinite fault did not raise")
    name = err.split(":")[0]
    print(f"  raised FloatingPointError: {err}; fired {inj.fired}; trace_counts before "
          f"{captured}, after {eng.replica.trace_counts}")
    if inj.fired_kinds() != ["nonfinite"] or captured.get(name) != 1 \
            or eng.replica.trace_counts != captured:
        fail(f"phase 6e: the faulted step ({name}) was not a replay of a captured graph")
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_replicas(torch, model, params, policy, want):
    """Phases 6g and 6h, on phase 3's model, weights and requests (before 3b
    rewrites the weights); ``want`` is phase 3's tokens.  6g: two replicas
    behind the router (``EngineConfig(dp=2)``), each warmed up as phase 3's
    engine is, then phase 3's stream: tokens identical, both replicas
    served, each replica's every bucket captured once, launches exact over
    the two (per sparse chunk 86 ``nm_prune_matmul``), merged and
    per-replica tok/s and peak memory.  6h: the same stream at ``dp=2``
    with a crash at decode iteration 3: one replica lost, its requests
    transplanted to the other and each held, token by token after the
    crash, to the eager replay path (:func:`eager_rows`, :func:`near_tie`),
    the others identical to phase 3's, and the degraded fleet refuses to
    snapshot.  Returns 6g's launches."""
    from repro_torch import kernels
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.faults import FaultInjector, FaultSpec

    cfg = model.cfg
    print("phase 6g: phase 3's requests through two replicas behind the router (dp=2, one "
          "card: the replicas run one after another, so no throughput gain is expected)")
    rng, prompts, arrivals, new, scfg = serving_stream(torch, cfg.vocab_size)
    eng = Engine.from_config(model, EngineConfig(dp=2, serving=scfg), policy=policy)
    shapes = [program_shapes(rep.exec) for rep in eng.replicas]
    for rep in eng.replicas:
        warm_up(rep, params, rng, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rids = [eng.submit(p, max_new_tokens=new, arrival=a) for p, a in zip(prompts, arrivals)]
    res = eng.run(params)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    m = eng.metrics
    check_tokens("phase 6g", [res["outputs"][r] for r in rids], want)
    served = [sorted(g for g, (rep, _) in eng._router._rid_map.items() if rep == i)
              for i in range(2)]
    print(f"  requests by replica {served}")
    if not all(served):
        fail(f"phase 6g: a replica served nothing ({served})")
    for i, (rep, sh) in enumerate(zip(eng.replicas, shapes)):
        traces = rep.trace_counts
        print(f"  replica {i}: trace_counts {traces}")
        if traces != {name: len(lens) for name, lens in sh.items()} \
                or any(n != 1 for n in traces.values()):
            fail(f"phase 6g: replica {i}'s trace_counts {traces}: every bucket it used must "
                 "be captured once")
    _, _, st = step_counts(m.buckets, fused=True)
    fused, _ = prune_launches(cfg, policy)
    if fused != 86:
        fail(f"phase 6g: {fused} nm_prune_matmul a sparse chunk, expected 86")
    per_step = cfg.n_layers * (st["prefill_halves"] + st["decode_halves"])
    check_launches("phase 6g", launches, {
        "nm_prune_matmul": fused * st["sparse_chunks"], "paged_kv_scatter": per_step,
        "paged_attention": per_step, "nm_prune": 0, "nm_spmm": 0, "flash_attention": 0,
        "osparse_matmul": 0})
    print(f"  launches held over both replicas: {st}; nm_prune_matmul {fused} a sparse chunk")
    print(f"  merged: {m.generated_tokens} tokens in {m.wall_s:.3f} s = {m.tokens_per_s:.1f} "
          f"tok/s over {m.iterations} iterations (the longer replica's); per replica "
          + ", ".join(f"r{i} {p.generated_tokens} tokens in {p.wall_s:.3f} s = "
                      f"{p.tokens_per_s:.1f} tok/s" for i, p in enumerate(m.replicas)))
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved (both "
          "replicas' caches and graph pools)")
    del eng

    print("phase 6h: the same stream at dp=2 with a crash at decode iteration 3: the "
          "replica is drained to the survivor")
    inj = FaultInjector(seed=SEED, schedule=[FaultSpec("decode", "crash", iters=(3,),
                                                       limit=1)])
    eng = Engine.from_config(model, EngineConfig(dp=2, serving=scfg), policy=policy,
                             faults=inj)
    rids = [eng.submit(p, max_new_tokens=new, arrival=a) for p, a in zip(prompts, arrivals)]
    router = eng._router
    home = dict(router._rid_map)
    res = eng.run(params)
    print(f"  fired {inj.fired}; crashes {router.crashes}, transplants {router.transplants}, "
          f"alive {router.alive}")
    if router.crashes != 1 or router.transplants < 1 or sum(router.alive) != 1:
        fail(f"phase 6h: crashes {router.crashes}, transplants {router.transplants}, "
             f"alive {router.alive}")
    wrong = [0, 0]
    for i, g in enumerate(rids):
        got = res["outputs"][g]
        rep, lrid = home[g]
        if router._rid_map[g][0] == rep:
            if got != want[i]:
                fail(f"phase 6h: request {g} (not transplanted) differs from phase 3's")
            continue
        kept = len(router.replicas[rep].requests[lrid].out)
        if got[:kept] != want[i][:kept]:
            fail(f"phase 6h: request {g}'s tokens emitted before the crash changed")
        rows = eager_rows(torch, model, params, policy, prompts[i], got[:kept], got[kept:-1],
                          scfg.max_seq)
        for j, row in enumerate(rows):
            near_tie("phase 6h", row, got[kept + j],
                     f"request {g}'s replayed token {kept + j} ({kept} emitted before the "
                     "crash) against the eager replay path's argmax")
        print(f"  phase 6h: request {g}: {kept} tokens emitted before the crash, the "
              f"{len(rows)} after it each the eager replay path's argmax or within "
              f"{NEAR_TIE_ULPS} ulp of it")
        if kept:      # the same check on a replay that lost the emitted tokens' K/V
            bad = eager_rows(torch, model, params, policy, prompts[i], [], got[kept:-1],
                             scfg.max_seq)
            wrong[0] += sum(not near_tie(None, r, t) for r, t in zip(bad[1:], got[kept + 1:]))
            wrong[1] += len(bad) - 1
        if got != want[i]:
            k = next(j for j, (x, y) in enumerate(zip(got, want[i])) if x != y)
            decode = eager_rows(torch, model, params, policy, prompts[i], [], want[i][:k],
                                scfg.max_seq)[-1]
            for path, row in (("decode", decode), ("replay", rows[k - kept])):
                near_tie("phase 6h", row, want[i][k],
                         f"request {g} parts from phase 3's tokens at {k}: phase 3's "
                         f"{want[i][k]} against the replayed {got[k]} on the eager {path} path",
                         against=got[k])
    print(f"  phase 6h: a replay that lost the emitted tokens' K/V would fail {wrong[0]} of "
          f"the {wrong[1]} later positions of the transplanted requests")
    try:
        eng.snapshot()
    except AssertionError as e:
        print(f"  snapshot of the degraded fleet refused: {e}")
    else:
        fail("phase 6h: a degraded fleet took a snapshot")
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches


def eager_rows(torch, model, params, policy, prompt, replayed, fed, max_seq):
    """One request's logits, eagerly at batch 1, as a server computes them:
    the prompt's 256-token chunks under ``policy``, then ``replayed`` (the
    tokens emitted before a transplant, which the survivor re-ingests) as
    one dense chunk, then ``fed`` one dense decode step each.  Returns the
    logits row after the prompt or the replay chunk, then one after each fed
    token: each row predicts the next token."""
    from repro_torch.core.policy import DENSE

    dense = DENSE.with_(use_kernels=policy.use_kernels)
    cache = model.init_cache(1, max_seq)
    for s in range(0, len(prompt), 256):
        chunk = torch.from_numpy(prompt[s:s + 256][None, :].astype(np.int32)).cuda()
        lg, cache = model.prefill_chunk(params, {"tokens": chunk}, cache, policy=policy)
    if replayed:
        toks = torch.tensor([replayed], dtype=torch.int32, device="cuda")
        lg, cache = model.prefill_chunk(params, {"tokens": toks}, cache, policy=dense)
    rows = [lg[0]]
    for t in fed:
        lg, cache = model.decode_step(params, torch.tensor([[t]], dtype=torch.int32,
                                                           device="cuda"), cache, policy=dense)
        rows.append(lg[0])
    return rows


def near_tie(label, row, tok, what="", against=None):
    """Whether token ``tok`` is ``row``'s argmax (or the token ``against``,
    when given) or within ``NEAR_TIE_ULPS`` ulp of its logit: one rounding of
    the logits' own dtype at the largest |logit|.  With a ``label``, a token beyond that
    fails the phase, and one that is not the argmax is printed."""
    import torch

    ref = int(row.argmax()) if against is None else against
    big = float(row.abs().max())
    ulp = torch.finfo(row.dtype).eps * 2.0 ** math.floor(math.log2(big))
    gap = float(row[ref].float() - row[tok].float())
    ok = abs(gap) <= NEAR_TIE_ULPS * ulp
    if label is not None and tok != ref:
        print(f"  {label}: {what}: token {tok}, {ref} leads it by {gap:.4f} "
              f"({gap / ulp:.2f} ulp of {row.dtype} at the largest |logit| {big:.2f})")
        if not ok:
            fail(f"{label}: {what}: a lead of {gap} is more than {NEAR_TIE_ULPS} ulp ({ulp}): "
                 "not a near-tie")
    return ok


# a near-tie between two tokens: their logits at most this many ulps of the
# logits' dtype apart at the largest |logit| (bf16: 2^-5 at 4.34)
NEAR_TIE_ULPS = 1


def run_cli(torch, argv, label):
    """``repro_torch.launch.serve.main(argv)`` in this process, its output
    kept and echoed; the launch counts set to 0 just before and read just
    after.  Returns (output, launches, the trace run's MetricsSnapshot or
    None)."""
    import contextlib
    import io

    from repro_torch import kernels
    from repro_torch.launch.serve import run as serve_run

    print(f"{label}: python -m repro_torch.launch.serve {' '.join(argv)}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, met = serve_run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    out = buf.getvalue()
    if rc != 0:
        print(out)
        fail(f"{label}: the CLI returned {rc}")
    print(f"  rc 0 in {wall:.1f} s (weights included); launches {launches}")
    torch.cuda.empty_cache()
    return out, launches, met


def prune_launches(cfg, policy):
    """Launches per sparse prefill chunk under ``policy``: ``nm_prune_matmul``
    once per pruned float projection of each layer, by its kind (attention:
    q/k/v/o, and those of a dense MLP or a shared expert; rwkv6: r/k/v/g as
    q_proj, o, the channel mix's gate/down/up; rglru: W_in as q_proj, W_gate,
    W_out as o_proj and its MLP's), as the skip list says, and ``nm_prune``
    once per pruned input of the routed experts in every layer (layer None:
    the skip list does not reach them)."""
    from repro_torch.core.policy import ATTN_PROJS, MLP_PROJS
    from repro_torch.models.transformer import layer_kinds

    mods = {"attn": ATTN_PROJS + (MLP_PROJS if not cfg.n_experts or cfg.shared_expert else ()),
            "rwkv6": ("q_proj",) * 4 + ("o_proj", "gate_proj", "down_proj", "up_proj"),
            "rglru": ("q_proj", "gate_proj", "o_proj") + MLP_PROJS}
    fused = sum(policy.should_prune(mod, i) for i, kind in enumerate(layer_kinds(cfg))
                for mod in mods[kind])
    routed = cfg.n_layers * sum(policy.should_prune(mod, None) for mod in MLP_PROJS)
    return fused, routed if cfg.n_experts else 0


def phase_cli(torch):
    """Phases 6a and 6f: the CLI at full width, ``--trace`` on LLaMA-3.1-8B
    and one-shot on Qwen2-7B, each with its launch counts exact."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy

    check_trace_cli(torch, "llama31_8b", "phase 6a")
    check_trace_cli(torch, "llama31_8b", "phase 6a'", dp=2)

    out, launches, _ = run_cli(torch, ["--arch", "qwen2_7b", "--batch", "4", "--prompt-len",
                                       "512", "--new-tokens", "32"], "phase 6f")
    for line in out.splitlines():
        print(f"  {line}")
    if "greedy-decode agreement dense vs sparse-prefill:" not in out:
        fail("phase 6f: no agreement line")
    # the dense and the Amber engine each prefill once (only Amber's prunes)
    # and take 31 decode steps: a scatter per layer in every step, a paged
    # read per layer in every decode step (the prefill attends with
    # attn_impl="chunked")
    cfg = get_config("qwen2_7b")
    layers = cfg.n_layers
    check_launches("phase 6f", launches, {
        "nm_prune_matmul": prune_launches(cfg, paper_policy(8, 16, cfg.qgate_skip_layers))[0],
        "paged_kv_scatter": 2 * layers * 32, "paged_attention": 2 * layers * 31,
        "nm_spmm": 0, "flash_attention": 0, "osparse_matmul": 0})


TRACE_FLAGS = ["--trace", "--num-requests", "16", "--rate", "0.5", "--len-range", "64:700",
               "--slots", "4", "--chunk", "256", "--block-size", "16", "--new-tokens", "32",
               "--shared-prefix", "128", "--sparsity", "8:16"]


def check_trace_cli(torch, arch: str, label: str, dp: int = 1):
    """The ``--trace`` CLI at ``arch``'s full width with phase 6a's flags: rc
    0, its report lines echoed, every ``# traces:`` entry 1, one program per
    work iteration, prefix-cache hits, all 16 requests done, and the launch
    counts exact (from the snapshot's buckets).  ``dp`` > 1 (6a'): ``--dp``
    replicas and no shared prefix (prefix affinity would send every request
    to one replica): each replica served and captured each of its programs
    once, and the launches are exact over the replicas."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy

    flags = TRACE_FLAGS if dp == 1 else (TRACE_FLAGS[:TRACE_FLAGS.index("--shared-prefix")]
                                         + TRACE_FLAGS[TRACE_FLAGS.index("--sparsity"):]
                                         + ["--dp", str(dp)])
    out, launches, met = run_cli(torch, ["--arch", arch] + flags, label)
    lines = out.splitlines()
    for line in lines:
        if line.startswith(("# throughput", "# latency", "# traces", "# dispatches",
                            "# terminal", "# lifecycle", "# paged", "# prefix", "# replicas")):
            print(f"  {line}")
    parts = met.replicas
    if len(parts) != dp or not all(p.generated_tokens for p in parts):
        fail(f"{label}: {len(parts)} replicas reported, generated "
             f"{[p.generated_tokens for p in parts]}")
    for i, p in enumerate(parts):
        if not p.trace_counts or any(n != 1 for n in p.trace_counts.values()):
            fail(f"{label}: replica {i}'s trace_counts {p.trace_counts}: every program must "
                 "be captured once")
    if dp == 1:
        traces = next(line for line in lines if line.startswith("# traces:"))
        counts = re.findall(r"(\w+)=(\d+)", traces.split("(")[0])
        if not counts or any(n != "1" for _, n in counts):
            fail(f"{label}: {traces}: every program must be captured once")
    if "1.00 per work iteration" not in out:
        fail(f"{label}: the fused path did not run one program per work iteration")
    hits = int(re.search(r"# prefix cache: hits=(\d+)", out).group(1))
    if dp == 1 and hits < 1:
        fail(f"{label}: the prefix cache never hit on a 128-token shared prefix")
    if "ERROR" in out or "done=16 " not in out:
        fail(f"{label}: a request leaked or did not finish")
    _, _, st = step_counts(met.buckets, fused=True)
    cfg = get_config(arch)
    fused, routed = prune_launches(cfg, paper_policy(8, 16, cfg.qgate_skip_layers))
    per_step = cfg.n_layers * (st["prefill_halves"] + st["decode_halves"])
    print(f"  {st}")
    check_launches(label, launches, {
        "nm_prune_matmul": fused * st["sparse_chunks"],
        "nm_prune": routed * st["sparse_chunks"],
        "paged_kv_scatter": per_step, "paged_attention": per_step,
        "nm_spmm": 0, "flash_attention": 0, "osparse_matmul": 0})


def profile_steps(torch, model, params, policy, eng, max_seq=1024, chunk_pos=256,
                  decode_pos=(700, 500, 300, 100), extras=None):
    """One sparse 256-token prefill chunk (at offset ``chunk_pos``) and one
    dense 4-slot decode step (at ``decode_pos``) at full width, through
    :func:`profile_cases`: each eagerly through the model (on a cache of
    ``max_seq`` positions), and as the executor of ``eng`` runs it, a
    replay of the bucket's graph (``Executor.step``: operands in, replay,
    sampling, one host read) on its own cache (paged, or the dense slab),
    with the same positions.  ``extras`` (a request's modality arrays): a
    first chunk (at 0, carrying them: the encoder or the patch rows) is
    profiled the same way, before the others.  Returns
    (:func:`profile_cases`' results, per case a function that runs its
    computation eagerly: a replay's program body on the same operands and
    cache)."""
    from types import SimpleNamespace

    from repro_torch.core.policy import DENSE
    from repro_torch.serve.scheduler import DecodeWork, PrefillWork, StepPlan

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(SEED)
    pcache = model.init_cache(1, max_seq)
    pcache["pos"] = torch.tensor(chunk_pos, dtype=torch.int32, device="cuda")
    ptoks = torch.randint(0, cfg.vocab_size, (1, 256), generator=g, device="cuda")
    dcache = model.init_cache(4, max_seq)
    dpos = torch.tensor(decode_pos, dtype=torch.int32, device="cuda")
    dcache["pos"] = dpos.clone()
    dtoks = torch.randint(0, cfg.vocab_size, (4, 1), generator=g, device="cuda")
    dense = DENSE.with_(use_kernels=True)
    ex = eng.replica.exec
    slots = ex.cache["pos"].shape[0]
    if "block_table" in ex.cache:
        mb = ex.cache["block_table"].shape[1]
        ex.cache["block_table"].copy_(torch.arange(slots * mb, dtype=torch.int32,
                                                   device="cuda").reshape(slots, mb))
    ppos = torch.tensor([chunk_pos] + [0] * (slots - 1), dtype=torch.int32, device="cuda")
    prefill_plan = StepPlan(prefill=PrefillWork(
        SimpleNamespace(slot=0), ptoks.cpu().numpy().astype(np.int32), 256, False))
    decode_plan = StepPlan(decode=DecodeWork(
        [], dtoks[:, 0].cpu().numpy().astype(np.int32), np.ones(slots, dtype=bool)))

    def replay(plan, pos):
        ex.cache["pos"].copy_(pos)
        ex.step(params, plan)

    def body(plan, pos, ext=None):
        """The replayed step's program run eagerly on the same cache and
        operands: the same computation (it rewrites the same K/V rows)."""
        ex.cache["pos"].copy_(pos)
        ex._write_operands(plan, 0.0)
        return ex._programs[plan.bucket](params, ex.cache, *ex._views(),
                                         extras=ex._write_extras(ext) if ext else {})

    cases = {}
    if extras is not None:
        fcache = model.init_cache(1, max_seq)
        fbatch = {"tokens": ptoks, **{k: torch.as_tensor(v).cuda() for k, v in extras.items()}}
        zero = torch.zeros(slots, dtype=torch.int32, device="cuda")
        first_plan = StepPlan(prefill=PrefillWork(
            SimpleNamespace(slot=0), ptoks.cpu().numpy().astype(np.int32), 256, False, True))

        def replay_first():
            ex.cache["pos"].copy_(zero)
            ex.step(params, first_plan, 0.0, extras)

        cases["first prefill chunk (256 tokens at 0, with its extras), eager"] = (
            lambda: model.prefill_chunk(params, fbatch, fcache, policy=policy), None)
        cases["first prefill chunk, step_prefill graph replay (with extras)"] = (
            replay_first, lambda: body(first_plan, zero, extras))
    cases.update({
        f"prefill chunk (256 tokens at {chunk_pos}, paper policy), eager":
            (lambda: model.prefill_chunk(params, {"tokens": ptoks}, pcache, policy=policy),
             None),
        "prefill chunk, step_prefill graph replay":
            (lambda: replay(prefill_plan, ppos), lambda: body(prefill_plan, ppos)),
        "decode step (4 slots, dense), eager":
            (lambda: model.decode_step(params, dtoks, dcache, policy=dense), None),
        "decode step, step_decode graph replay":
            (lambda: replay(decode_plan, dpos), lambda: body(decode_plan, dpos)),
    })
    traces = dict(ex.trace_counts)
    results = profile_cases(torch, {case: fn for case, (fn, _) in cases.items()})
    if ex.trace_counts != traces:
        fail(f"profile: trace_counts {ex.trace_counts} (before {traces}): a bucket was "
             "captured again")
    # each case's computation run eagerly (a replay's through its program)
    return results, {case: eager or fn for case, (fn, eager) in cases.items()}


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
# the MoE layers' grouped product (torch._grouped_mm: CUTLASS's grouped GEMM
# over a GroupProblemShape, and the pass that lays out its problem sizes)
GROUPED_GEMM = ("grouped product", ("group",))
LIBRARY_GEMM = ("cuBLAS GEMM", ("gemm", "nvjet", "cutlass", "xmma", "gemv"))
OTHER = "other (elementwise, norms, copies)"


def kernel_family(key: str) -> str:
    """The profile family of one profiler kernel key."""
    names = set(re.findall(r"[A-Za-z_]\w*", key))
    for name, kernels in FAMILIES:
        if names.intersection(kernels):
            return name
    low = key.lower()
    for name, fragments in (GROUPED_GEMM, LIBRARY_GEMM):
        if any(k in low for k in fragments):
            return name
    return OTHER


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
    results = {}
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
        by_family = {name: 0.0 for name, _ in FAMILIES + (GROUPED_GEMM, LIBRARY_GEMM)}
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
            results[case] = dict(wall_ms=wall_ms, busy_ms=None, by_family=None)
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
        results[case] = dict(wall_ms=wall_ms, busy_ms=busy_ms, by_family=by_family)
    return results


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


@contextlib.contextmanager
def spy_projections(hook):
    """Every projection call of the port's model passes its input to
    ``hook(x, p, module, policy, phase, layer_idx)`` first.  The port's
    projections are functions over ``Linear`` modules (``sparse_linear``,
    which ``models/transformer.py``, ``models/mlp.py``, ``models/rwkv6.py``,
    ``models/rglru.py`` and ``models/encdec.py`` call by name), so
    ``nn.Module`` forward hooks never fire: this is their counterpart."""
    from repro_torch.models import encdec, rglru, rwkv6, transformer
    from repro_torch.models import mlp as mlp_lib

    mods = (transformer, mlp_lib, rwkv6, rglru, encdec)
    real = transformer.sparse_linear

    def spy(x, p, module, policy, phase, layer_idx=None):
        hook(x, p, module, policy, phase, layer_idx)
        return real(x, p, module, policy, phase, layer_idx)

    for mod in mods:
        mod.sparse_linear = spy
    try:
        yield
    finally:
        for mod in mods:
            mod.sparse_linear = real


def nm_flips(torch, run):
    """N:M flips between the kernel path and the plain path.  ``run(use_kernels)``
    drives one computation on one path; every pruned float projection's
    input gets its per-token keep mask (``core.nm.nm_topk_mask`` of
    |x|·scale: the selection both paths make, bit-exact on equal inputs),
    the calls of the two runs are paired in order, and the groups of M
    channels whose kept set differs are counted.  Returns {(module, layer):
    [flipped groups, groups]}."""
    from repro_torch.core import nm, scoring
    from repro_torch.layers.linear import Linear

    masks = {True: [], False: []}

    def recorder(use_kernels):
        def hook(x, p, module, policy, phase, layer):
            if (isinstance(p, Linear) and policy.active(phase)
                    and policy.should_prune(module, layer)):
                keep = nm.nm_topk_mask(scoring.score_activations(x, p.amber_scale),
                                       policy.n, policy.m)
                masks[use_kernels].append(((module, layer), keep.reshape(-1, policy.m)))
        return hook

    for use_kernels in (True, False):
        with spy_projections(recorder(use_kernels)):
            run(use_kernels)
    if [k for k, _ in masks[True]] != [k for k, _ in masks[False]]:
        fail("nm_flips: the two paths pruned different projections")
    table = {}
    for (key, a), (_, b) in zip(masks[True], masks[False]):
        row = table.setdefault(key, [0, 0])
        row[0] += int((a != b).any(-1).sum())
        row[1] += a.shape[0]
    return table


def print_flips(label, table):
    for (module, layer), (flipped, groups) in sorted(table.items(),
                                                     key=lambda kv: (kv[0][1], kv[0][0])):
        print(f"  {label} N:M flips, layer {layer} {module}: {flipped} of {groups} groups "
              f"({flipped / groups:.3e})")
    flipped = sum(r[0] for r in table.values())
    groups = sum(r[1] for r in table.values())
    print(f"  {label} N:M flips in all: {flipped} of {groups} groups ({flipped / groups:.3e}) "
          f"over {len(table)} (projection, layer) pairs")


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


def phase_parity(torch, quantized: bool, dtype: str = "float32", arch: str = "llama31_8b",
                 label: str = "phase 4"):
    """Full width, depth 2: the same staggered requests through two paths,
    and each prompt's last-chunk logits (chunk by chunk on fresh caches).
    Phase 8f runs phases 4 and 4 bf16 on the dense variants (``arch``), with
    seeded LayerNorm and q/k/v biases.

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
    comparison is printed, not checked.  In float32 without W8A8, the N:M
    flips between the paths on prompt 0 are counted per projection and
    layer (:func:`nm_flips`)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import quant
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.kernels import ops
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousConfig, Engine, EngineConfig
    from repro_torch.weights import quantize_linears

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype=dtype)
    bf16 = dtype == "bfloat16"
    model = build_model(cfg)
    params = model.init(SEED + 1)
    seed_biases(torch, params, SEED + 101)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers)
    precompute_scales(params, policy)
    what = (f"{cfg.name} (norm {cfg.norm}, rope {cfg.rope_variant}, G = "
            f"{cfg.n_heads // cfg.n_kv_heads}, head_dim {cfg.head_dim})")
    if bf16:
        print(f"{label} bf16: {what} kernel path vs plain path, full width, depth 2, bfloat16")
    elif quantized:
        print(f"{label}b: Outstanding-sparse kernel path vs the same path with "
              "osparse_matmul's plain version, full width, depth 2, float32")
        rng = np.random.default_rng(SEED + 4)
        quantize_linears(params, {(i, name): calib_absmax(rng, cfg.d_model)
                                  for i in range(cfg.n_layers) for name in QPROJS},
                         quant.QuantConfig())
    else:
        print(f"{label}: {what} kernel path vs plain path, full width, depth 2, float32")
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

    kernels.reset_launch_counts()
    got, got_logits = run("kernel")
    torch.cuda.synchronize()
    # the attention's route: float32 keeps the CUDA-core rows kernel, bf16
    # never takes it (every head_dim the models have is a multiple of 8)
    routes = dict(kpa.paged_attention.route_launches)
    n_attn = kpa.paged_attention.launches
    want_routes = ({"wgmma": n_attn, "rows": 0} if bf16 else {"wgmma": 0, "rows": n_attn})
    if n_attn <= 0 or routes != want_routes:
        fail(f"{label}: paged_attention routes {routes} of {n_attn} launches on the kernel "
             f"path, expected {want_routes}")
    print(f"  prompts {[len(p) for p in prompts]}: kernel path {got}; paged_attention "
          f"{n_attn} launches, routes {routes}")
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
    if not (bf16 or quantized):
        # the cause of the logits' distance: N:M selections that part
        # between the paths on prompt 0's chunks
        def prompt0(use_kernels):
            pol = policy.with_(use_kernels=use_kernels)
            cache = model.init_cache(1, max_seq, block_size=bsz)
            for s in range(0, len(prompts[0]), 256):
                chunk = torch.from_numpy(prompts[0][s:s + 256][None, :]).cuda()
                _, cache = model.prefill_chunk(params, {"tokens": chunk}, cache, policy=pol)

        print_flips(f"{label} {cfg.name} prompt 0", nm_flips(torch, prompt0))
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


def timed_generate(torch, eng, params, prompts, new, extras=None):
    """Wall seconds of ``eng.generate`` (greedy) with 1 new token (the
    prefill replay and its sample) and with ``new`` tokens, each ended by a
    synchronise: (tokens, prefill seconds, decode seconds = the difference).
    ``extras``: the batch's modality stubs."""
    batch = {"tokens": prompts, **(extras or {})}
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
    eager._graphs.run = lambda name, fn, params, shape=None: fn()
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


# ------------------------------------------------------- the MoE family

def grouped_bound(ids_per_layer, d: int, f: int, rates):
    """Least time of one step's grouped products (gate, up, down in every
    layer) for the routing it got: each hit expert's three weight matrices
    read once, the gathered inputs and h read once, the outputs written
    once; against 2·R·D·F multiply-adds per product.  → (ms, bound_by,
    distinct experts summed over the layers)."""
    bw, bf16_peak = rates[0], rates[1]
    nbytes = ops = hit = 0
    for ids in ids_per_layer:
        r = ids.numel()
        n_hit = int(ids.unique().numel())
        hit += n_hit
        nbytes += (n_hit * 3 * d * f + 2 * r * d + r * f + 2 * r * f + r * d) * 2
        ops += 3 * 2 * r * d * f
    by = "bytes" if nbytes / bw >= ops / bf16_peak else "operations"
    return max(nbytes / bw, ops / bf16_peak) * 1e3, by, hit


def phase_grouped_product(torch, timer, rates):
    """2i: the grouped product (``models.moe.grouped_matmul``, one
    ``torch._grouped_mm`` call; a library call, not a kernel of the port)
    against its plain per-expert loop at Qwen3-30B-A3B's widths: a prefill
    chunk's 256 x 8 routed rows and a 4-slot decode step's 32, seeded
    routing with empty groups; its profiler kernel names."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe as moe_lib

    print("phase 2i: grouped product (torch._grouped_mm) vs the per-expert loop")
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    e, d, f = 128, 2048, 768
    wg = (torch.randn(e, d, f, generator=g, device="cuda") * d**-0.5).bfloat16()
    wd = (torch.randn(e, f, d, generator=g, device="cuda") * f**-0.5).bfloat16()
    for label, tokens in (("prefill chunk", 256), ("decode step", 4)):
        logits = torch.randn(tokens, e, generator=g, device="cuda")
        logits[:, 5:9] = -1e9                     # experts 5-8 never routed: empty groups
        ids = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :8]
        flat = ids.reshape(-1)
        counts = torch.zeros(e, dtype=torch.int32, device="cuda").index_add_(
            0, flat, torch.ones_like(flat, dtype=torch.int32))
        offs = torch.cumsum(counts, 0, dtype=torch.int32)
        r = flat.numel()
        x = torch.randn(r, d, generator=g, device="cuda").bfloat16()
        h = torch.randn(r, f, generator=g, device="cuda").bfloat16()
        for name, a, w in (("gate", x, wg), ("down", h, wd)):
            got = moe_lib.grouped_matmul(a, w, offs)
            check_close(f"{label} {name} R={r}", got, moe_lib.grouped_matmul_plain(a, w, offs),
                        BF16_TOL)
            ms = timer.ms(lambda: moe_lib.grouped_matmul(a, w, offs))
            plain_ms = timer.ms(lambda: moe_lib.grouped_matmul_plain(a, w, offs), 3)
            n_hit = int(flat.unique().numel())
            nbytes = (n_hit * w.shape[1] * w.shape[2] + a.numel() + r * w.shape[2]) * 2
            ops = 2 * r * w.shape[1] * w.shape[2]
            bound = max(nbytes / rates[0], ops / rates[1]) * 1e3
            by = "bytes" if nbytes / rates[0] >= ops / rates[1] else "operations"
            print(f"  {label} {name} ({r} rows, {n_hit} of {e} experts hit): "
                  f"torch._grouped_mm {ms:.4f} ms, bound {bound:.4f} ms ({by}), per-expert "
                  f"loop {plain_ms:.4f} ms")
    grouped_backward(torch, timer, rates, g, wg, wd)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        moe_lib.grouped_matmul(x, wg, offs)
        torch.cuda.synchronize()
    keys = [ev.key for ev in prof.key_averages() if ev.self_device_time_total > 0]
    for key in keys:
        print(f"  profiler kernel: {key[:140]} -> family {kernel_family(key)!r}")
    if not any(kernel_family(k) == GROUPED_GEMM[0] for k in keys):
        fail(f"phase 2i: no profiler kernel of torch._grouped_mm falls in the "
             f"{GROUPED_GEMM[0]!r} family: {keys}")


def grouped_backward(torch, timer, rates, g, wg, wd):
    """2i, training: the grouped product's backward (``torch._grouped_mm``'s
    own: ``dX`` one grouped call on the transposed weights, ``dW`` one of
    ``Xᵀ · dY`` with the offsets along K) at 13f's routed rows (4 x 512
    tokens routed 8 ways over Qwen3-30B-A3B's 128 experts, experts 5-8
    never hit, most groups' lengths not multiples of 8): ``dX`` and ``dW``
    against the per-expert loop's autograd within ``BF16_TOL``, timed beside
    the bound of the two products."""
    from repro_torch.models import moe as moe_lib

    e = wg.shape[0]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    logits = torch.randn(tokens, e, generator=g, device="cuda")
    logits[:, 5:9] = -1e9
    flat = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :8].reshape(-1)
    counts = torch.zeros(e, dtype=torch.int32, device="cuda").index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    r = flat.numel()
    odd = int((counts % 8 != 0).sum())
    for name, w in (("gate", wg), ("down", wd)):
        k, n_out = w.shape[1], w.shape[2]
        x = torch.randn(r, k, generator=g, device="cuda").bfloat16()
        dy = torch.randn(r, n_out, generator=g, device="cuda").bfloat16()
        outs = []
        for fn in (moe_lib.grouped_matmul, moe_lib.grouped_matmul_plain):
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            outs.append(torch.autograd.grad(fn(xa, wa, offs), [xa, wa], dy))
        (dx, dw), (dx_p, dw_p) = outs
        check_close(f"2i backward {name} dX R={r}", dx, dx_p, BF16_TOL)
        check_close(f"2i backward {name} dW R={r}", dw, dw_p, BF16_TOL)
        if bool(dw[5:9].any()):
            fail(f"2i backward {name}: an empty group's dW is not 0")
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = moe_lib.grouped_matmul(xa, wa, offs)
        ms = timer.ms(lambda: torch.autograd.grad(y, [xa, wa], dy, retain_graph=True))
        n_hit = int(flat.unique().numel())
        # dY, X and the hit experts' weights read once; dX and all of dW written
        nbytes = (r * n_out + r * k + n_hit * k * n_out + r * k + e * k * n_out) * 2
        ops = 2 * 2 * r * k * n_out
        bound = max(nbytes / rates[0], ops / rates[1]) * 1e3
        by = "bytes" if nbytes / rates[0] >= ops / rates[1] else "operations"
        print(f"  2i backward {name} ({r} rows, {n_hit} of {e} experts hit, {odd} group "
              f"lengths not a multiple of 8, experts 5-8 empty): dX and dW within BF16_TOL of "
              f"the per-expert loop's, the empty groups' dW 0; dX + dW {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by})")


def free_device(torch, label: str):
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {label}: device memory held {torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def qwen3_moe(torch, n_layers=None, seed=SEED, skip=None, dtype=None):
    """Qwen3-30B-A3B (depth, q/gate skip list and dtype optionally changed),
    random weights from ``seed`` made on the card, the paper's policy with
    the kernels on and the Amber scales (q_proj's: the routed experts get
    none)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model

    cfg = get_config("qwen3_30b_a3b")
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                              dtype=dtype or cfg.dtype)
    model = build_model(cfg)
    params = model.init(seed)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers if skip is None else skip
                          ).with_(use_kernels=True)
    precompute_scales(params, policy)
    return cfg, model, params, policy


def phase_moe_serve(torch, rates):
    """7a and 7b: Qwen3-30B-A3B at full width and depth served as phase 3
    serves LLaMA-3.1-8B, launches exact, the replayed steps profiled with the
    grouped product's time beside its bound, graphed tokens against eager.
    Returns (launches, step counts and rates, model, params, policy)."""
    t0 = time.perf_counter()
    cfg, model, params, policy = qwen3_moe(torch)
    torch.cuda.synchronize()
    n_w = sum(p.numel() for p in params.parameters())
    print(f"phase 7a: serve {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts "
          f"top-{cfg.top_k}, moe_d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}), "
          f"paper_policy(8, 16, {cfg.qgate_skip_layers}) with the kernels")
    print(f"  random weights: {n_w / 1e9:.3f}B parameters (n_params {cfg.n_params() / 1e9:.3f}B,"
          f" active {cfg.n_active_params() / 1e9:.3f}B) in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    fused, routed = prune_launches(cfg, policy)
    if (fused, routed) != (45, 96):
        fail(f"phase 7a: the paper policy prunes {fused} projections and {routed} expert "
             "inputs per chunk, expected 45 (q in 48 - 3 layers) and 96 (expert gate and "
             "down inputs in 48 layers)")
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, "phase 7a")
    per_step = cfg.n_layers * (st["prefill_halves"] + st["decode_halves"])
    check_launches("phase 7a", launches, {
        "nm_prune_matmul": fused * st["sparse_chunks"], "nm_prune": routed * st["sparse_chunks"],
        "paged_kv_scatter": per_step, "paged_attention": per_step,
        "nm_spmm": 0, "flash_attention": 0, "osparse_matmul": 0})
    print(f"  launches held: per sparse chunk nm_prune_matmul {fused} (q_proj, 48 - 3 layers),"
          f" nm_prune {routed} (expert gate and down inputs, 2 x 48); paged_kv_scatter and "
          f"paged_attention {cfg.n_layers} per prefill or decode half")

    print("phase 7b: profile one prefill chunk and one decode step of Qwen3-30B-A3B")
    results, eager = profile_steps(torch, model, params, policy, eng)
    grouped_report(torch, cfg, results, eager, rates)
    del eng
    check_graphed_tokens(torch, model, params, policy, "phase 7a", outputs)
    return launches, st, model, params, policy


def grouped_report(torch, cfg, results, eager, rates):
    """Each profiled case's grouped product beside the bound of its own
    routing (:func:`grouped_bound`)."""
    from repro_torch.models import moe as moe_lib

    # each case's routing, recorded in one more eager run of its computation:
    # the eager chunk attends over a zeroed cache, the replayed one over the
    # engine's K/V of earlier requests (which routes the random-weight
    # model's tokens to fewer experts), so each case has its own bound
    seen, real = [], moe_lib.route

    def spy(xt, w, k):
        out = real(xt, w, k)
        seen.append(out[1])
        return out

    moe_lib.route = spy
    try:
        bounds = {}
        for case, fn in eager.items():
            seen.clear()
            fn()
            torch.cuda.synchronize()
            bounds[case] = grouped_bound(seen, cfg.d_model, cfg.moe_d_ff, rates)
    finally:
        moe_lib.route = real
    for case, res in results.items():
        bound, by, hit = bounds[case]
        fam = res["by_family"] or {}
        gms = fam.get(GROUPED_GEMM[0])
        gtxt = "not recorded" if gms is None else f"{gms:.3f} ms"
        print(f"  {case}: grouped product {gtxt} of the step's busy "
              f"{res['busy_ms'] if res['busy_ms'] is None else round(res['busy_ms'], 3)} ms "
              f"(wall {res['wall_ms']:.3f}); its bound {bound:.3f} ms ({by}; {hit} experts "
              f"hit over {cfg.n_layers} layers, of {cfg.n_layers * cfg.n_experts})")


def moe_parity_stream(cfg):
    """7c's and 7e''s inputs: 3 seeded prompts of 64-600 tokens, 8 seeded
    decode tokens each, and a cache length of blocks of 16 that holds
    them."""
    rng = np.random.default_rng(SEED + 7)
    prompts = make_requests(rng, 3, 64, 600, cfg.vocab_size)
    dec = rng.integers(0, cfg.vocab_size, size=(len(prompts), 8))
    max_seq = -(-(max(len(p) for p in prompts) + dec.shape[1]) // 16) * 16
    return prompts, dec, max_seq


def chunked_logits(torch, mdl, prm, pol, prompts, dec, max_seq, mark=lambda first: None):
    """Per prompt, on a fresh cache: its 256-token chunks, the last chunk's
    logits, then one decode step per token of its row of ``dec`` and each
    step's logits.  ``mark(first)`` runs before every step, ``first`` true
    for prompt 0's first chunk and first decode step."""
    logits = []
    for i, prompt in enumerate(prompts):
        cache = mdl.init_cache(1, max_seq, block_size=16)
        for s in range(0, len(prompt), 256):
            mark(i == 0 and s == 0)
            chunk = torch.from_numpy(prompt[s:s + 256][None, :]).cuda()
            lg, cache = mdl.prefill_chunk(prm, {"tokens": chunk}, cache, policy=pol)
        logits.append(lg)
        for j in range(dec.shape[1]):
            mark(i == 0 and j == 0)
            tok = torch.from_numpy(dec[i, j:j + 1][None, :].astype(np.int32)).cuda()
            lg, cache = mdl.decode_step(prm, tok, cache, policy=pol)
            logits.append(lg)
    mark(False)
    torch.cuda.synchronize()
    return logits


def phase_moe_parity(torch):
    """7c: full width, depth 4, bf16, q/gate skipped in layer 3 (as the full
    model skips 41, 46 and 47: its experts are still pruned).  Three prompts
    prefilled in 256-token chunks, then 8 decode steps on seeded tokens,
    through the kernel path, the plain path (``nm_prune_plain``, the
    per-expert loop, the plain attention; eager: the loop reads its offsets
    on the host) and the plain path in float32 on the same weights.  The
    kernel path's logits must be within BF16_E2E_FACTOR times the plain
    path's own bf16 effect (:func:`check_bf16_logits`).  Expert ids: the
    two bf16 paths route each layer on their own hidden states, which
    differ by rounding, so a near-tie between the 8th and 9th logit may
    part them: the share of equal routes is printed.  Each layer is then
    held alone on the plain path's own inputs (the chunk's): both paths
    route identically (the router is float32 on both), and the kernel path's
    output is within the same factor of the plain path's bf16 effect."""
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib

    print("phase 7c: Qwen3-30B-A3B kernel path vs plain path, full width, depth 4, bf16")
    cfg, model, params, policy = qwen3_moe(torch, n_layers=4, seed=SEED + 1, skip=(3,))
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = copy.deepcopy(params).float()
    plain = policy.with_(use_kernels=False)
    prompts, dec, max_seq = moe_parity_stream(cfg)
    new = dec.shape[1]
    routes, inputs = [], []
    real_route, real_moe = moe_lib.route, moe_lib.moe

    def spy_route(xt, w, k):
        out = real_route(xt, w, k)
        routes.append(out[1])
        return out

    def spy_moe(x, p, pol, phase, *args, **kw):
        inputs.append(x.clone())
        return real_moe(x, p, pol, phase, *args, **kw)

    def run(mdl, prm, pol, record=False):
        """Per prompt: the last chunk's logits, then each decode step's."""
        routes.clear()
        moe_lib.route = spy_route
        moe_lib.moe = spy_moe if record else real_moe
        try:
            return chunked_logits(torch, mdl, prm, pol, prompts, dec, max_seq), list(routes)
        finally:
            moe_lib.route, moe_lib.moe = real_route, real_moe

    kernels.reset_launch_counts()
    got, got_routes = run(model, params, policy)
    launches = kernels.launch_counts()
    chunks = sum(-(-len(p) // 256) for p in prompts)
    fused, routed = prune_launches(cfg, policy)
    print(f"  prompts {[len(p) for p in prompts]} ({chunks} chunks), {new} decode steps "
          f"each; kernel-path launches {launches}")
    check_launches("phase 7c", launches, {
        "nm_prune_matmul": fused * chunks, "nm_prune": routed * chunks,
        "paged_kv_scatter": cfg.n_layers * (chunks + len(prompts) * new),
        "paged_attention": cfg.n_layers * (chunks + len(prompts) * new)})
    inputs.clear()
    want, want_routes = run(model, params, plain, record=True)
    chunk_inputs = inputs[:cfg.n_layers]          # prompt 0's first chunk, layer by layer
    ref, _ = run(model32, params32, plain)
    check_bf16_logits(got, want, ref)
    rows = [bool((a == b).all(-1).all()) for a, b in zip(got_routes, want_routes)]
    tok_equal = sum(int((a == b).all(-1).sum()) for a, b in zip(got_routes, want_routes))
    tok_all = sum(a.shape[0] for a in got_routes)
    print(f"  whole-model routing (each path on its own hidden states): {tok_equal} of "
          f"{tok_all} (token, layer) routes equal ({tok_equal / tok_all:.4f}); "
          f"{sum(rows)} of {len(rows)} MoE calls routed identically")
    for layer, x in enumerate(chunk_inputs):
        blk, blk32 = params.blocks[layer].moe, params32.blocks[layer].moe
        outs = []
        for p, pol, xin in ((blk, policy, x), (blk, plain, x), (blk32, plain, x.float())):
            routes.clear()
            moe_lib.route = spy_route
            try:
                outs.append(real_moe(xin, p, pol, "prefill", cfg.top_k, cfg.act_fn,
                                     cfg.moe_impl, layer))
            finally:
                moe_lib.route = real_route
            outs.append(routes[0])
        yk, ik, yp, ip, yr, ir = outs
        if not (torch.equal(ik, ip) and torch.equal(ik, ir)):
            fail(f"phase 7c: layer {layer}: the kernel and plain paths route one input "
                 "differently")
        e_ref = float((yp.float() - yr).abs().max())
        err = float((yk.float() - yp.float()).abs().max())
        if not bool(yk.isfinite().all()) or not err <= BF16_E2E_FACTOR * e_ref:
            fail(f"phase 7c: layer {layer} MoE: kernel vs plain {err} > "
                 f"{BF16_E2E_FACTOR} x {e_ref}")
        print(f"  layer {layer} MoE alone on the plain path's input ({x.shape[1]} tokens): "
              f"expert ids identical; kernel vs plain max_abs_err {err:.3e} (limit "
              f"{BF16_E2E_FACTOR * e_ref:.3e} = {BF16_E2E_FACTOR} x the plain path's bf16 "
              f"effect {e_ref:.3e}; largest |y| {float(yr.abs().max()):.3e})")
    del params, params32, model, model32


def phase_moe_osparse(torch, model, params, policy, st7a):
    """7e: 7a's weights with the attention rewritten Outstanding-sparse in
    place (``QuantConfig()``: q/k/v/o to int8 with the static per-tensor
    activation scale from a seeded calibration absmax, as 3b; the routed
    experts stay bf16, as the reference's do), served with phase 3's stream:
    launches exact, every ``osparse_matmul`` launch on its wgmma or
    swap_fused route, the stream's peak allocated memory at most 7a's, a
    chunk and a decode step profiled, graphed tokens equal to the eager
    step programs'.  Returns its launches."""
    from repro_torch.core import quant
    from repro_torch.core.policy import ATTN_PROJS
    from repro_torch.layers.linear import QuantLinear
    from repro_torch.models.common import dtype_of
    from repro_torch.weights import quantize_linears

    cfg = model.cfg
    qcfg = quant.QuantConfig()
    print(f"phase 7e: serve {cfg.name} Outstanding-sparse at full width and depth (W8A8 on "
          f"q/k/v/o: alpha={qcfg.alpha} outstanding={qcfg.outstanding} per_token="
          f"{qcfg.per_token_act}; the routed experts stay {cfg.dtype}; paper_policy(8, 16, "
          f"{cfg.qgate_skip_layers}))")
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    absmax = {(i, name): calib_absmax(rng, cfg.q_dim if name == "o_proj" else cfg.d_model)
              for i in range(cfg.n_layers) for name in ATTN_PROJS}
    torch.cuda.reset_peak_memory_stats()
    quantize_linears(params, absmax, qcfg)
    torch.cuda.synchronize()
    rewrite_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    for blk in params.blocks:
        if not all(isinstance(getattr(blk, n), QuantLinear) for n in ATTN_PROJS):
            fail("phase 7e: an attention projection was not quantized")
        if blk.moe.experts.gate_proj.dtype != dtype_of(cfg):
            fail("phase 7e: the routed experts left the model dtype")
    n_q = sum(b.numel() for n_, b in params.named_buffers() if n_.endswith(".wq"))
    print(f"  rewrite in {time.perf_counter() - t0:.1f} s (peak {rewrite_peak:.2f} GiB "
          f"allocated): {n_q} int8 weight bytes ({n_q / 2**30:.3f} GiB) held; device memory "
          f"held {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pruned = sum(policy.should_prune("q_proj", i) for i in range(cfg.n_layers))
    routed = prune_launches(cfg, policy)[1]
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, "phase 7e")
    halves = st["prefill_halves"] + st["decode_halves"]
    per_step = cfg.n_layers * halves
    check_launches("phase 7e", launches, {
        "osparse_matmul": len(ATTN_PROJS) * per_step,
        "osparse_matmul (prune=True)": pruned * st["sparse_chunks"],
        "nm_prune_matmul": 0, "nm_prune": routed * st["sparse_chunks"],
        "paged_kv_scatter": per_step, "paged_attention": per_step,
        "nm_spmm": 0, "flash_attention": 0})
    routes = {r: c for r, c in launches["osparse_matmul routes"].items() if c}
    print(f"  launches held: osparse_matmul {len(ATTN_PROJS)} a layer per prefill or decode "
          f"half ({pruned} pruned a sparse chunk: q outside the skip list), nm_prune "
          f"{routed} a sparse chunk, no nm_prune_matmul; osparse_matmul by route {routes}")
    if not routes or not set(routes) <= {"wgmma", "swap_fused"}:
        fail(f"phase 7e: osparse_matmul launches by route {routes}, expected wgmma "
             "(prefill) and swap_fused (decode) only")
    print(f"  7e vs 7a: prefill {st['prefill_tok_s']:.1f} / decode {st['decode_tok_s']:.1f} "
          f"tok/s against {st7a['prefill_tok_s']:.1f} / {st7a['decode_tok_s']:.1f}; peak "
          f"{st['peak_alloc_gib']:.2f} / {st['peak_reserved_gib']:.2f} GiB allocated / "
          f"reserved against {st7a['peak_alloc_gib']:.2f} / {st7a['peak_reserved_gib']:.2f}")
    if not st["peak_alloc_gib"] <= st7a["peak_alloc_gib"]:
        fail(f"phase 7e: peak {st['peak_alloc_gib']:.2f} GiB allocated exceeds 7a's "
             f"{st7a['peak_alloc_gib']:.2f}")
    profile_steps(torch, model, params, policy, eng)
    del eng
    check_graphed_tokens(torch, model, params, policy, "phase 7e", outputs)
    return launches


def phase_moe_osparse_parity(torch, per_token: bool):
    """7e': 7c's model (full width, depth 4, bf16, q/gate skipped in layer 3)
    with q/k/v/o rewritten Outstanding-sparse (static per-tensor or, with
    ``per_token``, dynamic per-token activation scales), through the kernel
    path, the plain path and the plain path in float32 on the same weights
    (7c's prompts, chunks and decode steps).  The logits are held by
    :func:`check_bf16_logits`; on the plain path's own inputs of prompt 0's
    first chunk and first decode step, every quantized projection's int8
    codes and scales from the kernel's quantize pass equal its plain
    version's, bit for bit."""
    from repro_torch import kernels
    from repro_torch.core import quant
    from repro_torch.core.policy import ATTN_PROJS
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.layers.linear import QuantLinear
    from repro_torch.models import build_model
    from repro_torch.weights import quantize_linears

    mode = "per-token" if per_token else "static per-tensor"
    print(f"phase 7e': Qwen3-30B-A3B W8A8 ({mode} activation scales) kernel path vs plain "
          "path, full width, depth 4, bf16")
    cfg, model, params, policy = qwen3_moe(torch, n_layers=4, seed=SEED + 1, skip=(3,))
    rng = np.random.default_rng(SEED + 4)
    quantize_linears(params, {(i, name): calib_absmax(rng, cfg.q_dim if name == "o_proj"
                                                      else cfg.d_model)
                              for i in range(cfg.n_layers) for name in ATTN_PROJS},
                     quant.QuantConfig(per_token_act=per_token))
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = copy.deepcopy(params).float()
    plain = policy.with_(use_kernels=False)
    prompts, dec, max_seq = moe_parity_stream(cfg)
    inputs, recording = [], [False]

    def hook(x, p, module, pol, phase, layer):
        if recording[0] and isinstance(p, QuantLinear):
            prune = pol.active(phase) and pol.should_prune(module, layer)
            inputs.append((module, layer, phase, x.reshape(-1, x.shape[-1]).contiguous(),
                           p, prune))

    def run(mdl, prm, pol, record=False):
        def mark(first):
            recording[0] = record and first

        with spy_projections(hook):
            return chunked_logits(torch, mdl, prm, pol, prompts, dec, max_seq, mark)

    kernels.reset_launch_counts()
    got = run(model, params, policy)
    launches = kernels.launch_counts()
    print(f"  prompts {[len(p) for p in prompts]}, {dec.shape[1]} decode steps each; "
          f"kernel-path launches {launches}")
    if launches["osparse_matmul"] <= 0 or launches["nm_prune_matmul"] != 0:
        fail(f"phase 7e': kernel-path launches {launches}: every attention projection must "
             "go through osparse_matmul")
    want = run(model, params, plain, record=True)
    ref = run(model32, params32, plain)
    check_bf16_logits(got, want, ref)
    for module, layer, phase, x, p, prune in inputs:
        args = (x, p.smooth, p.amber_scale, policy.n, policy.m,
                None if p.per_token else p.act_scale, prune, p.per_token)
        q, sc = kos.osparse_quantize(*args)
        q0, sc0 = kos.osparse_quantize_plain(*args)
        if not (torch.equal(q, q0) and torch.equal(sc, sc0)):
            fail(f"phase 7e': {module} layer {layer} ({phase}, prune={prune}): the kernel's "
                 "int8 codes or scales differ from the plain version's")
    n_pre = sum(1 for c in inputs if c[2] == "prefill")
    if not (n_pre and len(inputs) > n_pre):
        fail(f"phase 7e': {len(inputs)} quantized projection calls recorded")
    print(f"  int8 codes and scales bit-exact on the plain path's inputs: {n_pre} quantized "
          f"projection calls of prompt 0's first chunk ({sum(c[5] for c in inputs)} pruned) "
          f"and {len(inputs) - n_pre} of its first decode step")
    del params, params32, model, model32


def phase_moe(torch, rates):
    """Phase 7: the MoE family at full width on the card.  Returns 7a's and
    7e's launch counts."""
    free_device(torch, "before phase 7 (phases 3-6 freed)")
    launches, st, model, params, policy = phase_moe_serve(torch, rates)
    q_launches = phase_moe_osparse(torch, model, params, policy, st)
    del model, params
    free_device(torch, "after 7a/7b/7e")
    phase_moe_parity(torch)
    free_device(torch, "after 7c")
    for per_token in (False, True):
        phase_moe_osparse_parity(torch, per_token)
    free_device(torch, "after 7e'")
    check_trace_cli(torch, "qwen3_30b_a3b", "phase 7d")
    free_device(torch, "after 7d")
    return launches, q_launches


# ------------------------------------------------ the dense-family variants

# (label, Hq, Hkv, head_dim): Qwen2.5-32B, ChatGLM3-6B, Granite-34B (MQA)
# and StableLM-3B (MHA at head_dim 80, the wgmma kernel's 128-column tile)
VARIANT_HEADS = (("Qwen2.5-32B G=5", 40, 8, 128), ("ChatGLM3-6B G=16", 32, 2, 128),
                 ("Granite-34B G=48", 48, 1, 128), ("StableLM-3B hd=80 G=1", 32, 32, 80))
# flash_attention's causal cases of 2j: (label, B, T, Hq, Hkv, head_dim,
# window); RecurrentGemma-2B's local attention (10 query heads on one KV
# head of 256, window 2048) on the 256-column tile
FLASH_VARIANT_HEADS = (("StableLM-3B hd=80 G=1", 4, 512, 32, 32, 80, 0),
                       ("ChatGLM3-6B G=16", 4, 512, 32, 2, 128, 0),
                       ("RecurrentGemma-2B hd=256 G=10 window 2048", 1, 4096, 10, 1, 256, 2048))
# nm_prune_matmul's projections on the variants' paths: (label, K, N_out,
# bias), q carrying the model's q bias where it has one
VARIANT_PRUNED = (("StableLM-3B q", 2560, 2560, False), ("StableLM-3B gate", 2560, 6912, False),
                  ("StableLM-3B down", 6912, 2560, False), ("ChatGLM3-6B q", 4096, 4096, True),
                  ("ChatGLM3-6B gate", 4096, 13696, False),
                  ("ChatGLM3-6B down", 13696, 4096, False),
                  ("Qwen2.5-32B q", 5120, 5120, True), ("Qwen2.5-32B gate", 5120, 27648, False),
                  ("Qwen2.5-32B down", 27648, 5120, False), ("Granite-34B q", 6144, 6144, False),
                  ("Granite-34B gate", 6144, 24576, False),
                  ("Granite-34B down", 24576, 6144, False))


def phase_variant_kernels(torch, timer, rates, records):
    """2j: the kernels at the dense variants' shapes, each held against its
    plain version and timed beside its bound and its library yardstick; the
    cases are added to ``records[kernel]["variants"]``."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import paged_attention as kpa

    bw, bf16_peak = rates[0], rates[1]
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rng = np.random.default_rng(SEED + 11)
    dev = "cuda"
    i32 = dict(dtype=torch.int32, device=dev)
    keep = functools.partial(keep_case, records)

    print("phase 2j: paged_attention at the dense variants' heads (chunk Tq=256 at offset "
          "300, kv_len 500; decode B=4), NaN-poisoned pools")
    bs, mb = 16, 46
    rows = 4 * mb + 1
    perm = torch.randperm(4 * mb, generator=g, device=dev).to(torch.int32)
    tab1 = perm[:mb].reshape(1, mb).contiguous()
    qoff1, kvl1 = torch.tensor([300], **i32), torch.tensor([500], **i32)
    posd = torch.tensor([700, 513, 64, 0], **i32)
    kvld = posd + 1
    tabd = torch.full((4, mb), -1, **i32)
    for r in range(4):
        need = -(-int(kvld[r]) // bs)
        tabd[r, :need] = perm[r * mb:r * mb + need]
    for label, hq, hkv, hd in VARIANT_HEADS:
        kp = torch.randn(rows, bs, hkv, hd, generator=g, device=dev).bfloat16()
        vp = torch.randn(rows, bs, hkv, hd, generator=g, device=dev).bfloat16()
        for case, b, tq, tab, qo, kvl, causal in (("chunk", 1, 256, tab1, qoff1, kvl1, True),
                                                  ("decode", 4, 1, tabd, posd, kvld, False)):
            q = torch.randn(b, tq, hq, hd, generator=g, device=dev).bfloat16()
            kpn, vpn = poisoned_pools(torch, kp, vp, tab, kvl)
            route = attention_route(q, kp, tab)
            err = check_close(f"{label} {case} {route}",
                              kpa.paged_attention(q, kpn, vpn, tab, qo, kvl, causal=causal),
                              kpa.paged_attention_plain(q, kpn, vpn, tab, qo, kvl,
                                                        causal=causal), BF16_TOL)
            t = paged_attention_times(torch, timer, rates, q, kp, vp, tab, qo, kvl, causal)
            print(f"  {label} {case} {route}: kernel {t['ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
                  f"SDPA on the gathered view {t['library_ms']:.4f} ms; kernel/library "
                  f"{t['ms'] / t['library_ms']:.2f}")
            keep("paged_attention", f"{label} {case}", err, route=list(route), **t)

    print("phase 2j: paged_kv_scatter at head_dim 80 x 32 KV heads and at one KV head "
          "(bit-exact)")
    for label, hkv, hd in (("StableLM-3B hd=80 Hkv=32", 32, 80), ("Granite-34B Hkv=1", 1, 128)):
        kp = torch.randn(rows, bs, hkv, hd, generator=g, device=dev).bfloat16()
        vp = torch.randn(rows, bs, hkv, hd, generator=g, device=dev).bfloat16()
        pos1, cl1 = torch.tensor([37], **i32), torch.tensor([200], **i32)
        tab4 = perm.reshape(4, mb).clone()
        tab4[1] = -1
        tab4[2, 64 // bs] = -1
        posw = torch.tensor([700, 513, 64, 31], **i32)
        ones = torch.ones(4, **i32)
        for case, t, tab, pos, clen in (("chunk pos=37 len=200", 256, tab1, pos1, cl1),
                                        ("decode B=4 with -1 rows", 1, tab4, posw, ones)):
            b = tab.shape[0]
            kn = torch.randn(b, t, hkv, hd, generator=g, device=dev).bfloat16()
            vn = torch.randn(b, t, hkv, hd, generator=g, device=dev).bfloat16()
            k_a, v_a, k_b, v_b = kp.clone(), vp.clone(), kp.clone(), vp.clone()
            kpa.paged_kv_scatter(kn, vn, k_a, v_a, tab, pos, clen)
            kpa.paged_kv_scatter_plain(kn, vn, k_b, v_b, tab, pos, clen)
            torch.cuda.synchronize()
            if not (torch.equal(k_a, k_b) and torch.equal(v_a, v_b)):
                fail(f"paged_kv_scatter {label} {case}: kernel and plain version differ")
            r = scatter_times(torch, timer, bw, kn, vn, kp, vp, tab, pos, clen)
            print(f"  {label} {case} ({r.pop('rows')} rows of {hkv * hd * 2} bytes): "
                  f"bit-exact; kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms (bytes), "
                  f"plain {r['plain_ms']:.4f} ms, index_put_ K+V {r['library_ms']:.4f} ms")
            keep("paged_kv_scatter", f"{label} {case}", 0.0, bound_by="bytes", **r)

    print("phase 2j: flash_attention causal at head_dim 80 (G=1) and G=16 (B=4 T=512), and "
          "at RecurrentGemma-2B's heads (B=1 T=4096, 10/1 heads of 256, window 2048)")
    for label, b, t, hq, hkv, hd, window in FLASH_VARIANT_HEADS:
        q = torch.randn(b, t, hq, hd, generator=g, device=dev).bfloat16()
        k = torch.randn(b, t, hkv, hd, generator=g, device=dev).bfloat16()
        v = torch.randn(b, t, hkv, hd, generator=g, device=dev).bfloat16()
        route = kfa.flash_plan(q.dtype, hd, True)
        before = kfa.flash_attention.route_launches[route[0]]
        err = check_close(f"{label} {route}", kfa.flash_attention(q, k, v, window=window),
                          kfa.flash_attention_plain(q, k, v, window=window), BF16_TOL)
        if kfa.flash_attention.route_launches[route[0]] != before + 1:
            fail(f"flash_attention {label}: the call did not take its plan's route {route}")
        ms = timer.ms(lambda: kfa.flash_attention(q, k, v, window=window))
        plain_ms = timer.ms(lambda: kfa.flash_attention_plain(q, k, v, window=window), 5)
        if window:
            pos = torch.arange(t, device=dev)
            band = ((pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib_ms = timer.ms(lambda: sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True))
            pairs = int(band.sum())
        else:
            lib_ms = sdpa_ms(torch, timer, q, k, v, True)
            pairs = t * (t + 1) // 2
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        ops = 4 * hd * b * hq * pairs
        bound = max(nbytes / bw, ops / bf16_peak) * 1e3
        by = "bytes" if nbytes / bw >= ops / bf16_peak else "operations"
        print(f"  {label} {route}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}; {pairs} "
              f"visible pairs a head), plain {plain_ms:.4f} ms, SDPA (GQA, "
              f"{'band mask' if window else 'is_causal'}) {lib_ms:.4f} ms; kernel/library "
              f"{ms / lib_ms:.2f}, kernel/plain {ms / plain_ms:.3f}")
        keep("flash_attention", label, err, route=list(route), ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms, bound_ms=bound, bound_by=by)

    print("phase 2j: nm_prune_matmul at the variants' widths (T=256, 8:16)")
    for label, d, n_out, biased in VARIANT_PRUNED:
        time_nm_prune_matmul(torch, timer, rates, g, keep, label, d, n_out, 256, biased)

    print("phase 2j: osparse_matmul at Qwen2.5-32B q and k with their biases (bit-exact)")
    for proj, n_out in (("q", 5120), ("k", 1024)):
        for t in (256, 4):
            time_osparse_matmul(torch, timer, rates, g, rng, keep, f"Qwen2.5-32B {proj}",
                                5120, n_out, t, prune=t == 256 and proj == "q", biased=True)


def keep_case(records, kernel, case, err, **times):
    """A later slice's case of ``kernel`` under ``records[kernel]["variants"]``;
    the kernel's ``max_abs_err`` is the largest over all its cases."""
    records[kernel].setdefault("variants", {})[case] = times
    records[kernel]["max_abs_err"] = max(records[kernel]["max_abs_err"], err)


def time_nm_prune_matmul(torch, timer, rates, g, keep, label, d, n_out, t, biased,
                         n=8, m=16, scaled=True):
    """``nm_prune_matmul`` at ``n:m`` on seeded bf16 ``x (t, d)`` and
    ``w (d, n_out)`` with an Amber scale (none, the naive |x| score, unless
    ``scaled``) and a bias if ``biased``: held to its plain version within
    ``BF16_TOL`` on its wgmma route, timed beside its bound, its plain
    version and ``torch.matmul`` of the pruned x; kept under ``label`` (and
    its N:M and "no scale" where they are not 8:16 with a scale)."""
    from repro_torch.core import nm, scoring
    from repro_torch.kernels import nm_prune_matmul as knm

    bw, bf16_peak = rates[0], rates[1]
    dev = "cuda"
    w = (torch.randn(d, n_out, generator=g, device=dev) * d**-0.5).bfloat16()
    scale = torch.rand(d, generator=g, device=dev) + 0.5 if scaled else None
    bias = (torch.randn(n_out, generator=g, device=dev) * 0.1).bfloat16() if biased else None
    x = torch.randn(t, d, generator=g, device=dev).bfloat16()
    plan = knm.gemm_plan(w, t)
    route = f"wgmma, {plan} k slice{'s' if plan > 1 else ''}" if plan else "WMMA"
    err = check_close(f"{label} {d}x{n_out} T={t} {n}:{m} scale={scaled} bias={biased} "
                      f"({route})",
                      knm.nm_prune_matmul(x, w, scale, n, m, bias=bias),
                      knm.nm_prune_matmul_plain(x, w, scale, n, m, bias=bias), BF16_TOL)
    if not plan:
        fail(f"nm_prune_matmul {label}: expected the wgmma route")
    xp = nm.apply_nm(x, scoring.score_activations(x, scale), n, m)
    ms = timer.ms(lambda: knm.nm_prune_matmul(x, w, scale, n, m, bias=bias))
    plain_ms = timer.ms(lambda: knm.nm_prune_matmul_plain(x, w, scale, n, m, bias=bias), 3)
    lib_ms = timer.ms(lambda: torch.matmul(xp, w))
    nbytes = ((x.numel() + w.numel() + t * n_out + (n_out if biased else 0)) * 2
              + (d * 4 if scaled else 0))
    ops = 2 * int((xp != 0).sum()) * n_out
    bound = max(nbytes / bw, ops / bf16_peak) * 1e3
    by = "bytes" if nbytes / bw >= ops / bf16_peak else "operations"
    print(f"  {label} {d}x{n_out} T={t} {n}:{m}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
          f"({by}), plain {plain_ms:.4f} ms, torch.matmul(x_pruned) {lib_ms:.4f} ms; "
          f"kernel/library {ms / lib_ms:.2f}, bound/kernel {bound / ms:.3f}")
    if (n, m, scaled) != (8, 16, True):
        label = f"{label} {n}:{m}{'' if scaled else ' no scale'}"
    keep("nm_prune_matmul", label, err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
         bound_ms=bound, bound_by=by)


def time_osparse_matmul(torch, timer, rates, g, rng, keep, label, d, n_out, t, prune,
                        biased, per_token=False, n=8, m=16):
    """``osparse_matmul`` on a seeded W8A8 rewrite (``QuantConfig()``, a seeded
    calibration absmax) of ``w (d, n_out)`` and bf16 ``x (t, d)``: bit-exact
    against its plain version on its plan's route, timed beside its bound,
    its plain version and ``torch._int_mm`` with the dequant; kept under
    ``label T=t``."""
    from repro_torch import kernels
    from repro_torch.core import quant
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.kernels import w8a8_matmul as kw8

    bw, int8_peak = rates[0], rates[3]
    dev = "cuda"
    w = (torch.randn(d, n_out, generator=g, device=dev) * d**-0.5).bfloat16()
    ql = quant.make_quantized_linear(w, torch.from_numpy(calib_absmax(rng, d)).to(dev),
                                     quant.QuantConfig(per_token_act=per_token))
    del w
    amber = torch.rand(d, generator=g, device=dev) + 0.5
    bias = (torch.randn(n_out, generator=g, device=dev) * 0.1).bfloat16() if biased else None
    x = torch.randn(t, d, generator=g, device=dev).bfloat16()
    act_scale = None if per_token else ql.act_scale
    args = (x, ql.wq, ql.smooth, amber, ql.w_scale, n, m)
    kw = dict(act_scale=act_scale, bias=bias, prune=prune, per_token=per_token)
    plan = kw8.gemm_plan(t, d, n_out, x.dtype, per_token, prune, m)
    kernels.reset_launch_counts()
    got = kos.osparse_matmul(*args, **kw)
    want = kos.osparse_matmul_plain(*args, **kw)
    torch.cuda.synchronize()
    case = f"{label} T={t}"
    if not torch.equal(got, want):
        fail(f"osparse_matmul {case}: kernel and plain differ")
    expect_routes(f"osparse_matmul {case}", kos.osparse_matmul, plan.route)
    xq, xs = kos.osparse_quantize_plain(x, ql.smooth, amber, n, m, act_scale, prune, per_token)
    ms = timer.ms(lambda: kos.osparse_matmul(*args, **kw))
    plain_ms = timer.ms(lambda: kos.osparse_matmul_plain(*args, **kw), 5)
    lib_ms, lib_label = int_mm_ms(torch, timer, xq, ql.wq, xs, ql.w_scale)
    nbytes = (x.numel() * 2 + ql.wq.numel() + 2 * d * 4 + n_out * 4 + 4
              + (n_out * 2 if biased else 0) + t * n_out * 4)
    ops = 2 * int((xq != 0).sum()) * n_out
    bound = max(nbytes / bw, ops / int8_peak) * 1e3
    by = "bytes" if nbytes / bw >= ops / int8_peak else "operations"
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"  {case} ({d}x{n_out}, bias={biased}, prune={prune}, per_token={per_token}): "
          f"route {plan.route} split {plan.splits}, bit-exact; kernel {ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), plain {plain_ms:.4f} ms, {lib_label} {lib}")
    keep("osparse_matmul", case, 0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
         bound_ms=bound, bound_by=by, route=plan.route)


# 2k: the widths this slice's paths reach: LLaMA-3.1-8B's seven projections
# (four shapes) at the scan's 512 rows, as 9a's probes (8:16, an Amber scale)
# and 9c's Naive 2:4 run (no scale) launch them, and Qwen3-30B-A3B's
# attention under W8A8 (7e: q 2048 -> 4096, k/v 2048 -> 512, o 4096 -> 2048)
SCAN_PRUNED = (("q/o", 4096, 4096), ("k/v", 4096, 1024), ("gate/up", 4096, 14336),
               ("down", 14336, 4096))
MOE_QUANT = (("q", 2048, 4096), ("k/v", 2048, 512), ("o", 4096, 2048))


def phase_skipping_kernels(torch, timer, rates, records):
    """2k: ``nm_prune_matmul`` at LLaMA-3.1-8B's seven projections and 512
    rows, 8:16 with an Amber scale (9a) and 2:4 without (9c), and
    ``osparse_matmul`` at Qwen3-30B-A3B's attention (static: a pruned q
    chunk, the other chunks and every decode step dense; per-token: q's
    chunk), each held to its plain version and timed; the cases are added
    to ``records[kernel]["variants"]``."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    rng = np.random.default_rng(SEED + 12)
    keep = functools.partial(keep_case, records)

    rows = SCAN_BATCH * SCAN_TOKENS
    print(f"phase 2k: nm_prune_matmul at LLaMA-3.1-8B's projections (T={rows}): 8:16 with an "
          "Amber scale (9a's probes), 2:4 with none (9c's Naive run)")
    for label, d, n_out in SCAN_PRUNED:
        time_nm_prune_matmul(torch, timer, rates, g, keep, f"LLaMA-3.1-8B {label}", d, n_out,
                             rows, False)
        time_nm_prune_matmul(torch, timer, rates, g, keep, f"LLaMA-3.1-8B {label}", d, n_out,
                             rows, False, n=2, m=4, scaled=False)
    print("phase 2k: osparse_matmul at Qwen3-30B-A3B's attention (bit-exact)")
    for proj, d, n_out in MOE_QUANT:
        for t in (256, 4):
            time_osparse_matmul(torch, timer, rates, g, rng, keep, f"Qwen3-30B-A3B {proj}", d,
                                n_out, t, prune=t == 256 and proj == "q", biased=False)
    time_osparse_matmul(torch, timer, rates, g, rng, keep, "Qwen3-30B-A3B q per-token", 2048,
                        4096, 256, prune=True, biased=False, per_token=True)


def seed_biases(torch, params, seed: int) -> None:
    """Seeded nonzero LayerNorm biases, then projection biases (q/k/v in the
    dense family; every projection's in the encoder-decoder), in module
    order (the init leaves them zero, which would not exercise the bias
    adds)."""
    from repro_torch.layers.linear import Linear
    from repro_torch.models.common import LayerNorm

    g = torch.Generator(device="cuda").manual_seed(seed)
    biases = [mod.b for mod in params.modules() if isinstance(mod, LayerNorm)]
    biases += [mod.b for mod in params.modules() if isinstance(mod, Linear) and mod.b is not None]
    for b in biases:
        b.copy_((torch.randn(b.shape, generator=g, device="cuda") * 0.1).to(b.dtype))


def dense_model(torch, arch, n_layers=None):
    """``arch`` (depth optionally cut), random weights from ``SEED`` made on
    the card plus seeded LayerNorm and q/k/v biases (LLaMA-3.1-8B has
    none), the paper's policy with the kernels on and the Amber scales."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    model = build_model(cfg)
    params = model.init(SEED)
    seed_biases(torch, params, SEED + 100)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(use_kernels=True)
    precompute_scales(params, policy)
    return cfg, model, params, policy


# phase 8's models: (subphase, arch, depth on one card (None: all its
# layers), why it is cut)
VARIANT_SERVING = (
    ("8a", "qwen2_5_32b", 16, "depth 16 of its 64 layers, to make room for phases 14 and 15 "
                              "in the run's time: full width"),
    ("8c", "chatglm3_6b", 16, "depth 16 of its 28 layers, to make room for phase 15 in the "
                              "run's time: full width"),
    ("8d", "stablelm_3b", 16, "depth 16 of its 32 layers, to make room for phase 15 in the "
                              "run's time: full width"),
    ("8e", "granite_34b", 8, "its 88 layers take 88.0 GiB in bf16, which no 80 GB card "
                             "holds: full width, depth 8 (16 until phase 15 needed the time)"),
)


def serve_dense(torch, label, arch, n_layers=None, cut=None):
    """Phase 3 (LLaMA-3.1-8B) and 8a/8c-8e (the dense variants): ``arch``
    served with phase 3's stream and warm-up, every bucket captured once,
    the launches exact, the attention routes of its chunk and decode step
    printed, a chunk and a decode step profiled, the graphed tokens equal
    to the eager step programs'.  Returns (launches, model, params, policy,
    outputs, step counts and rates)."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models.common import dtype_of

    t0 = time.perf_counter()
    cfg, model, params, policy = dense_model(torch, arch, n_layers)
    torch.cuda.synchronize()
    n_w = sum(p.numel() for p in params.parameters())
    print(f"phase {label}: serve {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, norm {cfg.norm}, rope {cfg.rope_variant}, "
          f"qkv_bias {cfg.qkv_bias}, {cfg.dtype}), paper_policy(8, 16, "
          f"{cfg.qgate_skip_layers}) with the kernels" + (f"; {cut}" if cut else ""))
    print(f"  random weights: {n_w / 1e9:.3f}B parameters in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    fused, routed = prune_launches(cfg, policy)
    want = 3 * cfg.n_layers - 2 * len(cfg.qgate_skip_layers)
    if (fused, routed) != (want, 0):
        fail(f"phase {label}: the paper policy prunes {fused} projections per chunk, "
             f"expected {want} (q and gate outside the skip list, down in every layer)")
    scfg = serving_stream(torch, cfg.vocab_size)[4]
    mb = scfg.max_seq // scfg.block_size
    for case, b, tq in (("chunk", 1, scfg.chunk_size), ("decode", scfg.num_slots, 1)):
        plan = kpa.attention_plan(dtype_of(cfg), b, tq, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, scfg.block_size, mb, True)
        print(f"  attention_plan of a {case} step (B={b}, Tq={tq}, G="
              f"{cfg.n_heads // cfg.n_kv_heads}, hd {cfg.head_dim}): {plan}")
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, f"phase {label}")
    per_step = cfg.n_layers * (st["prefill_halves"] + st["decode_halves"])
    check_launches(f"phase {label}", launches, {
        "nm_prune_matmul": fused * st["sparse_chunks"], "paged_kv_scatter": per_step,
        "paged_attention": per_step, "nm_prune": 0, "nm_spmm": 0, "flash_attention": 0,
        "osparse_matmul": 0})
    if launches["paged_attention routes"] != {"wgmma": per_step, "rows": 0}:
        fail(f"phase {label}: paged_attention routes {launches['paged_attention routes']}, "
             f"expected all {per_step} launches of the bf16 stream on wgmma")
    print(f"  launches held: per sparse chunk nm_prune_matmul {fused}; paged_kv_scatter "
          f"and paged_attention {cfg.n_layers} per prefill or decode half, every "
          f"paged_attention launch on the wgmma route")
    profile_steps(torch, model, params, policy, eng)
    del eng
    check_graphed_tokens(torch, model, params, policy, f"phase {label}", outputs)
    return launches, model, params, policy, outputs, st


def phase_variants(torch):
    """Phase 8: the dense-family variants at full width on the card, after
    phase 7 freed its model; each subphase's seconds printed."""
    free_device(torch, "before phase 8 (phase 7 freed)")
    held = torch.cuda.memory_allocated() / 2**30
    if not held < 1.0:
        fail(f"phase 8: {held:.2f} GiB still allocated before Qwen2.5-32B, expected < 1 GiB")
    seconds = {}
    for label, arch, depth, cut in VARIANT_SERVING:
        t0 = time.perf_counter()
        _, model, params, policy, _, _ = serve_dense(torch, label, arch, depth, cut)
        if label == "8a":          # 8b: the same weights rewritten Outstanding-sparse
            seconds["8a"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            phase_serve_osparse(torch, model, params, policy, "8b")
            label = "8b"
        del model, params
        free_device(torch, f"after {label}")
        seconds[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch in ("qwen2_5_32b", "chatglm3_6b", "stablelm_3b", "granite_34b"):
        phase_parity(torch, quantized=False, arch=arch, label="phase 8f")
        phase_parity(torch, quantized=False, dtype="bfloat16", arch=arch, label="phase 8f")
    seconds["8f"] = time.perf_counter() - t0
    print(f"phase 8 seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")


# ------------------------------------------- the paper's layer-skipping tooling

# benchmarks/common.py:build_eval_model's outlier channels (its lines 36-47):
# 8 embedding channels at stride d_model / 8, scaled by 12, so a few
# channels carry 10-30x the magnitude through the residual stream (the
# paper's Fig. 2 statistics, which make the scoring matter)
OUTLIER_CHANNELS, OUTLIER_GAIN = 8, 12.0
SCAN_BATCH, SCAN_TOKENS = 2, 256
# benchmarks/coverage.py's published coverages of the paper's skip lists
PUBLISHED_COVERAGE = {"llama31_8b": 0.561, "qwen2_7b": 0.576, "qwen3_30b_a3b": 0.569}
# e of one probe, kernel path vs plain path, float32 (9a').  Both paths
# hand the probed projection the same input (dense upstream: cuBLAS and the
# plain attention on both; 9a' counts its N:M flips, expected 0), so the two
# e differ only by the float32 summation order of that one projection's GEMM
# (~1e-6 of its output) carried to the logits, over e (~1e-2): 1e-4
# relative covers it with a margin and lies far below the gaps between the
# layers the selection ranks.
SCAN_RTOL = 1e-4


def coverage_dims(cfg):
    """{module: (d_in, d_out)} (a copy of ``benchmarks/coverage.py:_dims``,
    its lines 13-24): the MoE FFN counts its top_k routed experts."""
    d = {
        "q_proj": (cfg.d_model, cfg.q_dim),
        "k_proj": (cfg.d_model, cfg.kv_dim),
        "v_proj": (cfg.d_model, cfg.kv_dim),
        "o_proj": (cfg.q_dim, cfg.d_model),
    }
    ff = cfg.moe_d_ff * cfg.top_k if cfg.n_experts else cfg.d_ff
    d["gate_proj"] = (cfg.d_model, ff)
    d["up_proj"] = (cfg.d_model, ff)
    d["down_proj"] = (ff, cfg.d_model)
    return d


def llama_eval_model(torch, n_layers=None, dtype=None):
    """LLaMA-3.1-8B (depth and dtype optionally cut), random weights from
    ``SEED`` made on the card, with the outlier channels injected into the
    embedding, and every projection's Amber scale (Robust-Norm), so that a
    probe of any of the seven prunes as Amber-P would."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model

    cfg = get_config("llama31_8b")
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, dtype=dtype or cfg.dtype)
    model = build_model(cfg)
    params = model.init(SEED)
    idx = torch.arange(OUTLIER_CHANNELS, device="cuda") * (cfg.d_model // OUTLIER_CHANNELS)
    params.embed.w[:, idx] *= OUTLIER_GAIN
    precompute_scales(params, paper_policy(8, 16).with_(skip_modules=()))
    return cfg, model, params


def scan_batch(cfg, step: int = 0):
    """``SCAN_BATCH`` x ``SCAN_TOKENS`` tokens of the port's synthetic stream."""
    from repro_torch.data import DataConfig, lm_batch

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SCAN_TOKENS,
                      global_batch=SCAN_BATCH, seed=SEED)
    return {"tokens": lm_batch(data, step)["tokens"][:, :SCAN_TOKENS]}


def run_scan(torch, model, params, batch, base, modules=None):
    """``sensitivity_scan`` over ``modules`` (the seven projections unless
    given) of every layer, with the launch counts set to 0 just before and
    read just after, and each forward's own launches.  Returns (e per probe,
    seconds, per-forward launches (the dense pass first), launches)."""
    from repro_torch import kernels
    from repro_torch.core.policy import ALL_PROJS
    from repro_torch.core.sensitivity import sensitivity_scan

    per_forward = []

    def forward(prm, b, policy, phase):
        before = kernels.launch_counts()
        y = model.forward(prm, b, policy=policy, phase=phase)
        after = kernels.launch_counts()
        per_forward.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        return y

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sens = sensitivity_scan(forward, params, batch, modules or ALL_PROJS, model.cfg.n_layers,
                            base)
    torch.cuda.synchronize()
    return sens, time.perf_counter() - t0, per_forward, kernels.launch_counts()


def derive_skips(cfg, sens, target: float = 0.55):
    """``select_qgate_skips`` under the config's linear FLOPs, and the
    coverage of ``paper_policy`` with the skips it selects."""
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.sensitivity import coverage, linear_flops, select_qgate_skips

    flops = linear_flops(coverage_dims(cfg))
    skips = select_qgate_skips(sens, flops, cfg.n_layers, paper_policy(8, 16), target)
    return skips, coverage(flops, paper_policy(8, 16, skips), cfg.n_layers)


def print_scan_rows(cfg, sens):
    """``benchmarks/sensitivity_scan.py``'s rows: each module's mean e, the
    ranking, and the check that down_proj ranks among the 3 least
    sensitive (printed, not checked: the weights are random)."""
    from repro_torch.core.policy import ALL_PROJS

    avg = {m: statistics.fmean(sens[(m, i)] for i in range(cfg.n_layers)) for m in ALL_PROJS}
    for m in ALL_PROJS:
        print(f"  sensitivity/{m},0.0,e_avg={avg[m]:.5f}")
    ranking = sorted(avg, key=avg.get, reverse=True)
    print(f"  sensitivity/ranking,0.0,{'>'.join(ranking)}")
    rank = sorted(avg, key=avg.get).index("down_proj")
    print(f"  sensitivity/check/down_proj_low,0.0,{'PASS' if rank <= 2 else 'FAIL'} (rank "
          f"{rank} of {len(avg)} from the least sensitive)")


def phase_scan(torch, model, params, cfg):
    """9a: the scan at full width on the kernels, each probe one
    ``nm_prune_matmul`` launch; the selected skips at a 0.55 coverage
    target; the coverage of each paper model's published list.  Then the
    q_proj and gate_proj probes, all that the selection reads, on the plain
    path, reported beside it.  Returns (9a's skips, its launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import PAPER_ARCH_IDS
    from repro_torch.core.policy import ALL_PROJS, paper_policy
    from repro_torch.core.sensitivity import coverage, linear_flops, targeted_policy

    batch = scan_batch(cfg)
    probes = len(ALL_PROJS) * cfg.n_layers
    print(f"phase 9a: sensitivity scan of {cfg.name} at full width ({cfg.n_layers} layers, "
          f"{cfg.dtype}, seed {SEED}, {OUTLIER_CHANNELS} embedding channels x {OUTLIER_GAIN}), "
          f"{SCAN_BATCH} x {SCAN_TOKENS} tokens of lm_batch, base paper_policy(8, 16) with the "
          f"kernels: {probes} probes and one dense pass")
    base = paper_policy(8, 16, use_kernels=True)
    sens, secs, per_forward, launches = run_scan(torch, model, params, batch, base)
    if per_forward[0] or any(f != {"nm_prune_matmul": 1} for f in per_forward[1:]) \
            or len(per_forward) != probes + 1:
        fail(f"phase 9a: launches per forward {per_forward[:3]}...: the dense pass must "
             "launch nothing and each probe one nm_prune_matmul")
    check_launches("phase 9a", launches, {
        "nm_prune_matmul": probes, "paged_kv_scatter": 0, "paged_attention": 0,
        "nm_prune": 0, "nm_spmm": 0, "flash_attention": 0, "osparse_matmul": 0})
    print(f"  launches held: nm_prune_matmul once per probe ({probes}, all seven projections "
          f"of every layer), nothing else; {secs:.2f} s, {secs / (probes + 1) * 1e3:.1f} ms "
          "per forward")
    profile_cases(torch, {"9a probe forward (q_proj of layer 0 pruned), eager": lambda: (
        model.forward(params, batch, policy=targeted_policy("q_proj", 0, cfg.n_layers, base),
                      phase="prefill"))})
    print_scan_rows(cfg, sens)
    skips, cov = derive_skips(cfg, sens)
    print(f"  select_qgate_skips at a 0.55 target: {skips} ({len(skips)} layers), coverage "
          f"{cov:.4f}; the config's published list {cfg.qgate_skip_layers}")
    if not cov >= 0.55:
        fail(f"phase 9a: the selected skips cover {cov} < 0.55 of the linear FLOPs")
    for arch in PAPER_ARCH_IDS:
        pcfg = get_config(arch)
        c = coverage(linear_flops(coverage_dims(pcfg)),
                     paper_policy(8, 16, pcfg.qgate_skip_layers), pcfg.n_layers)
        print(f"  coverage/{arch},0.0,ours={c:.3f};published={PUBLISHED_COVERAGE[arch]:.3f};"
              f"{'PASS' if abs(c - PUBLISHED_COVERAGE[arch]) < 0.02 and c > 0.55 else 'FAIL'}")

    # select_qgate_skips reads only the q_proj and gate_proj probes
    print("phase 9a': the full-width bf16 scan's q_proj and gate_proj probes on the plain "
          "path (reported beside 9a)")
    qgate = ("q_proj", "gate_proj")
    sens_p, secs_p, _, launches_p = run_scan(torch, model, params, batch,
                                             base.with_(use_kernels=False), qgate)
    if any(launches_p.values()):
        fail(f"phase 9a': the plain scan launched {launches_p}")
    skips_p, cov_p = derive_skips(cfg, sens_p)
    rel = [abs(sens[k] - sens_p[k]) / sens_p[k] for k in sens_p]
    qg = lambda e: sorted(range(cfg.n_layers), reverse=True,
                          key=lambda i: (e[("q_proj", i)] + e[("gate_proj", i)], i))
    forwards_p = len(qgate) * cfg.n_layers + 1
    print(f"  plain scan {secs_p:.2f} s ({secs_p / forwards_p * 1e3:.1f} ms per forward); "
          f"selected skips: kernels {skips} (coverage {cov:.4f}), plain {skips_p} (coverage "
          f"{cov_p:.4f}); e of the {len(rel)} probes, kernel vs plain: max relative "
          f"difference {max(rel):.3e}, median "
          f"{statistics.median(rel):.3e}; q+gate layer order, kernels {qg(sens)[:8]}, plain "
          f"{qg(sens_p)[:8]} (first 8)")
    return skips, launches


def phase_serve_derived(torch, model, params, skips, phase3):
    """9b: 9a's weights served with phase 3's stream under
    ``paper_policy(8, 16, <9a's skips>)`` after ``precompute_scales``: every
    request ends with its tokens, launches exact, graphed tokens equal to
    the eager step programs'.  Returns its launches."""
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales

    cfg = model.cfg
    policy = paper_policy(8, 16, skips).with_(use_kernels=True)
    precompute_scales(params, policy)
    fused, _ = prune_launches(cfg, policy)
    print(f"phase 9b: serve {cfg.name} (9a's weights) under paper_policy(8, 16, {skips}), "
          "9a's skips, with the kernels; phase 3's stream")
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, "phase 9b")
    per_step = cfg.n_layers * (st["prefill_halves"] + st["decode_halves"])
    check_launches("phase 9b", launches, {
        "nm_prune_matmul": fused * st["sparse_chunks"], "paged_kv_scatter": per_step,
        "paged_attention": per_step, "nm_prune": 0, "nm_spmm": 0, "flash_attention": 0,
        "osparse_matmul": 0})
    print(f"  launches held: nm_prune_matmul {fused} a sparse chunk; prefill "
          f"{st['prefill_tok_s']:.1f} / decode {st['decode_tok_s']:.1f} tok/s against phase "
          f"3's {phase3['prefill_tok_s']:.1f} / {phase3['decode_tok_s']:.1f} (the published "
          f"skips: {3 * cfg.n_layers - 2 * len(cfg.qgate_skip_layers)} a chunk)")
    del eng
    check_graphed_tokens(torch, model, params, policy, "phase 9b", outputs)
    return launches


def phase_weight_sparsity(torch, model, params):
    """9c: Appendix A at full width.  ``act_norm`` (‖X_:,j‖₂) and
    ``hessian_diag`` (Σ X²) of every projection's input from one
    ``calibration_stream`` batch; ``magnitude_nm``, ``wanda_nm`` and
    ``sparsegpt_nm`` at 2:4 on every projection of a copy of the weights,
    each mask a valid 2:4 pattern along d_in for every output column; the
    output perturbation of each weight-pruned model and of Naïve 2:4
    activation sparsity (``naive_policy(2, 4)`` on the kernels) against the
    dense model on 9a's batch.  Returns the launches of the activation
    run."""
    from repro_torch import kernels
    from repro_torch.core import weight_sparsity as ws
    from repro_torch.core.policy import ALL_PROJS, DENSE, MLP_PROJS, naive_policy
    from repro_torch.core.sensitivity import relative_perturbation
    from repro_torch.data import DataConfig, calibration_stream

    cfg = model.cfg
    n, m = 2, 4
    print(f"phase 9c: weight vs activation N:M sparsity at {n}:{m}, {cfg.name} at full width "
          "(9a's weights)")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SCAN_TOKENS, global_batch=SCAN_BATCH,
                      seed=SEED)
    calib = next(calibration_stream(data, 1))
    sumsq = {}

    def hook(x, p, module, policy, phase, layer):
        xf = x.reshape(-1, x.shape[-1]).float()
        sumsq[(layer, module)] = (xf * xf).sum(0)

    with spy_projections(hook):
        model.forward(params, {"tokens": calib["tokens"][:, :SCAN_TOKENS]}, policy=DENSE,
                      phase="prefill")
    if len(sumsq) != len(ALL_PROJS) * cfg.n_layers:
        fail(f"phase 9c: {len(sumsq)} projection inputs recorded")
    batch = scan_batch(cfg)
    y0 = model.forward(params, batch, policy=DENSE, phase="prefill")
    kernels.reset_launch_counts()
    y = model.forward(params, batch, policy=naive_policy(n, m).with_(use_kernels=True),
                      phase="prefill")
    launches = kernels.launch_counts()
    check_launches("phase 9c", launches, {
        "nm_prune_matmul": len(ALL_PROJS) * cfg.n_layers, "paged_kv_scatter": 0,
        "paged_attention": 0, "nm_prune": 0, "nm_spmm": 0, "flash_attention": 0,
        "osparse_matmul": 0})
    pert = {"activation_naive": float(relative_perturbation(y0, y))}
    del y
    pruned = copy.deepcopy(params)
    methods = {"magnitude": lambda w, h: ws.magnitude_nm(w, n, m),
               "wanda": lambda w, h: ws.wanda_nm(w, h.sqrt(), n, m),
               "sparsegpt": lambda w, h: ws.sparsegpt_nm(w, h, n, m)}
    for method, prune in methods.items():
        t0 = time.perf_counter()
        short = groups = 0
        for i, (src, dst) in enumerate(zip(params.blocks, pruned.blocks)):
            for name in ALL_PROJS:
                lin = getattr(src.mlp if name in MLP_PROJS else src, name)
                wp = prune(lin.w, sumsq[(i, name)])
                kept = (wp != 0).t().reshape(wp.shape[1], -1, m).sum(-1)
                if not bool((kept <= n).all()):
                    fail(f"phase 9c: {method} layer {i} {name}: a group of {m} along d_in "
                         f"keeps more than {n}")
                short += int((kept < n).sum())
                groups += kept.numel()
                getattr(dst.mlp if name in MLP_PROJS else dst, name).w.copy_(wp)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        pert[method] = float(relative_perturbation(y0, model.forward(
            pruned, batch, policy=DENSE, phase="prefill")))
        print(f"  {method}_nm: {len(ALL_PROJS) * cfg.n_layers} weights pruned in {secs:.2f} s;"
              f" every one of {groups} groups of {m} along d_in keeps at most {n} ({short} "
              f"keep fewer: an exact zero)")
    del pruned
    print(f"  appendix_a/activation_naive_{n}:{m},0.0,pert={pert['activation_naive']:.4f}")
    for method in methods:
        print(f"  appendix_a/weight_{method}_{n}:{m},0.0,pert={pert[method]:.4f}")
    ok = all(pert["activation_naive"] < pert[mt] for mt in methods)
    print(f"  appendix_a/check/activation_dominates,0.0,{'PASS' if ok else 'FAIL'} (printed, "
          "not checked: the weights are random)")
    return launches


def phase_scan_parity(torch):
    """9a': the scan at full width and depth 2 in float32 on the kernel
    path and on the plain path: each probe's e within ``SCAN_RTOL``, the
    same skips at coverage targets 0.55 and 0.3 (at depth 2 one skip takes
    the coverage from 0.615 to 0.308), and each probe's N:M flips between
    the paths (:func:`nm_flips`)."""
    from repro_torch.core.policy import ALL_PROJS, paper_policy
    from repro_torch.core.sensitivity import targeted_policy

    cfg, model, params = llama_eval_model(torch, n_layers=2, dtype="float32")
    print(f"phase 9a': {cfg.name} scan, kernel path vs plain path, full width, depth 2, "
          "float32")
    batch = scan_batch(cfg)
    base = paper_policy(8, 16)
    sens, launches = {}, {}
    for uk in (True, False):
        sens[uk], _, _, launches[uk] = run_scan(torch, model, params, batch,
                                                base.with_(use_kernels=uk))
    probes = len(ALL_PROJS) * cfg.n_layers
    if launches[True]["nm_prune_matmul"] != probes or any(launches[False].values()):
        fail(f"phase 9a': launches {launches}: the kernel scan must launch nm_prune_matmul "
             f"{probes} times, the plain scan nothing")
    for key in sorted(sens[False], key=lambda k: (k[1], k[0])):
        print(f"  e {key[0]} layer {key[1]}: kernels {sens[True][key]:.6e}, plain "
              f"{sens[False][key]:.6e}")
    worst = max(abs(sens[True][k] - sens[False][k]) / sens[False][k] for k in sens[False])
    print(f"  largest relative difference of e {worst:.3e} (limit {SCAN_RTOL:.0e})")
    if not worst <= SCAN_RTOL:
        fail(f"phase 9a': e kernel vs plain differ by {worst} relative > {SCAN_RTOL}")
    for target in (0.55, 0.3):
        got, cov = derive_skips(cfg, sens[True], target)
        want, _ = derive_skips(cfg, sens[False], target)
        print(f"  select_qgate_skips at {target}: kernels {got}, plain {want} (coverage "
              f"{cov:.4f})")
        if got != want:
            fail(f"phase 9a': the kernel and plain scans select {got} and {want}")
    table = {}
    for module in ALL_PROJS:
        for layer in range(cfg.n_layers):
            def probe(use_kernels, module=module, layer=layer):
                pol = targeted_policy(module, layer, cfg.n_layers,
                                      base.with_(use_kernels=use_kernels))
                model.forward(params, batch, policy=pol, phase="prefill")
            table.update(nm_flips(torch, probe))
    print_flips("9a'", table)
    del params, model


def phase_skipping(torch, phase3):
    """Phase 9: the paper's layer-skipping tooling at full width, after
    phase 8 freed its models.  Returns the launches of 9a, 9b and 9c's
    Naive run, each counted from 0, by run."""
    free_device(torch, "before phase 9 (phase 8 freed)")
    seconds = {}
    t0 = time.perf_counter()
    cfg, model, params = llama_eval_model(torch)
    torch.cuda.synchronize()
    print(f"phase 9: {cfg.name} random weights from seed {SEED} with outlier channels in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "held")
    skips, launches = phase_scan(torch, model, params, cfg)
    seconds["9a (both scans)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = phase_serve_derived(torch, model, params, skips, phase3)
    free_device(torch, "after 9b")
    seconds["9b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    act = phase_weight_sparsity(torch, model, params)
    del model, params
    free_device(torch, "after 9c")
    seconds["9c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_scan_parity(torch)
    free_device(torch, "after 9a'")
    seconds["9a' depth 2"] = time.perf_counter() - t0
    print(f"phase 9 seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    return {"9a": launches, "9b": served, "9c": act}


# ------------------------------------------------- phase 2l: sliding windows

MIXTRAL_WINDOW = 4096


def phase_window_kernels(torch, timer, rates, records):
    """2l: the sliding-window band.  ``paged_attention`` with ``window``
    over NaN-poisoned pools, against its plain version: the shapes of
    ``tests/test_kernels.py``'s window case (head_dim 16: the CUDA-core rows
    kernel) in bf16 and float32, and Mixtral-8x7B's heads (32 / 8, G = 4,
    head_dim 128, window 4096, blocks of 16 over a 6144-row table) on both
    routes: a 256-row chunk at q_offset 4800 and a B = 4 decode around
    position 5000 (bf16 on the wgmma kernel, float32 on the rows kernel);
    the Mixtral cases timed beside their bounds and SDPA on the gathered
    view with the same band.  ``flash_attention`` at B = 1, T = 6144, window
    4096 with Mixtral's heads.  Then ``nm_prune_matmul`` at Mixtral's q
    (4096 x 4096, T = 256) and ``nm_prune`` at its routed experts' gate
    input (256 x 4096) and down input (512 x 14336: top-2), bit-exact."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import nm_prune as knp
    from repro_torch.kernels import paged_attention as kpa

    bw, bf16_peak = rates[0], rates[1]
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    dev = "cuda"
    i32 = dict(dtype=torch.int32, device=dev)
    keep = functools.partial(keep_case, records)
    w = MIXTRAL_WINDOW

    print("phase 2l: paged_attention's window band, tests/test_kernels.py's case (q 3 x 8 x "
          "4 x 16, blocks of 8, window 6), NaN-poisoned")
    nb, bs_t = 10, 8
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(7)) + 1
    tab = torch.full((3, 6), -1, dtype=torch.int32)
    tab[0, :3], tab[1, :5], tab[2, :2] = perm[:3], perm[3:8], perm[7:9]
    tab = tab.to(dev)
    qo, kvl = torch.tensor([13, 30, 5], **i32), torch.tensor([21, 38, 13], **i32)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        kp = torch.randn(nb, bs_t, 2, 16, generator=g, device=dev).to(dtype)
        vp = torch.randn(nb, bs_t, 2, 16, generator=g, device=dev).to(dtype)
        q = torch.randn(3, 8, 4, 16, generator=g, device=dev).to(dtype)
        kpn, vpn = poisoned_pools(torch, kp, vp, tab, kvl)
        route = kpa.attention_plan(dtype, 3, 8, 4, 2, 16, bs_t, 6, True, window=6)
        err = check_close(f"window 6 {dtype} {route}",
                          kpa.paged_attention(q, kpn, vpn, tab, qo, kvl, causal=True, window=6),
                          kpa.paged_attention_plain(q, kpn, vpn, tab, qo, kvl, causal=True,
                                                    window=6), tol)
        records["paged_attention"]["max_abs_err"] = max(
            records["paged_attention"]["max_abs_err"], err)

    print(f"phase 2l: paged_attention, Mixtral-8x7B heads (32 / 8, hd 128), window {w}, "
          "6144-row tables of 16-row blocks, NaN-poisoned")
    bs, mb = 16, 6144 // 16
    rows = 4 * mb + 1
    perm = torch.randperm(4 * mb, generator=g, device=dev).to(torch.int32)
    kp = torch.randn(rows, bs, 8, 128, generator=g, device=dev).bfloat16()
    vp = torch.randn(rows, bs, 8, 128, generator=g, device=dev).bfloat16()
    tabc = perm[:mb].reshape(1, mb).contiguous()
    posd = torch.tensor([5000, 4990, 4500, 100], **i32)
    tabd = torch.full((4, mb), -1, **i32)
    for r in range(4):
        need = -(-(int(posd[r]) + 1) // bs)
        tabd[r, :need] = perm[r * mb:r * mb + need]
    cases = (("chunk Tq=256 q_offset=4800", 1, 256, tabc, torch.tensor([4800], **i32),
              torch.tensor([5056], **i32), True),
             ("decode B=4 pos 5000/4990/4500/100", 4, 1, tabd, posd, posd + 1, False))
    for case, b, tq, tab, qo, kvl, causal in cases:
        kpn, vpn = poisoned_pools(torch, kp, vp, tab, kvl)
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            q = torch.randn(b, tq, 32, 128, generator=g, device=dev).to(dtype)
            kq, vq = kpn.to(dtype), vpn.to(dtype)
            route = kpa.attention_plan(dtype, b, tq, 32, 8, 128, bs, mb, True, window=w)
            want_route = "wgmma" if dtype == torch.bfloat16 else "rows"
            if route[0] != want_route:
                fail(f"paged_attention Mixtral {case} {dtype}: route {route}, expected "
                     f"{want_route}")
            err = check_close(f"Mixtral {case} {dtype} {route}",
                              kpa.paged_attention(q, kq, vq, tab, qo, kvl, causal=causal,
                                                  window=w),
                              kpa.paged_attention_plain(q, kq, vq, tab, qo, kvl, causal=causal,
                                                        window=w), tol)
            if dtype == torch.float32:
                keep("paged_attention", f"Mixtral window {case} float32 (rows)", err,
                     route=list(route))
                continue
            t = paged_attention_times(torch, timer, rates, q, kp, vp, tab, qo, kvl, causal,
                                      window=w)
            print(f"  Mixtral {case} {route}: kernel {t['ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
                  f"SDPA on the gathered view (band mask) {t['library_ms']:.4f} ms; "
                  f"kernel/library {t['ms'] / t['library_ms']:.2f}")
            keep("paged_attention", f"Mixtral window {case}", err, route=list(route), **t)
        del kpn, vpn

    print(f"phase 2l: flash_attention B=1 T=6144 causal window {w}, Mixtral heads (32 / 8)")
    t_len, hq, hkv, hd = 6144, 32, 8, 128
    q = torch.randn(1, t_len, hq, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(1, t_len, hkv, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(1, t_len, hkv, hd, generator=g, device=dev).bfloat16()
    err = check_close(f"T={t_len} window {w}", kfa.flash_attention(q, k, v, window=w),
                      kfa.flash_attention_plain(q, k, v, window=w), BF16_TOL)
    ms = timer.ms(lambda: kfa.flash_attention(q, k, v, window=w))
    plain_ms = timer.ms(lambda: kfa.flash_attention_plain(q, k, v, window=w), 3)
    qpos = torch.arange(t_len, device=dev)
    band = (qpos[None, :] <= qpos[:, None]) & (qpos[None, :] > qpos[:, None] - w)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_ms = timer.ms(lambda: sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True))
    pairs = hq * int(band.sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    ops = 4 * hd * pairs
    bound = max(nbytes / bw, ops / bf16_peak) * 1e3
    by = "bytes" if nbytes / bw >= ops / bf16_peak else "operations"
    print(f"  T={t_len} window {w}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), plain "
          f"{plain_ms:.4f} ms, SDPA (band mask, GQA) {lib_ms:.4f} ms; kernel/library "
          f"{ms / lib_ms:.2f}, bound/kernel {bound / ms:.3f}")
    keep("flash_attention", f"Mixtral T={t_len} window {w}", err, ms=ms, plain_ms=plain_ms,
         library_ms=lib_ms, bound_ms=bound, bound_by=by)
    del q, k, v, qt, kt, vt, band

    print("phase 2l: nm_prune_matmul at Mixtral's q (T=256, 8:16) and nm_prune at its "
          "routed experts' inputs (no scale, bit-exact)")
    time_nm_prune_matmul(torch, timer, rates, g, keep, "Mixtral-8x7B q", 4096, 4096, 256,
                         False)
    n, m = 8, 16
    for name, t, d in (("Mixtral expert gate input", 256, 4096),
                       ("Mixtral expert down input", 512, 14336)):
        x = torch.randn(t, d, generator=g, device=dev).bfloat16()
        got, want = knp.nm_prune(x, None, n, m), knp.nm_prune_plain(x, None, n, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"nm_prune {name}: kernel and plain version differ")
        ms = timer.ms(lambda: knp.nm_prune(x, None, n, m))
        plain_ms = timer.ms(lambda: knp.nm_prune_plain(x, None, n, m), 5)
        copy_ms = timer.ms(x.clone)
        bound = 2 * x.numel() * 2 / bw * 1e3
        print(f"  {name} T={t} D={d}: bit-exact; kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes), plain {plain_ms:.4f} ms, x.clone() {copy_ms:.4f} ms")
        keep("nm_prune", name, 0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
             bound_ms=bound, bound_by="bytes")


# --------------------------------------------- phase 10: Mixtral and the slab

MIXTRAL_DEPTH = 8            # of 32, cut from 16 to make room for phase 15 (full width)
# phase 10's sizes: the slab's and the one-shot prompt's max_seq, the long
# requests' lengths (past the 4096-row ring), the profiled chunk's offset and
# decode positions (the ring wrapped), and 10c's prompt lengths
MIXTRAL_SEQ = 6144
MIXTRAL_LONG = (4500, 5000)
MIXTRAL_PROFILE = (4800, (5000, 4990, 4500, 100))
MIXTRAL_PARITY_LENS = (4600, 300)


def mixtral(torch, n_layers=MIXTRAL_DEPTH, seed=SEED, dtype=None):
    """Mixtral-8x7B at full width (depth ``n_layers`` and dtype optionally
    changed), random weights from ``seed`` made on the card, the paper's
    policy with the kernels on and the Amber scales (q_proj's: the routed
    experts get none)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model

    cfg = get_config("mixtral_8x7b")
    cfg = dataclasses.replace(cfg, n_layers=n_layers, dtype=dtype or cfg.dtype)
    model = build_model(cfg)
    params = model.init(seed)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(use_kernels=True)
    precompute_scales(params, policy)
    return cfg, model, params, policy


def mixtral_stream(vocab, **serving):
    """Phase 3's 8 seeded requests plus two of 4500-5000 tokens, so that
    their rings wrap, 32 new tokens each; 4 slots, chunk 256, max_seq 6144
    (:func:`serving_stream`'s form)."""
    from repro_torch.serve import ContinuousConfig

    rng = np.random.default_rng(SEED)
    prompts = (make_requests(rng, 8, 64, 700, vocab)
               + make_requests(rng, 2, *MIXTRAL_LONG, vocab))
    arrivals = [0, 0, 1, 2, 4, 6, 9, 12, 3, 14]
    return rng, prompts, arrivals, 32, ContinuousConfig(
        num_slots=4, chunk_size=256, max_seq=MIXTRAL_SEQ, **serving)


def phase_mixtral_serve(torch, rates):
    """10a: Mixtral-8x7B at full width, depth ``MIXTRAL_DEPTH``, continuous on the dense
    slab (its rings are never paged), launches exact, graphed tokens equal
    to the eager programs', the replayed chunk (at 4800, the ring wrapped)
    and decode step profiled with the grouped product beside the bound of
    the step's own routing.  Returns (launches, step counts and rates,
    model, params, policy)."""
    t0 = time.perf_counter()
    cfg, model, params, policy = mixtral(torch)
    torch.cuda.synchronize()
    n_w = sum(p.numel() for p in params.parameters())
    full = dataclasses.replace(cfg, n_layers=32).n_params()
    print(f"phase 10a: serve {cfg.name} at full width, depth {cfg.n_layers} of 32 (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts "
          f"top-{cfg.top_k}, moe_d_ff {cfg.moe_d_ff}, window {cfg.window}, {cfg.dtype}) on the "
          f"dense slab, paper_policy(8, 16, {cfg.qgate_skip_layers}) with the kernels")
    print(f"  random weights: {n_w / 1e9:.3f}B parameters (n_params {cfg.n_params() / 1e9:.3f}B;"
          f" all 32 layers {full / 1e9:.3f}B = {full * 2 / 2**30:.1f} GiB in bf16, more than "
          f"one 80 GB card holds) in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    fused, routed = prune_launches(cfg, policy)
    if (fused, routed) != (cfg.n_layers, 2 * cfg.n_layers):
        fail(f"phase 10a: the paper policy prunes {fused} projections and {routed} expert "
             f"inputs per chunk, expected {cfg.n_layers} (q) and {2 * cfg.n_layers}")
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, "phase 10a",
                                                stream_fn=mixtral_stream)
    ex = eng.replica.exec
    slab = sum(leaf.numel() * leaf.element_size() for layer in ex.cache["layers"]
               for leaf in layer.values())
    print(f"  the slab: {tuple(ex.cache['layers'][0]['k'].shape)} K and V a layer, "
          f"{slab / 2**30:.3f} GiB; metrics paged {eng.replica.metrics['paged']}")
    if ex.paged or "block_table" in ex.cache or eng.replica.metrics["paged"] != {
            "enabled": False}:
        fail("phase 10a: Mixtral was served on the paged pool")
    check_launches("phase 10a", launches, {
        "nm_prune_matmul": fused * st["sparse_chunks"], "nm_prune": routed * st["sparse_chunks"],
        "paged_kv_scatter": 0, "paged_attention": 0, "nm_spmm": 0, "flash_attention": 0,
        "osparse_matmul": 0})
    print(f"  launches held: per sparse chunk nm_prune_matmul {fused} (q_proj), nm_prune "
          f"{routed} (expert gate and down inputs); the ring's attention and writes are plain "
          "torch (no paged kernel)")
    chunk_pos, decode_pos = MIXTRAL_PROFILE
    print(f"phase 10a: profile one prefill chunk (at {chunk_pos}: the ring wrapped) and one "
          "decode step of Mixtral-8x7B")
    results, eager = profile_steps(torch, model, params, policy, eng, max_seq=MIXTRAL_SEQ,
                                   chunk_pos=chunk_pos, decode_pos=decode_pos)
    grouped_report(torch, cfg, results, eager, rates)
    del eng, ex
    check_graphed_tokens(torch, model, params, policy, "phase 10a", outputs,
                         stream_fn=mixtral_stream)
    return launches, st, model, params, policy


def phase_mixtral_oneshot(torch, model, params, policy):
    """10b: ``ServingEngine.generate`` of Mixtral-8x7B (10a's weights) with
    ``attn_impl="flash"`` at B = 1, T = 6144 (past the window: the flash
    kernel's band) and 32 new tokens on the ring layout: the prefill and
    decode graphs captured once, launches exact (per prefill 16
    ``flash_attention``, 16 ``nm_prune_matmul``, 32 ``nm_prune``; no paged
    kernel), tokens equal to the same run without graphs.  Returns the
    launches of the timed run."""
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig, ServingEngine

    cfg = dataclasses.replace(model.cfg, attn_impl="flash")
    mflash = build_model(cfg)
    t_len, new = MIXTRAL_SEQ, 32
    prompts = torch.from_numpy(np.random.default_rng(SEED + 10).integers(
        0, cfg.vocab_size, size=(1, t_len))).cuda()
    print(f"phase 10b: one-shot {cfg.name} depth {cfg.n_layers}, attn_impl=flash, B=1, "
          f"T={t_len}, {new} new tokens, ring of {min(cfg.window, t_len + new)} rows")
    eng = ServingEngine(mflash, policy, ServeConfig(max_seq=t_len + new))
    eng.generate(params, {"tokens": prompts}, max_new_tokens=2)          # capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    toks, pf_s, dec_s = timed_generate(torch, eng, params, prompts, new)
    launches = kernels.launch_counts()
    # timed_generate runs two generates: 1 + new tokens, two prefills
    check_launches("phase 10b", launches, {
        "flash_attention": 2 * cfg.n_layers, "nm_prune_matmul": 2 * cfg.n_layers,
        "nm_prune": 2 * 2 * cfg.n_layers, "paged_kv_scatter": 0, "paged_attention": 0,
        "nm_spmm": 0, "osparse_matmul": 0})
    traces = eng.trace_counts
    if any(n != 1 for n in traces.values()):
        fail(f"phase 10b: trace_counts {traces}: each program must be captured once")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("phase 10b: a token outside the vocabulary")
    cache = eng._state[1]["cache"]
    if "block_table" in cache or cache["layers"][0]["k"].shape[1] != cfg.window:
        fail("phase 10b: the one-shot cache is not the ring layout")
    print(f"  trace_counts {traces}; launches {launches}")
    print(f"  prefill {t_len} tokens in {pf_s:.3f} s = {t_len / pf_s:.1f} tok/s; decode "
          f"{new - 1} steps in {dec_s:.3f} s = {(new - 1) / dec_s:.1f} tok/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    eager = ServingEngine(mflash, policy, ServeConfig(max_seq=t_len + new))
    eager._graphs.run = lambda name, fn, params, shape=None: fn()
    want = eager.generate(params, {"tokens": prompts}, max_new_tokens=new)["tokens"]
    if not torch.equal(toks, want):
        fail("phase 10b: graphed tokens differ from the eager run's")
    print(f"  tokens {toks[0, :8].tolist()}...: identical to the same generate without graphs")
    del eng, eager
    return launches


def greedy_ring(torch, mdl, prm, pol, prompt, new, max_seq):
    """One prompt through 256-token chunks under ``pol`` into a fresh cache
    (the ring), then ``new`` greedy decode steps under DENSE (with ``pol``'s
    kernel switch), eagerly: (tokens, last-chunk logits)."""
    from repro_torch.core.policy import DENSE

    cache = mdl.init_cache(1, max_seq)
    for s in range(0, len(prompt), 256):
        chunk = torch.from_numpy(prompt[s:s + 256][None, :]).cuda()
        lg, cache = mdl.prefill_chunk(prm, {"tokens": chunk}, cache, policy=pol)
    first, out = lg, []
    dense = DENSE.with_(use_kernels=pol.use_kernels)
    for _ in range(new):
        tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        out.append(int(tok[0, 0]))
        lg, cache = mdl.decode_step(prm, tok, cache, policy=dense)
    return out, first


def phase_mixtral_parity(torch):
    """10c: Mixtral-8x7B at full width, depth 2: the kernel path against the
    plain path (``nm_prune_matmul``'s and ``nm_prune``'s plain versions, the
    per-expert loop; eager, as 7c), on a 4600-token prompt (past the window:
    its ring wraps) and a 300-token one, in 256-token chunks and 8 greedy
    decode steps.  float32: identical greedy tokens; the last-chunk logits'
    distance is printed, not checked (the kernel GEMM's summation order
    flips N:M selections, as in phase 4, and here also near-tied routes of
    the next layer's router, which moves a logit by more than phase 4's 2%:
    0.107 of 4.4 on the 300-token prompt); bf16: each prompt's last-chunk
    logits within BF16_E2E_FACTOR times the plain path's own bf16 effect
    (:func:`check_bf16_logits`), greedy agreement printed."""
    from repro_torch.models import build_model

    rng = np.random.default_rng(SEED + 12)
    for dtype in ("float32", "bfloat16"):
        print(f"phase 10c: Mixtral-8x7B kernel path vs plain path, full width, depth 2, {dtype}")
        cfg, model, params, policy = mixtral(torch, n_layers=2, seed=SEED + 1, dtype=dtype)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in MIXTRAL_PARITY_LENS]
        plain = policy.with_(use_kernels=False)

        def run(mdl, prm, pol):
            toks, logits = [], []
            for p in prompts:
                t, lg = greedy_ring(torch, mdl, prm, pol, p, 8, MIXTRAL_SEQ)
                toks.append(t)
                logits.append(lg)
            return toks, logits

        got, got_logits = run(model, params, policy)
        want, want_logits = run(model, params, plain)
        print(f"  prompts {[len(p) for p in prompts]}: kernel path {got}")
        if dtype == "float32":
            for i, (a, b) in enumerate(zip(got_logits, want_logits)):
                print(f"  prompt {i} last-chunk logits (reported, not checked): max_abs_err "
                      f"{float((a - b).abs().max()):.3e}, largest |logit| "
                      f"{float(b.abs().max()):.3e}")
            if got != want:
                fail(f"phase 10c: greedy tokens differ: kernel {got} vs plain {want}")
            print("  greedy tokens identical")
        else:
            model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
            _, ref_logits = run(model32, copy.deepcopy(params).float(), plain)
            check_bf16_logits(got_logits, want_logits, ref_logits)
            margins = []
            for b in want_logits:
                top2 = torch.topk(b[0].float(), 2).values
                margins.append(float(top2[0] - top2[1]))
            report_bf16_agreement(got, want, margins)
            del model32
        del model, params
        torch.cuda.empty_cache()


def phase_slab_cli(torch):
    """10d: LLaMA-3.1-8B on the dense slab through the CLI at full width
    (``--no-paged`` with phase 6a's stream, without the shared prefix, which
    the slab does not reuse): rc 0, ``# paged KV: disabled``, every program
    captured once, one program per work iteration, all 16 requests done,
    launches exact (``nm_prune_matmul`` per sparse chunk; no paged kernel).
    Then LLaMA-3.1-8B at depth 2 in float32: the slab's greedy tokens equal
    the paged pool's on phase 4's requests."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousConfig, Engine, EngineConfig

    flags = list(TRACE_FLAGS)
    i = flags.index("--shared-prefix")
    del flags[i:i + 2]
    out, launches, met = run_cli(torch, ["--arch", "llama31_8b", "--no-paged"] + flags,
                                 "phase 10d")
    lines = out.splitlines()
    for line in lines:
        if line.startswith(("# throughput", "# latency", "# traces", "# dispatches",
                            "# terminal", "# paged", "# prefix")):
            print(f"  {line}")
    traces = next(line for line in lines if line.startswith("# traces:"))
    if any(n != "1" for _, n in re.findall(r"(\w+)=(\d+)", traces.split("(")[0])):
        fail(f"phase 10d: {traces}: every program must be captured once")
    n_req = flags[flags.index("--num-requests") + 1]
    if ("# paged KV: disabled (dense per-slot slab)" not in out
            or "1.00 per work iteration" not in out or f"done={n_req} " not in out
            or met.paged.enabled):
        fail("phase 10d: the slab's report is wrong")
    _, _, st = step_counts(met.buckets, fused=True)
    cfg = get_config("llama31_8b")
    fused, _ = prune_launches(cfg, paper_policy(8, 16, cfg.qgate_skip_layers))
    check_launches("phase 10d", launches, {
        "nm_prune_matmul": fused * st["sparse_chunks"], "paged_kv_scatter": 0,
        "paged_attention": 0, "nm_spmm": 0, "flash_attention": 0, "osparse_matmul": 0})

    print("phase 10d: LLaMA-3.1-8B depth 2 float32, the slab against the paged pool")
    cfg = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(SEED + 1)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(use_kernels=True)
    rng = np.random.default_rng(SEED + 1)
    prompts = make_requests(rng, 3, 64, 600, cfg.vocab_size)
    outs = {}
    for paged in (True, False):
        eng = Engine.from_config(model, EngineConfig(serving=ContinuousConfig(
            num_slots=2, chunk_size=256, max_seq=640, paged=paged)), policy=policy)
        for p, a in zip(prompts, [0, 1, 3]):
            eng.submit(p, max_new_tokens=8, arrival=a)
        outs[paged] = eng.run(params)["outputs"]
        del eng
    print(f"  paged {outs[True]}; slab {outs[False]}")
    if outs[True] != outs[False]:
        fail("phase 10d: the slab's greedy tokens differ from the paged pool's")
    print("  greedy tokens identical")
    del model, params


def phase_mixtral(torch, rates):
    """Phase 10: Mixtral-8x7B and the dense slab, after phase 9 freed its
    models.  Returns the launches of 10a and 10b, by run."""
    free_device(torch, "before phase 10 (phase 9 freed)")
    seconds = {}
    t0 = time.perf_counter()
    launches, _, model, params, policy = phase_mixtral_serve(torch, rates)
    seconds["10a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one_shot = phase_mixtral_oneshot(torch, model, params, policy)
    del model, params
    free_device(torch, "after 10b")
    seconds["10b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_mixtral_parity(torch)
    free_device(torch, "after 10c")
    seconds["10c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_slab_cli(torch)
    free_device(torch, "after 10d")
    seconds["10d"] = time.perf_counter() - t0
    print(f"phase 10 seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    return {"10a": launches, "10b": one_shot}


# ------------------------------------------ phase 11: the recurrent families

# phase 2m: nm_prune_matmul at the recurrent families' projection widths, at
# a full chunk and the dyadic tail sizes an exact-chunk prefill also runs
RECURRENT_PRUNED = (("RWKV6-7B r/k/v/g", 4096, 4096), ("RWKV6-7B gate", 4096, 14336),
                    ("RWKV6-7B down", 14336, 4096), ("RecurrentGemma-2B W_in/W_gate", 2560, 2560),
                    ("RecurrentGemma-2B gate", 2560, 7680),
                    ("RecurrentGemma-2B down", 7680, 2560))
DYADIC_ROWS = (256, 64, 8, 1)


def phase_recurrent_kernels(torch, timer, rates, records):
    """2m: ``nm_prune_matmul`` (8:16, an Amber scale) at RWKV6-7B's and
    RecurrentGemma-2B's pruned projection widths, at 256 rows (a full
    chunk) and at 64, 8 and 1 (exact dyadic tails): within ``BF16_TOL`` of
    its plain version on its wgmma route, timed beside its bound and
    ``torch.matmul`` of the pruned x (:func:`time_nm_prune_matmul`)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    keep = functools.partial(keep_case, records)
    print("phase 2m: nm_prune_matmul at the recurrent families' widths, 256 rows and the "
          f"dyadic tails {DYADIC_ROWS[1:]}")
    for label, d, n_out in RECURRENT_PRUNED:
        for t in DYADIC_ROWS:
            time_nm_prune_matmul(torch, timer, rates, g, keep, f"{label} T={t}", d, n_out, t,
                                 biased=False)


# 2o: osparse_matmul at the shapes the W8A8 rewrite of RWKV6-7B (11e) and of
# Whisper-medium (12e) gives it: (label, K, N_out, bias, rows)
FAMILY_QUANT = (("RWKV6-7B r/k/v/g/o/up", 4096, 4096, False, DYADIC_ROWS),
                ("RWKV6-7B gate", 4096, 14336, False, DYADIC_ROWS),
                ("Whisper-medium q/v/o", 1024, 1024, True, (256, 1500)),
                ("Whisper-medium fc1", 1024, 4096, True, (256, 1500)))


def phase_family_int8_kernels(torch, timer, rates, records):
    """2o: ``osparse_matmul`` (8:16 pruned, the static per-tensor scale) at
    RWKV6-7B's 4096² and 4096 x 14336 at 256 rows and the dyadic tails 64, 8
    and 1, and at Whisper-medium's biased 1024² and 1024 x 4096 at a
    256-row chunk and the encoder's 1500 rows: bit-exact against its plain
    version on its plan's route, timed beside its bound and ``torch._int_mm``
    with the dequant (:func:`time_osparse_matmul`)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    rng = np.random.default_rng(SEED + 23)
    keep = functools.partial(keep_case, records)
    print("phase 2o: osparse_matmul at the W8A8 recurrent and encoder-decoder widths")
    for label, d, n_out, biased, rows in FAMILY_QUANT:
        for t in rows:
            time_osparse_matmul(torch, timer, rates, g, rng, keep, label, d, n_out, t,
                                prune=True, biased=biased)


# 11b's two long requests (past RecurrentGemma-2B's 2048-row rings) and max_seq
# 11a/11e: RWKV6-7B's depth, cut from its 32 layers to make room for phases 14
# and 15 in the run's time (full width)
RWKV_DEPTH, RWKV_FULL_DEPTH = 8, 32
# 11b/11c: RecurrentGemma-2B's depth, cut from its 26 layers (8 periods of
# rglru, rglru, attn and two rglru) to 4 periods and the two, for phase 15's
# time (full width)
RG_DEPTH = 14
RG_LONG = (2300, 2600)
RG_SEQ = 4096
# 11c's one-shot prompt (2j's timed flash shape) and 11d's prompt lengths
RG_ONESHOT = 4096
RECURRENT_PARITY_LENS = {"rwkv6_7b": (600, 300), "recurrentgemma_2b": (2300, 300)}


def recurrent_model(torch, arch, n_layers=None, seed=SEED, dtype=None):
    """``arch`` at full width (depth and dtype optionally changed), random
    weights from ``seed`` made on the card, the paper's policy with the
    kernels on and the Amber scales."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, dtype=dtype or cfg.dtype)
    model = build_model(cfg)
    params = model.init(seed)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(use_kernels=True)
    precompute_scales(params, policy)
    return cfg, model, params, policy


def rg_stream(vocab, **serving):
    """Phase 3's 8 seeded requests plus two of 2300-2600 tokens, so that
    RecurrentGemma-2B's 2048-row rings wrap, 32 new tokens each; 4 slots,
    chunk 256, max_seq 4096 (:func:`serving_stream`'s form)."""
    from repro_torch.serve import ContinuousConfig

    rng = np.random.default_rng(SEED)
    prompts = make_requests(rng, 8, 64, 700, vocab) + make_requests(rng, 2, *RG_LONG, vocab)
    arrivals = [0, 0, 1, 2, 4, 6, 9, 12, 3, 14]
    return rng, prompts, arrivals, 32, ContinuousConfig(
        num_slots=4, chunk_size=256, max_seq=RG_SEQ, **serving)


@contextlib.contextmanager
def timed_captures(torch):
    """Seconds spent capturing graphs (``_capture.Graph.capture``) while
    the block runs: ``out["seconds"]``, ``out["graphs"]``."""
    from repro_torch.kernels import _capture

    out = {"seconds": 0.0, "graphs": 0}
    real = _capture.Graph.capture

    def capture(self, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(self, fn)
        torch.cuda.synchronize()
        out["seconds"] += time.perf_counter() - t0
        out["graphs"] += 1
        return res

    _capture.Graph.capture = capture
    try:
        yield out
    finally:
        _capture.Graph.capture = real


# the recurrences: plain torch, computed outside any kernel of the port (the
# reference computes them outside Pallas); a profile books them as a family
# of their own by recording their calls and timing those alone
RECURRENCE_FNS = (("rwkv6", "wkv_chunked"), ("rwkv6", "_time_mix_step"),
                  ("rglru", "_rglru_scan"), ("rglru", "_rglru_step"))


def recurrence_report(torch, results, eager):
    """The recurrence as a family of each profiled step: every call of
    ``RECURRENCE_FNS`` that the step's eager computation makes is recorded
    (its inputs cloned), then the recorded calls alone are profiled eagerly
    (device busy time, kernels) and captured into one CUDA graph whose
    replay is timed with CUDA events (median of 5), and set beside the
    step's own busy time."""
    import importlib

    from torch.profiler import ProfilerActivity, profile

    mods = {m: importlib.import_module(f"repro_torch.models.{m}") for m, _ in RECURRENCE_FNS}
    for case, fn in eager.items():
        calls = []
        reals = {}
        for m, name in RECURRENCE_FNS:
            real = reals[m, name] = getattr(mods[m], name)

            def spy(*args, _real=real):
                calls.append((_real, [a.clone() if torch.is_tensor(a) else a for a in args]))
                return _real(*args)

            setattr(mods[m], name, spy)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            for (m, name), real in reals.items():
                setattr(mods[m], name, real)

        if not calls:
            fail(f"{case}: the step made no recurrence call")

        def rec():
            for real, args in calls:
                real(*args)

        rec()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rec()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        eager_ms = busy_time(spans) / 1e3
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            rec()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rec()
        times = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            graph.replay()
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        graph_ms = statistics.median(times)
        busy = results[case]["busy_ms"]
        share = "" if not busy else f", {graph_ms / busy:.3f} of the step's busy {busy:.3f} ms"
        print(f"  {case}: recurrence {len(calls)} calls, {len(spans)} kernels, eager busy "
              f"{eager_ms:.3f} ms; as one graph {graph_ms:.3f} ms (CUDA events){share}")
        del graph
        chunked = [args for real, args in calls if real is reals["rwkv6", "wkv_chunked"]]
        if chunked:
            wkv_against_the_loop(torch, mods["rwkv6"], chunked[0], case)
        del calls


def wkv_against_the_loop(torch, rwkv6, args, case):
    """One layer's chunked WKV against its plain twin, the token loop
    (``wkv_scan``), on the inputs it had in ``case``: output and state
    within ``F32_TOL``; each timed alone with CUDA events (median of 3)."""
    S, r, k, v, lw, u, n_heads = args
    got = rwkv6.wkv_chunked(S, r, k, v, lw, u, n_heads)
    want = rwkv6.wkv_scan(S, r, k, v, lw.exp(), u, n_heads)
    check_close(f"{case}: layer 0 WKV chunked vs the token loop, y (T={r.shape[1]})", got[1],
                want[1], F32_TOL)
    check_close(f"{case}: layer 0 WKV chunked vs the token loop, state", got[0], want[0],
                F32_TOL)
    times = {}
    for name, fn in (("chunked", lambda: rwkv6.wkv_chunked(S, r, k, v, lw, u, n_heads)),
                     ("loop", lambda: rwkv6.wkv_scan(S, r, k, v, lw.exp(), u, n_heads))):
        fn()
        ms = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        times[name] = statistics.median(ms)
    print(f"  layer 0 WKV alone, eager: chunked {times['chunked']:.3f} ms, token loop "
          f"{times['loop']:.3f} ms")


def serve_recurrent(torch, label, arch, rates, stream_fn=None, chunk_pos=256,
                    decode_pos=(700, 500, 300, 100), n_layers=None):
    """11a/11b: ``arch`` at full width (depth ``n_layers``, default all its
    layers), served on the dense slab
    in exact dyadic chunks (:func:`serve_requests` with ``stream_fn``; each
    program captured once per chunk length it ran), launches exact (per
    sparse chunk :func:`prune_launches` ``nm_prune_matmul``; no
    other kernel: the ring attention and the recurrences are plain torch),
    tok/s, peak memory and capture seconds, a 256-token chunk (at
    ``chunk_pos``) and a decode step profiled with the recurrence as a
    family of its own, graphed tokens equal to the eager programs'.
    Returns (launches, model, params, policy)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_kinds

    t0 = time.perf_counter()
    cfg, model, params, policy = recurrent_model(torch, arch, n_layers)
    torch.cuda.synchronize()
    n_w = sum(p.numel() for p in params.parameters())
    full = get_config(arch).n_layers
    depth = "and depth" if n_layers is None else f"depth {n_layers} of {full}"
    print(f"phase {label}: serve {cfg.name} at full width {depth} ({cfg.n_layers} layers "
          f"{cfg.block_pattern}, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, rnn_width {cfg.rnn_width}, vocab {cfg.vocab_size}, "
          f"{cfg.attn_type} window {cfg.window}, {cfg.dtype}) on the dense slab, exact dyadic "
          f"chunks, paper_policy(8, 16, {cfg.qgate_skip_layers}) with the kernels")
    print(f"  random weights: {n_w / 1e9:.3f}B parameters ({n_w * 2 / 2**30:.2f} GiB in bf16; "
          f"n_params() {cfg.n_params() / 1e9:.3f}B) in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held")
    fused, _ = prune_launches(cfg, policy)
    # RWKV6-7B: r/k/v/g (as q_proj), gate and down in every layer;
    # RecurrentGemma-2B: W_in, W_gate, the MLP's gate and down in an rglru
    # layer, q, gate and down in an attention layer
    kinds = layer_kinds(cfg)
    want = {"rwkv6_7b": 6 * cfg.n_layers,
            "recurrentgemma_2b": 4 * kinds.count("rglru") + 3 * kinds.count("attn")}[arch]
    if fused != want:
        fail(f"phase {label}: the paper policy prunes {fused} projections per chunk, "
             f"expected {want}")
    with timed_captures(torch) as cap:
        launches, st, eng, outputs = serve_requests(torch, model, params, policy,
                                                    f"phase {label}", stream_fn=stream_fn)
    ex = eng.replica.exec
    if ex.paged or not ex.exact_chunks or eng.replica.metrics["paged"] != {"enabled": False}:
        fail(f"phase {label}: not served on the slab in exact chunks")
    print(f"  graph captures {cap['graphs']} in {cap['seconds']:.2f} s (warm-up and stream; "
          f"each after its program's eager first step)")
    check_launches(f"phase {label}", launches, {
        "nm_prune_matmul": fused * st["sparse_chunks"], "nm_prune": 0, "paged_kv_scatter": 0,
        "paged_attention": 0, "nm_spmm": 0, "flash_attention": 0, "osparse_matmul": 0})
    print(f"  launches held: per sparse chunk nm_prune_matmul {fused}; no attention kernel "
          "(the ring attention and the recurrences are plain torch)")
    state = sum(leaf.numel() * leaf.element_size() for layer in ex.cache["layers"]
                for k, leaf in layer.items() if k not in ("k", "v"))
    print(f"  the slab's recurrent state {state / 2**20:.1f} MiB for {ex.cache['pos'].shape[0]} "
          "slots")
    print(f"phase {label}: profile one 256-token prefill chunk (at {chunk_pos}) and one decode "
          f"step of {cfg.name}")
    results, eager = profile_steps(torch, model, params, policy, eng,
                                   max_seq=eng.replica.cfg.max_seq, chunk_pos=chunk_pos,
                                   decode_pos=decode_pos)
    recurrence_report(torch, results, eager)
    del eng, ex
    check_graphed_tokens(torch, model, params, policy, f"phase {label}", outputs,
                         stream_fn=stream_fn)
    return launches, model, params, policy


def quantize_family(torch, params, seed):
    """``params`` rewritten in place to W8A8 under ``QuantConfig()`` from a
    seeded calibration absmax for every projection site
    (``weights.projection_sites``: its key, its input width); returns the
    int8 weights' bytes."""
    from repro_torch.core import quant
    from repro_torch.weights import projection_sites, quantize_linears

    rng = np.random.default_rng(seed)
    absmax = {key: calib_absmax(rng, getattr(owner, name).w.shape[0])
              for key, owner, name, _, _ in projection_sites(params)}
    quantize_linears(params, absmax, quant.QuantConfig())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sum(b.numel() for n_, b in params.named_buffers() if n_.endswith(".wq"))


def family_launches(params, policy):
    """Per-layer launch counts of a W8A8 model's projections, from the module
    name each call passes and what the rewrite made of it: ``(every, first)``,
    each ``[osparse_matmul, of them pruned, nm_prune_matmul]``.  ``every``
    counts the projections of every step half (the pruned ones in a sparse
    chunk only, ``nm_prune_matmul`` never in decode); ``first`` those of a
    first chunk alone: the encoder-decoder's encoder and its cross k/v,
    which later chunks and decode read from the cache."""
    from repro_torch.layers.linear import QuantLinear
    from repro_torch.weights import projection_sites

    every, first = [0, 0, 0], [0, 0, 0]
    for key, owner, name, module, layer in projection_sites(params):
        q = isinstance(getattr(owner, name), QuantLinear)
        p = policy.should_prune(module, layer)
        once = params.cfg.is_encdec and (key[0] == "enc" or key[2] in (
            "cross_attn.k_proj", "cross_attn.v_proj"))
        acc = first if once else every
        acc[0] += q
        acc[1] += q and p
        acc[2] += p and not q
    return every, first


# 11e and 12e: per-layer (every, first) launches under paper_policy and
# QuantConfig(): RWKV6-7B's 7 quantized calls a layer (r/k/v/g as q_proj, o,
# the channel mix's gate and up), 5 of them pruned, down on nm_prune_matmul;
# Whisper-medium's decoder 7 a step half (self q/k/v/o, cross q/o, fc1; 3
# pruned: self q, cross q, fc1; fc2 on nm_prune_matmul) and on a first chunk
# its encoder's 5 (q/k/v/o, fc1; q and fc1 pruned; fc2) and cross k/v
FAMILY_PER_LAYER = {"rwkv6-7b": ([7, 5, 1], [0, 0, 0]),
                    "whisper-medium": ([7, 3, 1], [7, 2, 1])}


def serve_quantized_family(torch, label, model, params, policy, stream_fn=None,
                           extras_fn=None, **profile):
    """11e (RWKV6-7B, 11a's weights) and 12e (Whisper-medium, 12a's): the
    model rewritten in place to W8A8 under ``QuantConfig()`` from a seeded
    calibration absmax, served as the float model was (:func:`serve_requests`
    with its stream and stubs): launches exact (:func:`family_launches`,
    held to ``FAMILY_PER_LAYER``), every ``osparse_matmul`` launch on its
    wgmma or swap_fused route, tok/s and peak memory, a chunk and a decode
    step profiled (``profile``: :func:`profile_steps`' positions), graphed
    tokens equal to the eager programs'.  Returns the launches."""
    from repro_torch.core import quant

    cfg = model.cfg
    qcfg = quant.QuantConfig()
    print(f"phase {label}: serve {cfg.name} Outstanding-sparse at full size (W8A8 "
          f"alpha={qcfg.alpha} outstanding={qcfg.outstanding} per_token={qcfg.per_token_act} "
          f"skip_modules={qcfg.skip_modules}, a seeded calibration absmax; Amber 8:16 under "
          "the paper policy), as the float model was served")
    t0 = time.perf_counter()
    n_q = quantize_family(torch, params, SEED + 20)
    print(f"  rewrite in {time.perf_counter() - t0:.1f} s: {n_q / 1e9:.3f}B int8 weights; "
          f"device memory held {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    every, first = family_launches(params, policy)
    n_every = cfg.n_layers
    n_first = cfg.n_encoder_layers if cfg.is_encdec else 0
    per_layer = ([x // n_every for x in every], [x // max(n_first, 1) for x in first])
    print(f"  per layer: every step half {per_layer[0]}, a first chunk alone {per_layer[1]} "
          "(osparse_matmul, of them pruned, nm_prune_matmul)")
    if per_layer != FAMILY_PER_LAYER[cfg.name] or any(
            x % n_every for x in every) or any(x % max(n_first, 1) for x in first):
        fail(f"phase {label}: launches a layer {per_layer}, expected "
             f"{FAMILY_PER_LAYER[cfg.name]}")
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, f"phase {label}",
                                                stream_fn=stream_fn, extras_fn=extras_fn)
    rep = eng.replica
    n_ex = sum(extras_fn(i) is not None for i in range(len(outputs))) if extras_fn else 0
    halves = st["prefill_halves"] + st["decode_halves"]
    check_launches(f"phase {label}", launches, {
        "osparse_matmul": every[0] * halves + first[0] * n_ex,
        "osparse_matmul (prune=True)": every[1] * st["sparse_chunks"] + first[1] * n_ex,
        "nm_prune_matmul": every[2] * st["sparse_chunks"] + first[2] * n_ex,
        "paged_kv_scatter": 0, "paged_attention": 0, "nm_prune": 0, "nm_spmm": 0,
        "flash_attention": 0})
    routes = {r: c for r, c in launches["osparse_matmul routes"].items() if c}
    print(f"  launches held: osparse_matmul {every[0]} a step half"
          + (f" + {first[0]} a first chunk" if n_ex else "") + f", {every[1]} pruned a sparse "
          f"chunk, nm_prune_matmul {every[2]} a sparse chunk"
          + (f" + {first[2]} a first chunk" if n_ex else "") + f"; by route {routes}")
    if not routes or not set(routes) <= {"wgmma", "swap_fused"}:
        fail(f"phase {label}: osparse_matmul launches by route {routes}, expected wgmma "
             "(prefill) and swap_fused (decode) only")
    print(f"phase {label}: profile a chunk and a decode step of {cfg.name} in W8A8")
    results, eager = profile_steps(torch, model, params, policy, eng,
                                   max_seq=rep.cfg.max_seq, **profile)
    if not cfg.is_encdec:
        recurrence_report(torch, results, eager)
    del eng, rep
    check_graphed_tokens(torch, model, params, policy, f"phase {label}", outputs,
                         stream_fn=stream_fn, extras_fn=extras_fn)
    return launches


def phase_recurrent_oneshot(torch, model, params, policy):
    """11c: ``ServingEngine.generate`` of RecurrentGemma-2B (11b's weights)
    with ``attn_impl="flash"`` at B = 1, T = 4096 (past the 2048 window:
    the flash kernel's 256-column tile and band) and 32 new tokens: the
    prefill and decode graphs captured once, per prefill exactly 8
    ``flash_attention`` and 96 ``nm_prune_matmul`` launches (no paged
    kernel), tokens equal to the same run without graphs.  Returns the
    launches of the timed run."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import build_model
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serve import ServeConfig, ServingEngine

    cfg = dataclasses.replace(model.cfg, attn_impl="flash")
    mflash = build_model(cfg)
    t_len, new = RG_ONESHOT, 32
    n_attn = layer_kinds(cfg).count("attn")
    fused, _ = prune_launches(cfg, policy)
    prompts = torch.from_numpy(np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab_size, size=(1, t_len))).cuda()
    print(f"phase 11c: one-shot {cfg.name}, attn_impl=flash, B=1, T={t_len}, {new} new tokens, "
          f"rings of {min(cfg.window, t_len + new)} rows; flash_plan "
          f"{kfa.flash_plan(torch.bfloat16, cfg.head_dim, True)}")
    eng = ServingEngine(mflash, policy, ServeConfig(max_seq=t_len + new))
    with timed_captures(torch) as cap:
        eng.generate(params, {"tokens": prompts}, max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    toks, pf_s, dec_s = timed_generate(torch, eng, params, prompts, new)
    launches = kernels.launch_counts()
    routes = dict(kfa.flash_attention.route_launches)
    # timed_generate runs two generates: two prefills
    check_launches("phase 11c", launches, {
        "flash_attention": 2 * n_attn, "nm_prune_matmul": 2 * fused, "nm_prune": 0,
        "paged_kv_scatter": 0, "paged_attention": 0, "nm_spmm": 0, "osparse_matmul": 0})
    traces = eng.trace_counts
    if any(n != 1 for n in traces.values()):
        fail(f"phase 11c: trace_counts {traces}: each program must be captured once")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("phase 11c: a token outside the vocabulary")
    print(f"  trace_counts {traces} ({cap['graphs']} captures in {cap['seconds']:.2f} s); "
          f"launches {launches}; flash_attention routes {routes}")
    print(f"  per prefill: flash_attention {n_attn}, nm_prune_matmul {fused}")
    print(f"  prefill {t_len} tokens in {pf_s:.3f} s = {t_len / pf_s:.1f} tok/s; decode "
          f"{new - 1} steps in {dec_s:.3f} s = {(new - 1) / dec_s:.1f} tok/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    eager = ServingEngine(mflash, policy, ServeConfig(max_seq=t_len + new))
    eager._graphs.run = lambda name, fn, params, shape=None: fn()
    want = eager.generate(params, {"tokens": prompts}, max_new_tokens=new)["tokens"]
    if not torch.equal(toks, want):
        fail("phase 11c: graphed tokens differ from the eager run's")
    print(f"  tokens {toks[0, :8].tolist()}...: identical to the same generate without graphs")
    del eng, eager
    return launches


def dyadic_greedy(torch, mdl, prm, pol, prompt, new, max_seq, chunk=256):
    """One prompt through exact dyadic chunks of at most ``chunk`` tokens
    under ``pol`` into a fresh cache, then ``new`` greedy decode steps under
    DENSE (with ``pol``'s kernel switch), eagerly: (tokens, last-chunk
    logits)."""
    from repro_torch.core.policy import DENSE
    from repro_torch.serve.scheduler import _dyadic_sizes

    cache = mdl.init_cache(1, max_seq)
    s = 0
    for size in _dyadic_sizes(len(prompt), chunk):
        toks = torch.from_numpy(prompt[s:s + size][None, :]).cuda()
        lg, cache = mdl.prefill_chunk(prm, {"tokens": toks}, cache, policy=pol)
        s += size
    first, out = lg, []
    dense = DENSE.with_(use_kernels=pol.use_kernels)
    for _ in range(new):
        tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
        out.append(int(tok[0, 0]))
        lg, cache = mdl.decode_step(prm, tok, cache, policy=dense)
    return out, first


def phase_recurrent_parity(torch):
    """11d: both models at full width, depth 2 (RWKV6-7B) and 5
    (RecurrentGemma-2B: one period and its two tail blocks): the kernel
    path against the plain path on two prompts each (RecurrentGemma's
    longer one past its window) in exact dyadic chunks and 8 greedy decode
    steps, eagerly.  float32: identical greedy tokens, the N:M flips between
    the paths counted on prompt 0; bf16: the last-chunk logits within
    ``BF16_E2E_FACTOR`` times the plain path's own bf16 effect
    (:func:`check_bf16_logits`), greedy agreement printed."""
    from repro_torch.models import build_model

    for arch, depth in (("rwkv6_7b", 2), ("recurrentgemma_2b", 5)):
        rng = np.random.default_rng(SEED + 16)
        for dtype in ("float32", "bfloat16"):
            cfg, model, params, policy = recurrent_model(torch, arch, depth, SEED + 1, dtype)
            print(f"phase 11d: {cfg.name} kernel path vs plain path, full width, depth "
                  f"{depth}, {dtype}")
            prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                       for n in RECURRENT_PARITY_LENS[arch]]
            plain = policy.with_(use_kernels=False)
            max_seq = max(len(p) for p in prompts) + 16

            def run(mdl, prm, pol, ps=prompts):
                toks, logits = [], []
                for p in ps:
                    t, lg = dyadic_greedy(torch, mdl, prm, pol, p, 8, max_seq)
                    toks.append(t)
                    logits.append(lg)
                return toks, logits

            got, got_logits = run(model, params, policy)
            want, want_logits = run(model, params, plain)
            print(f"  prompts {[len(p) for p in prompts]}: kernel path {got}")
            if dtype == "float32":
                for i, (a, b) in enumerate(zip(got_logits, want_logits)):
                    print(f"  prompt {i} last-chunk logits: max_abs_err "
                          f"{float((a - b).abs().max()):.3e}, largest |logit| "
                          f"{float(b.abs().max()):.3e}")
                print_flips("phase 11d", nm_flips(torch, lambda k: run(
                    model, params, policy if k else plain, prompts[:1])))
                if got != want:
                    fail(f"phase 11d: greedy tokens differ: kernel {got} vs plain {want}")
                print("  greedy tokens identical")
            else:
                model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
                p32 = copy.deepcopy(params).float()
                _, ref_logits = run(model32, p32, plain)
                check_bf16_logits(got_logits, want_logits, ref_logits)
                margins = [float(torch.topk(b[0].float(), 2).values.diff().abs())
                           for b in want_logits]
                report_bf16_agreement(got, want, margins)
                del model32, p32
            del model, params
            torch.cuda.empty_cache()


def recurrent_w8a8_parity(torch):
    """11d, W8A8: both models at 11d's depths in float32, rewritten to W8A8
    (:func:`quantize_family`), on 11d's prompts in exact dyadic chunks and 8
    greedy decode steps, the kernel path (``osparse_matmul`` for every
    quantized projection) against the plain path: per prompt, on the kernel
    path's N:M selections and int8 codes (:func:`forced_selection_logits`),
    greedy tokens identical and the last-chunk logits within
    ``FORCED_W8A8_TOL`` of the largest (where the plain path's own codes
    would have parted from the kernel's is printed,
    :func:`print_code_parting`); free-running, the logits' difference
    printed and, for RWKV6-7B, greedy tokens identical.
    RecurrentGemma-2B's free-running paths part: its float32 selections
    flip already (11d, 12% of the groups at layer 4 on its 2300-token
    prompt, carried through the recurrent state)."""
    for arch, depth in (("rwkv6_7b", 2), ("recurrentgemma_2b", 5)):
        rng = np.random.default_rng(SEED + 16)
        cfg, model, params, policy = recurrent_model(torch, arch, depth, SEED + 1, "float32")
        quantize_family(torch, params, SEED + 21)
        print(f"phase 11d: {cfg.name} in W8A8 (QuantConfig()), kernel path vs plain path, "
              f"full width, depth {depth}, float32")
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in RECURRENT_PARITY_LENS[arch]]
        max_seq = max(len(p) for p in prompts) + 16

        def run(pol, ps=prompts):
            out = [dyadic_greedy(torch, model, params, pol, p, 8, max_seq) for p in ps]
            return [t for t, _ in out], [lg for _, lg in out]

        got, got_logits = run(policy)
        want, want_logits = run(policy.with_(use_kernels=False))
        for i, (a, b) in enumerate(zip(got_logits, want_logits)):
            print(f"  prompt {i} last-chunk logits, free-running: max_abs_err "
                  f"{float((a - b).abs().max()):.3e}, largest |logit| {float(b.abs().max()):.3e}")
        agree = sum(x == y for g, w in zip(got, want) for x, y in zip(g, w))
        print(f"  free-running greedy tokens agree {agree}/{sum(len(g) for g in got)}")
        if arch == "rwkv6_7b" and got != want:
            fail(f"phase 11d W8A8: greedy tokens differ: kernel {got} vs plain {want}")
        for i, prompt in enumerate(prompts):
            codes = []
            (ktoks, klogits), (ftoks, flogits) = forced_selection_logits(
                torch, lambda pol: run(pol, [prompt]), policy, codes)
            check_close(f"prompt {i} last-chunk logits against the plain path on the kernel "
                        "path's N:M selections and int8 codes", klogits[0], flogits[0],
                        FORCED_W8A8_TOL)
            print_code_parting(codes)
            if ktoks != ftoks:
                fail(f"phase 11d W8A8: prompt {i}'s greedy tokens on the kernel path's "
                     f"selections and codes differ: kernel {ktoks} vs plain {ftoks}")
            print(f"  prompt {i}: greedy tokens on the kernel path's selections and codes "
                  f"identical: {ktoks}")
            del codes
        del model, params
        torch.cuda.empty_cache()


def phase_recurrent(torch, rates):
    """Phase 11: the recurrent families, after phase 10 freed its models.
    Returns the launches of 11a, 11e, 11b and 11c, by run."""
    free_device(torch, "before phase 11 (phase 10 freed)")
    seconds, runs = {}, {}
    t0 = time.perf_counter()
    runs["11a"], model, params, policy = serve_recurrent(torch, "11a", "rwkv6_7b", rates,
                                                         n_layers=RWKV_DEPTH)
    seconds["11a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs["11e"] = serve_quantized_family(torch, "11e", model, params, policy)
    del model, params
    free_device(torch, "after 11e")
    seconds["11e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs["11b"], model, params, policy = serve_recurrent(
        torch, "11b", "recurrentgemma_2b", rates, stream_fn=rg_stream, chunk_pos=2304,
        decode_pos=(2400, 2100, 300, 100), n_layers=RG_DEPTH)
    seconds["11b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs["11c"] = phase_recurrent_oneshot(torch, model, params, policy)
    del model, params
    free_device(torch, "after 11c")
    seconds["11c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_recurrent_parity(torch)
    recurrent_w8a8_parity(torch)
    free_device(torch, "after 11d")
    seconds["11d"] = time.perf_counter() - t0
    print(f"phase 11 seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    return runs


# ------------------------------------------------------- the modality families

# 2n: nm_prune_matmul's projections on the modality paths: (label, K, N_out,
# bias); Whisper-medium's every projection has a bias, Qwen2-VL-2B's q one
MODALITY_PRUNED = (("Whisper-medium q", 1024, 1024, True),
                   ("Whisper-medium fc1", 1024, 4096, True),
                   ("Whisper-medium fc2", 4096, 1024, True),
                   ("Qwen2-VL-2B q", 1536, 1536, True), ("Qwen2-VL-2B gate", 1536, 8960, False),
                   ("Qwen2-VL-2B down", 8960, 1536, False))
# a prefill chunk's rows and Whisper-medium's encoder rows
MODALITY_ROWS = (256, 1500)
WHISPER_ENC = 1500
# 12a/12b/12e: Whisper-medium's encoder and decoder depth, cut from their 24
# layers each to make room for phases 14 and 15 in the run's time (full width)
WHISPER_DEPTH, WHISPER_FULL_DEPTH = 6, 24
# 12c: Qwen2-VL-2B's depth, cut from its 28 layers to make room for phase 15
# in the run's time (full width)
VL_DEPTH = 14


def misaligned(torch, t):
    """A contiguous copy of ``t`` whose storage starts one element past a
    16-byte boundary (the rows route's case of a bf16 call)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def phase_modality_kernels(torch, timer, rates, records):
    """2n: the kernels at the modality families' shapes, each held to its
    plain version and timed beside its bound and library yardstick:
    ``flash_attention`` non-causal over keys of another length (Whisper-
    medium's cross-attention, 16 / 16 heads of 64 over 1500 encoder rows:
    a chunk of 256 queries and a decode batch of 4), bf16 on the wgmma and
    the rows route and float32 on the rows route, against SDPA;
    ``paged_attention`` at Qwen2-VL-2B's heads (12 / 2 of 128, G = 6) over
    NaN-poisoned pools, a chunk and a decode step; ``nm_prune_matmul`` at
    both models' pruned widths at 256 and 1500 rows."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import paged_attention as kpa

    bw, bf16_peak, f32_peak, _ = rates
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    dev = "cuda"
    i32 = dict(dtype=torch.int32, device=dev)
    keep = functools.partial(keep_case, records)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    s_len, h, hd = WHISPER_ENC, 16, 64
    print(f"phase 2n: flash_attention non-causal, S != T: Whisper-medium's cross-attention "
          f"({h}/{h} heads of {hd} over S={s_len} encoder rows, an edge key tile)")
    for case, b, t in (("chunk B=1 T=256", 1, 256), ("decode B=4 T=1", 4, 1)):
        k32 = torch.randn(b, s_len, h, hd, generator=g, device=dev)
        v32 = torch.randn(b, s_len, h, hd, generator=g, device=dev)
        q32 = torch.randn(b, t, h, hd, generator=g, device=dev)
        for dtype, aligned in ((torch.bfloat16, True), (torch.bfloat16, False),
                               (torch.float32, True)):
            qa, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            q = qa if aligned else misaligned(torch, qa)
            bf16 = dtype == torch.bfloat16
            route = kfa.flash_plan(dtype, hd, aligned)
            label = f"Whisper-medium cross {case} S={s_len} {str(dtype)[6:]} {route[0]}"
            before = kfa.flash_attention.route_launches[route[0]]
            err = check_close(f"{label} {route}", kfa.flash_attention(q, k, v, causal=False),
                              kfa.flash_attention_plain(q, k, v, causal=False),
                              BF16_TOL if bf16 else F32_TOL)
            if kfa.flash_attention.route_launches[route[0]] != before + 1:
                fail(f"flash_attention {label}: the call did not take its plan's route {route}")
            ms = timer.ms(lambda: kfa.flash_attention(q, k, v, causal=False))
            plain_ms = timer.ms(lambda: kfa.flash_attention_plain(q, k, v, causal=False), 5)
            # the yardstick on the aligned copy: SDPA faults on a misaligned q
            qt, kt, vt = qa.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib_ms = timer.ms(lambda: sdpa(qt, kt, vt))
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            ops = 4 * hd * b * h * t * s_len
            peak = bf16_peak if bf16 else f32_peak
            bound = max(nbytes / bw, ops / peak) * 1e3
            by = "bytes" if nbytes / bw >= ops / peak else "operations"
            print(f"  {label}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), plain "
                  f"{plain_ms:.4f} ms, SDPA non-causal {lib_ms:.4f} ms; kernel/library "
                  f"{ms / lib_ms:.2f}")
            keep("flash_attention", label, err, route=list(route), ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=bound, bound_by=by)

    hq, hkv, hd = 12, 2, 128
    print(f"phase 2n: paged_attention at Qwen2-VL-2B's heads ({hq}/{hkv} of {hd}, G = "
          f"{hq // hkv}): chunk Tq=256 at offset 300 (kv_len 556), decode B=4; NaN-poisoned "
          "pools")
    bs, mb = 16, 46
    rows = 4 * mb + 1
    perm = torch.randperm(4 * mb, generator=g, device=dev).to(torch.int32)
    tab1 = perm[:mb].reshape(1, mb).contiguous()
    qoff1, kvl1 = torch.tensor([300], **i32), torch.tensor([556], **i32)
    posd = torch.tensor([700, 513, 64, 0], **i32)
    kvld = posd + 1
    tabd = torch.full((4, mb), -1, **i32)
    for r in range(4):
        need = -(-int(kvld[r]) // bs)
        tabd[r, :need] = perm[r * mb:r * mb + need]
    kp = torch.randn(rows, bs, hkv, hd, generator=g, device=dev).bfloat16()
    vp = torch.randn(rows, bs, hkv, hd, generator=g, device=dev).bfloat16()
    for case, b, tq, tab, qo, kvl, causal in (("chunk", 1, 256, tab1, qoff1, kvl1, True),
                                              ("decode", 4, 1, tabd, posd, kvld, False)):
        q = torch.randn(b, tq, hq, hd, generator=g, device=dev).bfloat16()
        kpn, vpn = poisoned_pools(torch, kp, vp, tab, kvl)
        route = attention_route(q, kp, tab)
        if route[0] != "wgmma":
            fail(f"paged_attention Qwen2-VL-2B {case}: plan {route}, expected wgmma")
        err = check_close(f"Qwen2-VL-2B G=6 {case} {route}",
                          kpa.paged_attention(q, kpn, vpn, tab, qo, kvl, causal=causal),
                          kpa.paged_attention_plain(q, kpn, vpn, tab, qo, kvl, causal=causal),
                          BF16_TOL)
        t = paged_attention_times(torch, timer, rates, q, kp, vp, tab, qo, kvl, causal)
        print(f"  Qwen2-VL-2B G=6 {case} {route}: kernel {t['ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain {t['plain_ms']:.4f} ms, SDPA "
              f"on the gathered view {t['library_ms']:.4f} ms; kernel/library "
              f"{t['ms'] / t['library_ms']:.2f}")
        keep("paged_attention", f"Qwen2-VL-2B G=6 {case}", err, route=list(route), **t)

    print(f"phase 2n: nm_prune_matmul at the modality families' widths, {MODALITY_ROWS} rows")
    for label, d, n_out, biased in MODALITY_PRUNED:
        for t in MODALITY_ROWS:
            time_nm_prune_matmul(torch, timer, rates, g, keep, f"{label} T={t}", d, n_out, t,
                                 biased)


def modality_model(torch, arch, n_layers=None, seed=SEED, dtype=None):
    """``arch`` at full width (depth, the encoder's too, and dtype optionally
    changed), random weights from ``seed`` made on the card with seeded
    nonzero biases, the paper's policy with the kernels and the Amber
    scales."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model

    cfg = get_config(arch)
    depth = dict(n_layers=n_layers) if n_layers else {}
    if n_layers and cfg.is_encdec:
        depth["n_encoder_layers"] = n_layers
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype, **depth)
    model = build_model(cfg)
    params = model.init(seed)
    seed_biases(torch, params, seed + 100)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(use_kernels=True)
    precompute_scales(params, policy)
    return cfg, model, params, policy


def stub_fn(model, text_only=(), base=200):
    """Request ``i``'s modality arrays: seeded standard normals ``(1, rows,
    d_model)`` float32 for each stub of ``model.stub_shapes()``, as the CLI
    makes them (generator ``SEED + base + i``); None for the requests in
    ``text_only``."""
    def fn(i):
        if i in text_only:
            return None
        rng = np.random.default_rng(SEED + base + i)
        return {key: rng.standard_normal((1, *shape)).astype(np.float32)
                for key, shape in model.stub_shapes().items()}
    return fn


VL_PREFIX = 32
VL_TEXT_ONLY = (0, 1)
WHISPER_SEQ = 736       # 700 prompt tokens and 32 new ones, in blocks of 16


def whisper_stream(vocab, **serving):
    """12a's stream: phase 3's, on a slab of ``WHISPER_SEQ`` rows a slot (the
    top of its 64-700-token range plus 32 new tokens)."""
    rng, prompts, arrivals, new, scfg = serving_stream(None, vocab, **serving)
    return rng, prompts, arrivals, new, dataclasses.replace(scfg, max_seq=WHISPER_SEQ)


def vl_stream(vocab, **serving):
    """12c's stream: two text-only requests behind one 32-token prefix
    (arrivals 0 and 1: the second is admitted after the first's chunk
    registered its blocks), then phase 3's 8 requests (:func:`serving_stream`'s
    form)."""
    rng, prompts, arrivals, new, scfg = serving_stream(None, vocab, **serving)
    prefix = rng.integers(0, vocab, size=VL_PREFIX)
    pair = [np.concatenate([prefix, rng.integers(0, vocab, size=n)]).astype(np.int32)
            for n in (100, 200)]
    return rng, pair + prompts, [0, 1] + arrivals, new, scfg


def modality_launches(cfg, policy):
    """``nm_prune_matmul`` launches of a sparse chunk: (a first chunk's, a
    later chunk's), with the derivation.  The encoder-decoder passes no
    layer index, so the skip list never reaches it: q, fc1 and fc2 in every
    encoder layer (a first chunk only), self q, cross q, fc1 and fc2 in
    every decoder layer; the VLM prunes as the dense family does."""
    if cfg.is_encdec:
        enc = cfg.n_encoder_layers * sum(policy.should_prune(m, None)
                                         for m in ("q_proj", "gate_proj", "down_proj"))
        dec = cfg.n_layers * sum(policy.should_prune(m, None)
                                 for m in ("q_proj", "q_proj", "gate_proj", "down_proj"))
        why = (f"encoder {cfg.n_encoder_layers} x 3 (q, fc1, fc2) = {enc} on a first chunk, "
               f"decoder {cfg.n_layers} x 4 (self q, cross q, fc1, fc2) = {dec} on every chunk")
        return enc + dec, dec, why
    fused, _ = prune_launches(cfg, policy)
    return fused, fused, f"{cfg.n_layers} x 3 (q, gate, down) = {fused} on every chunk"


def serve_modality(torch, label, arch, rates, n_layers=None):
    """12a (Whisper-medium, on the slab; ``n_layers`` encoder and decoder
    layers, default all) and 12c (Qwen2-VL-2B, paged): full width, phase
    3's stream with a seeded stub on each request (12c adds the
    text-only pair of :func:`vl_stream`), served through ``Engine.run(params,
    extras)``: ``trace_counts`` 2 for each prefill program (with and without
    extras) and 1 for decode, launches exact, tok/s and peak memory, a first
    chunk, a later chunk and a decode step profiled, graphed tokens equal to
    the eager programs'.  Returns (launches, model, params, policy)."""
    from repro_torch.kernels import paged_attention as kpa

    t0 = time.perf_counter()
    cfg, model, params, policy = modality_model(torch, arch, n_layers)
    torch.cuda.synchronize()
    n_w = sum(p.numel() for p in params.parameters())
    vl = cfg.vision_stub
    what = (f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers, encoder_seq "
            f"{cfg.encoder_seq}" if cfg.is_encdec else
            f"{cfg.n_layers} layers, M-RoPE, n_patches {cfg.n_patches}")
    size = ("full size" if n_layers is None else
            f"full width, depth {n_layers} of {WHISPER_FULL_DEPTH if cfg.is_encdec else 28}")
    print(f"phase {label}: serve {cfg.name} at {size} ({what}, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}) through Engine.run(params, extras), "
          f"paper_policy(8, 16, {cfg.qgate_skip_layers}) with the kernels, "
          + ("paged" if vl else "on the dense slab"))
    print(f"  random weights: {n_w / 1e9:.3f}B parameters ({n_w * 2 / 2**30:.2f} GiB in bf16) "
          f"in {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} "
          "GiB held")
    first, later, why = modality_launches(cfg, policy)
    # Whisper-medium: 3 an encoder layer on a first chunk, 4 a decoder layer
    # Qwen2-VL-2B: q, gate and down in every layer
    want = {"whisper_medium": (7 * cfg.n_layers, 4 * cfg.n_layers),
            "qwen2_vl_2b": (3 * cfg.n_layers, 3 * cfg.n_layers)}[arch]
    print(f"  nm_prune_matmul per sparse chunk: {why}")
    if (first, later) != want:
        fail(f"phase {label}: {first}/{later} pruned projections a first/later chunk, "
             f"expected {want}")
    stream = vl_stream if vl else whisper_stream
    stubs = stub_fn(model, VL_TEXT_ONLY if vl else ())
    launches, st, eng, outputs = serve_requests(torch, model, params, policy, f"phase {label}",
                                                stream_fn=stream, extras_fn=stubs)
    rep = eng.replica
    traces = rep.trace_counts
    want_traces = {"step_prefill": 2, "step_prefill_decode": 2, "step_decode": 1}
    if traces != want_traces:
        fail(f"phase {label}: trace_counts {traces}, expected {want_traces}")
    if rep.exec.paged != vl or rep.exec.exact_chunks:
        fail(f"phase {label}: paged {rep.exec.paged}, exact chunks {rep.exec.exact_chunks}")
    met = rep.metrics
    n_first = sum(stubs(i) is not None for i in range(len(outputs)))
    per_step = cfg.n_layers * (st["prefill_halves"] + st["decode_halves"]) if vl else 0
    check_launches(f"phase {label}", launches, {
        "nm_prune_matmul": later * st["sparse_chunks"] + (first - later) * n_first,
        "paged_kv_scatter": per_step, "paged_attention": per_step, "nm_prune": 0,
        "nm_spmm": 0, "flash_attention": 0, "osparse_matmul": 0})
    print(f"  launches held: nm_prune_matmul {later} x {st['sparse_chunks']} sparse chunks + "
          f"{first - later} x {n_first} first chunks (with extras)"
          + (f"; paged_kv_scatter and paged_attention {cfg.n_layers} per prefill or decode "
             "half" if vl else "; no attention kernel (the reference's encoder-decoder "
                               "attention is plain, outside Pallas)"))
    if vl:
        if launches["paged_attention routes"] != {"wgmma": per_step, "rows": 0}:
            fail(f"phase {label}: paged_attention routes "
                 f"{launches['paged_attention routes']}, expected all {per_step} on wgmma")
        cached = {r["rid"]: r["cached_tokens"] for r in met["requests"]}
        hits = met["paged"]["prefix_hits"]
        print(f"  prefix cache: hits {hits}, cached tokens by request {cached}")
        if hits != 1 or any(c for rid, c in cached.items() if rid != VL_TEXT_ONLY[1]):
            fail(f"phase {label}: prefix hits must come from the text-only pair alone "
                 f"(hits {hits}, cached {cached})")
        for case, b, tq in (("chunk", 1, 256), ("decode", 4, 1)):
            plan = kpa.attention_plan(torch.bfloat16, b, tq, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim, 16, rep.cfg.max_seq // 16, True)
            print(f"  attention_plan of a {case} step: {plan}")
    else:
        cache = rep.exec.cache
        nbytes = sum(leaf.numel() * leaf.element_size() for layer in cache["layers"]
                     for leaf in layer.values())
        print(f"  the slab: {nbytes / 2**30:.2f} GiB (self K/V {rep.cfg.max_seq} and cross "
              f"K/V {cfg.encoder_seq} rows, {rep.cfg.num_slots} slots, {cfg.n_layers} layers)")
    print(f"phase {label}: profile a first chunk (with its extras), a later 256-token chunk "
          f"and a decode step of {cfg.name}")
    profile_steps(torch, model, params, policy, eng, max_seq=rep.cfg.max_seq,
                  extras=stubs(len(outputs)))
    del eng, rep
    check_graphed_tokens(torch, model, params, policy, f"phase {label}", outputs,
                         stream_fn=stream, extras_fn=stubs)
    return launches, model, params, policy


def phase_whisper_oneshot(torch, model, params, policy):
    """12b: ``ServingEngine.generate`` of Whisper-medium (12a's weights) at
    B = 4, T = 256 with seeded ``frame_embeds (4, 1500, 1024)`` and 32 new
    tokens: prefill and decode graphs captured once, per prefill exactly
    7 ``nm_prune_matmul`` launches a layer pair (4 x 256 decoder rows and 4
    x 1500 encoder rows, one launch a projection), no attention kernel, tokens
    equal to the same run without graphs.  Returns the launches of the
    timed run."""
    from repro_torch import kernels
    from repro_torch.serve import ServeConfig, ServingEngine

    cfg = model.cfg
    b, t_len, new = 4, 256, 32
    first, _, _ = modality_launches(cfg, policy)
    rng = np.random.default_rng(SEED + 18)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, t_len))).cuda()
    extras = {"frame_embeds": torch.from_numpy(rng.standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).cuda()}
    print(f"phase 12b: one-shot {cfg.name}, B={b}, T={t_len}, frame_embeds "
          f"{tuple(extras['frame_embeds'].shape)}, {new} new tokens")
    eng = ServingEngine(model, policy, ServeConfig(max_seq=t_len + new))
    with timed_captures(torch) as cap:
        eng.generate(params, {"tokens": prompts, **extras}, max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    toks, pf_s, dec_s = timed_generate(torch, eng, params, prompts, new, extras)
    launches = kernels.launch_counts()
    # timed_generate runs two generates: two prefills
    check_launches("phase 12b", launches, {
        "nm_prune_matmul": 2 * first, "flash_attention": 0, "nm_prune": 0,
        "paged_kv_scatter": 0, "paged_attention": 0, "nm_spmm": 0, "osparse_matmul": 0})
    traces = eng.trace_counts
    if traces != {f"prefill_{b}x{t_len}": 1, f"decode_{b}": 1}:
        fail(f"phase 12b: trace_counts {traces}: each program must be captured once")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("phase 12b: a token outside the vocabulary")
    print(f"  trace_counts {traces} ({cap['graphs']} captures in {cap['seconds']:.2f} s); "
          f"launches {launches}; per prefill nm_prune_matmul {first}")
    print(f"  prefill {b} x {t_len} tokens (and {b} x {cfg.encoder_seq} encoder rows) in "
          f"{pf_s:.3f} s = {b * t_len / pf_s:.1f} tok/s; decode {new - 1} steps of {b} in "
          f"{dec_s:.3f} s = {b * (new - 1) / dec_s:.1f} tok/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    eager = ServingEngine(model, policy, ServeConfig(max_seq=t_len + new))
    eager._graphs.run = lambda name, fn, params, shape=None: fn()
    want = eager.generate(params, {"tokens": prompts, **extras}, max_new_tokens=new)["tokens"]
    if not torch.equal(toks, want):
        fail("phase 12b: graphed tokens differ from the eager run's")
    print(f"  tokens {toks[0, :8].tolist()}...: identical to the same generate without graphs")
    del eng, eager
    return launches


MODALITY_PARITY_LENS = (600, 300, 64)


def modality_parity(torch, arch):
    """12d: ``arch`` at full width, depth 2 (Whisper-medium: 2 encoder and 2
    decoder layers), three requests with their stubs through
    ``Engine.run(params, extras)`` on the kernel path and the plain path,
    and each prompt's last-chunk logits (its 256-token chunks on a fresh
    cache, the stub with the first).  float32: identical greedy tokens; the
    logits within phase 4's 2% of the largest against the plain path run on
    the kernel path's N:M selections (:func:`forced_selection_logits`); and
    the free-running paths' logits within the same 2%: Qwen2-VL's for every
    prompt, Whisper's for every prompt, under the stream's stubs and a second
    seeding of them, on which no N:M group flips between the paths (at least
    one must be such).  A selection that flips on a near-tie moves everything
    after it, through the encoder into every decoder token, so where one
    flips the first call at which the paths' selections part is printed, and
    its inputs must agree within ``F32_TOL`` of their largest (the paths
    agree up to it; :func:`first_parting`).  Qwen2-VL's paged_attention all
    on the rows route; bf16: the logits
    within ``BF16_E2E_FACTOR`` times the plain path's own bf16 effect
    (:func:`check_bf16_logits`), greedy agreement printed (paged_attention
    all on wgmma)."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousConfig, Engine, EngineConfig

    rng = np.random.default_rng(SEED + 19)
    for dtype in ("float32", "bfloat16"):
        cfg, model, params, policy = modality_model(torch, arch, 2, SEED + 1, dtype)
        bf16 = dtype == "bfloat16"
        print(f"phase 12d: {cfg.name} kernel path vs plain path, full width, depth 2, {dtype}")
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in MODALITY_PARITY_LENS]
        seedings = [stub_fn(model, base=b) for b in ((200, 500) if cfg.is_encdec else (200,))]
        extras = {i: seedings[0](i) for i in range(len(prompts))}
        new, max_seq = 8, 624
        scfg = ContinuousConfig(num_slots=2, chunk_size=256, block_size=16, max_seq=max_seq)

        def chunk_logits(pol, mdl=model, prm=params, ps=prompts, ex=None):
            """Each prompt's last-chunk logits: its 256-token chunks on a
            fresh cache, its stub (``ex``, default ``extras``) with the first."""
            ex = [extras[i] for i in range(len(ps))] if ex is None else ex
            logits = []
            for prompt, stub in zip(ps, ex):
                cache = mdl.init_cache(1, max_seq)
                for s in range(0, len(prompt), 256):
                    batch = {"tokens": torch.from_numpy(prompt[s:s + 256][None, :]).cuda()}
                    if s == 0:
                        batch.update({k: torch.from_numpy(v).cuda() for k, v in stub.items()})
                    lg, cache = mdl.prefill_chunk(prm, batch, cache, policy=pol)
                logits.append(lg)
            return logits

        def run(pol, mdl=model, prm=params):
            eng = Engine.from_config(mdl, EngineConfig(serving=scfg), policy=pol)
            for p, a in zip(prompts, (0, 1, 3)):
                eng.submit(p, max_new_tokens=new, arrival=a)
            outs = eng.run(prm, extras=extras)["outputs"]
            return [outs[r] for r in sorted(outs)], chunk_logits(pol, mdl, prm)

        before = dict(kpa.paged_attention.route_launches)
        got, got_logits = run(policy)
        torch.cuda.synchronize()
        routes = {r: n - before[r] for r, n in kpa.paged_attention.route_launches.items()}
        n_attn = sum(routes.values())
        if cfg.vision_stub:
            want_routes = {"wgmma": n_attn, "rows": 0} if bf16 else {"wgmma": 0, "rows": n_attn}
            if n_attn <= 0 or routes != want_routes:
                fail(f"phase 12d: paged_attention routes {routes}, expected {want_routes}")
        print(f"  prompts {[len(p) for p in prompts]}: kernel path {got}; paged_attention "
              f"routes {routes}")
        plain = policy.with_(use_kernels=False)
        want, want_logits = run(plain)
        if bf16:
            model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
            _, ref_logits = run(plain, model32, copy.deepcopy(params).float())
            check_bf16_logits(got_logits, want_logits, ref_logits)
            margins = [float(torch.topk(b[0].float(), 2).values.diff().abs())
                       for b in want_logits]
            report_bf16_agreement(got, want, margins)
            del model32
        else:
            free = 0
            for j, stubs in enumerate(seedings):
                ex = [stubs(i) for i in range(len(prompts))]
                kern, plain_l = ((got_logits, want_logits) if j == 0 else
                                 (chunk_logits(policy, ex=ex), chunk_logits(plain, ex=ex)))
                for i, (a, b) in enumerate(zip(kern, plain_l)):
                    name = f"seeding {j} prompt {i} last-chunk logits, free-running paths"
                    part = first_parting(torch, lambda k: chunk_logits(
                        policy.with_(use_kernels=k), ps=prompts[i:i + 1], ex=ex[i:i + 1]))
                    if part is None or cfg.vision_stub:
                        check_close(name + ("" if part else " (no N:M flip)"), a, b, 2e-2)
                        free += part is None
                    if part is not None:
                        print(f"  {name}: max_abs_err {float((a - b).abs().max()):.3e}, "
                              f"largest |logit| {float(b.abs().max()):.3e}; the selections "
                              f"first part at pruned call {part['call']} of {part['calls']} "
                              f"({part['module']}): {part['flipped']} of {part['groups']} "
                              f"groups, inputs' max_abs_err {part['x_err']:.3e} of "
                              f"{part['x_max']:.3e}, smallest flipped score margin "
                              f"{part['margin']:.3e} of {part['score_max']:.3e}")
                        if not part["x_err"] <= F32_TOL * part["x_max"]:
                            fail(f"phase 12d: {name}: the inputs where the selections first "
                                 f"part differ by {part['x_err']} > {F32_TOL} x "
                                 f"{part['x_max']}")
            if cfg.is_encdec and free < 1:
                fail("phase 12d: no prompt ran free of N:M flips between the paths")
            print_flips(f"phase 12d {cfg.name} prompt 0", nm_flips(
                torch, lambda k: chunk_logits(policy.with_(use_kernels=k), ps=prompts[:1])))
            kern, forced = forced_selection_logits(torch, chunk_logits, policy)
            for i, (a, b) in enumerate(zip(kern, forced)):
                check_close(f"prompt {i} last-chunk logits against the plain path on the kernel "
                            "path's N:M selections", a, b, 2e-2)
            if got != want:
                fail(f"phase 12d: greedy tokens differ: kernel {got} vs plain {want}")
            print("  greedy tokens identical")
        del model, params
        torch.cuda.empty_cache()


def whisper_w8a8_parity(torch):
    """12d, W8A8: Whisper-medium at depth 2 in float32, rewritten to W8A8
    (:func:`quantize_family`), 12d's prompts with their stubs, each prompt's
    last-chunk logits: the kernel path against the plain path run on the
    kernel path's N:M selections and int8 codes
    (:func:`forced_selection_logits`) within ``FORCED_W8A8_TOL`` of the
    largest, where the plain path's own codes would have parted printed
    (:func:`print_code_parting`); the free-running paths' difference printed
    (its encoder's near-ties flip, ROADMAP C.6)."""
    cfg, model, params, policy = modality_model(torch, "whisper_medium", 2, SEED + 1,
                                                "float32")
    quantize_family(torch, params, SEED + 21)
    print(f"phase 12d: {cfg.name} in W8A8 (QuantConfig()), kernel path vs plain path on the "
          "kernel path's selections, full width, depth 2, float32")
    rng = np.random.default_rng(SEED + 19)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in MODALITY_PARITY_LENS]
    stubs = stub_fn(model)

    def chunk_logits(pol, ids=range(len(prompts))):
        logits = []
        for i in ids:
            prompt = prompts[i]
            cache = model.init_cache(1, 624)
            for s in range(0, len(prompt), 256):
                batch = {"tokens": torch.from_numpy(prompt[s:s + 256][None, :]).cuda()}
                if s == 0:
                    batch.update({k: torch.from_numpy(v).cuda() for k, v in stubs(i).items()})
                lg, cache = model.prefill_chunk(params, batch, cache, policy=pol)
            logits.append(lg)
        return logits

    free = chunk_logits(policy.with_(use_kernels=False))
    for i in range(len(prompts)):
        codes = []
        (a,), (b,) = forced_selection_logits(torch, lambda pol: chunk_logits(pol, [i]), policy,
                                             codes)
        check_close(f"prompt {i} last-chunk logits against the plain path on the kernel "
                    "path's N:M selections and int8 codes", a, b, FORCED_W8A8_TOL)
        print_code_parting(codes)
        c = free[i]
        print(f"  prompt {i}: free-running paths' max_abs_err {float((a - c).abs().max()):.3e}"
              f" of largest |logit| {float(c.abs().max()):.3e}; greedy token "
              f"{int(a.argmax())} vs {int(c.argmax())}")
        del codes
    del model, params
    torch.cuda.empty_cache()


def first_parting(torch, run):
    """Where the kernel path's and the plain path's N:M selections first
    part.  ``run(use_kernels)`` drives one computation on one path; every
    pruned float projection's input is kept, the calls of the two runs are
    paired in order, and each call's keep masks (``core.nm.nm_topk_mask`` of
    |x|·scale) compared.  None when no group flips; else the first such
    call: its index, the number of calls, its module, its flipped and total
    groups, the two inputs' max |difference| and largest |input|, and the
    smallest gap, over its flipped groups, between the plain path's N-th and
    (N+1)-th score of the group (with the largest score of those groups)."""
    from repro_torch.core import nm, scoring
    from repro_torch.layers.linear import Linear

    calls = {True: [], False: []}

    def recorder(use_kernels):
        def hook(x, p, module, policy, phase, layer):
            if (isinstance(p, Linear) and policy.active(phase)
                    and policy.should_prune(module, layer)):
                calls[use_kernels].append((module, x.detach().float().clone(), p.amber_scale,
                                           policy.n, policy.m))
        return hook

    for use_kernels in (True, False):
        with spy_projections(recorder(use_kernels)):
            run(use_kernels)
    if [c[0] for c in calls[True]] != [c[0] for c in calls[False]]:
        fail("first_parting: the two paths pruned different projections")
    for i, ((module, xa, scale, n, m), (_, xb, _, _, _)) in enumerate(
            zip(calls[True], calls[False])):
        sa = scoring.score_activations(xa, scale)
        sb = scoring.score_activations(xb, scale)
        flip = (nm.nm_topk_mask(sa, n, m).reshape(-1, m)
                != nm.nm_topk_mask(sb, n, m).reshape(-1, m)).any(-1)
        if bool(flip.any()):
            g = sb.reshape(-1, m)[flip].float()
            top = torch.topk(g, n + 1, dim=-1).values
            return {"call": i, "calls": len(calls[True]), "module": module,
                    "flipped": int(flip.sum()), "groups": flip.numel(),
                    "x_err": float((xa - xb).abs().max()), "x_max": float(xb.abs().max()),
                    "margin": float((top[:, n - 1] - top[:, n]).min()),
                    "score_max": float(g.max())}
    return None


def forced_selection_logits(torch, logits_fn, policy, codes=None):
    """``logits_fn(policy)`` on the kernel path, recording every pruned float
    projection's per-token keep mask (``core.nm.nm_topk_mask`` of |x|·scale:
    the kernel's own selection, bit-exact on equal inputs), every routed
    expert input's (``models.moe._maybe_prune``, plain |x|) and every W8A8
    projection's int8 codes and activation scale (``osparse_quantize``,
    bit-exact with the kernel's own quantize pass, its N:M selection of
    ``x / smooth`` included), then on the plain path with
    ``core.pruner.prune_input`` applying those masks and
    ``osparse_quantize_plain`` returning those codes, in the same call
    order: the two paths' arithmetic, end to end, on one set of discrete
    choices (the int32 GEMM of equal codes is exact; what is left is float
    arithmetic).  Returns (kernel logits, forced plain logits).  ``codes``
    (a list): every W8A8 call's smoothed input and int8 codes on each path,
    the plain path's its own (on the forced N:M selection), appended as
    ``(module, (xs, xq) kernel path, (xs, xq) plain path)`` for
    :func:`print_code_parting`."""
    from repro_torch.core import nm, pruner, quant, scoring
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.layers.linear import Linear, QuantLinear

    masks, kcodes, pcodes = [], [], []

    def record(x, p, module, pol, phase, layer):
        prune = pol.active(phase) and pol.should_prune(module, layer)
        if isinstance(p, QuantLinear):
            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            xs = x2.float() / p.smooth
            mask = (nm.nm_topk_mask(scoring.score_activations(xs, p.amber_scale), pol.n, pol.m)
                    if prune else None)
            xq, scale = kos.osparse_quantize(x2, p.smooth, p.amber_scale, pol.n, pol.m,
                                             None if p.per_token else p.act_scale, prune,
                                             p.per_token)
            kcodes.append((module, xs if codes is not None else None, mask, xq, scale))
        elif isinstance(p, Linear) and prune:
            masks.append(nm.nm_topk_mask(scoring.score_activations(x, p.amber_scale),
                                         pol.n, pol.m))

    from repro_torch.models import moe as moe_lib

    real_mp = moe_lib._maybe_prune

    def record_expert(x, module, pol, phase):
        # the routed experts' prunes (plain |X| scores, layer None) meet
        # pruner.prune_input on the plain path in the same call order
        if pol.active(phase) and pol.should_prune(module, None):
            masks.append(nm.nm_topk_mask(scoring.score_activations(x.detach(), None),
                                         pol.n, pol.m))
        return real_mp(x, module, pol, phase)

    moe_lib._maybe_prune = record_expert
    try:
        with spy_projections(record):
            got = logits_fn(policy)
    finally:
        moe_lib._maybe_prune = real_mp
    order, qorder = iter(masks), iter(kcodes)
    real, real_q = pruner.prune_input, kos.osparse_quantize_plain

    def forced(x, scale, pol):
        return torch.where(next(order), x, torch.zeros((), dtype=x.dtype, device=x.device))

    def forced_q(x, smooth, amber, n, m, act_scale=None, prune=True, per_token=False):
        module, xk, mask, xq, scale = next(qorder)
        xs = (x.float() / smooth).reshape(xq.shape) if x.numel() == xq.numel() else None
        if xs is None or (mask is not None) != prune:
            fail(f"forced selections: W8A8 call {len(pcodes)} ({module}) is not the kernel "
                 "path's call there")
        if codes is not None:
            own = torch.where(mask, xs, torch.zeros_like(xs)) if prune else xs
            own = (quant.quantize_act_per_token(own)[0] if per_token else
                   quant.quantize_act_per_tensor(own, act_scale))
            pcodes.append((xs, own))
        if per_token:
            return xq.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)
        return xq.reshape(x.shape), act_scale

    pruner.prune_input, kos.osparse_quantize_plain = forced, forced_q
    try:
        want = logits_fn(policy.with_(use_kernels=False))
    finally:
        pruner.prune_input, kos.osparse_quantize_plain = real, real_q
    if next(order, None) is not None or next(qorder, None) is not None:
        fail("forced selections: the plain path made fewer projection calls than the kernel "
             "path")
    if codes is not None:
        codes.extend((m, (xs, xq), p) for (m, xs, _, xq, _), p in zip(kcodes, pcodes))
    return got, want


def print_code_parting(codes):
    """A diagnostic: print the first W8A8 call of
    :func:`forced_selection_logits`' ``codes`` where the plain path's own
    int8 codes differ from the kernel path's (which the plain path was
    given): its module, the codes that differ and their largest step, and
    the smoothed inputs' max |difference| and largest |value|."""
    for i, (module, (xk, ck), (xp, cp)) in enumerate(codes):
        diff = ck.int() - cp.int()
        if bool(diff.any()):
            print(f"    the plain path's own int8 codes would first part at W8A8 call {i} of "
                  f"{len(codes)} ({module}): {int((diff != 0).sum())} of {diff.numel()} "
                  f"codes, by at most {int(diff.abs().max())} step, on smoothed inputs "
                  f"{float((xk - xp).abs().max()):.3e} of {float(xp.abs().max()):.3e} apart")
            return
    print(f"    the plain path's own int8 codes equal the kernel path's in all {len(codes)} "
          "W8A8 calls")


# W8A8 on forced selections and codes: no discrete choice is left to part
# the paths, so their logits are held far tighter than 12d's free-running 2%
FORCED_W8A8_TOL = 1e-3


def phase_modality(torch, rates):
    """Phase 12: the modality families, after phase 11 freed its models.
    Returns the launches of 12a, 12b, 12e and 12c, by run."""
    free_device(torch, "before phase 12 (phase 11 freed)")
    seconds, runs = {}, {}
    t0 = time.perf_counter()
    runs["12a"], model, params, policy = serve_modality(torch, "12a", "whisper_medium", rates,
                                                        n_layers=WHISPER_DEPTH)
    seconds["12a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs["12b"] = phase_whisper_oneshot(torch, model, params, policy)
    seconds["12b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs["12e"] = serve_quantized_family(torch, "12e", model, params, policy,
                                         stream_fn=whisper_stream, extras_fn=stub_fn(model),
                                         extras=stub_fn(model)(8))
    del model, params
    free_device(torch, "after 12e")
    seconds["12e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs["12c"], model, params, _ = serve_modality(torch, "12c", "qwen2_vl_2b", rates,
                                                   n_layers=VL_DEPTH)
    del model, params
    free_device(torch, "after 12c")
    seconds["12c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch in ("whisper_medium", "qwen2_vl_2b"):
        modality_parity(torch, arch)
    whisper_w8a8_parity(torch)
    free_device(torch, "after 12d")
    seconds["12d"] = time.perf_counter() - t0
    print(f"phase 12 seconds: {', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}")
    return runs


TRAIN_DEPTH = 4             # of 32 (16 until phase 15, 8 until 13f-13h needed the time): PERF.md 4
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 512, 4, 6
TRAIN_BYTES_PER_PARAM = 22  # AdamW: p read + written (bf16), g read (bf16), mu, nu r+w (f32)
TRAIN_CPU_RTOL = 1e-4       # 13d: twelve float32 steps, card against CPU


def train_model(torch, arch, n_layers, dtype=None):
    """``arch`` at full width and ``n_layers`` (None: the config's; an
    encoder-decoder's encoder cut to as many), random weights from the seed
    made on the card and made trainable."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import make_trainable

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  n_encoder_layers=min(cfg.n_encoder_layers, n_layers))
    model = build_model(cfg)
    return cfg, model, make_trainable(model.init(SEED))


def active_params(cfg, params) -> float:
    """The parameters a token's products meet: every one but the
    embedding's lookup (the LM head counts), an MoE's routed experts at
    ``top_k / n_experts``."""
    return sum(p.numel() * (cfg.top_k / cfg.n_experts if ".moe.experts." in k else 1.0)
               for k, p in params.named_parameters() if k != "embed.w")


def train_flops(cfg, params, tokens: int, seq: int) -> float:
    """Model FLOPs of one train step, the PaLM convention: 6 N a token for
    the N parameters of the products (:func:`active_params`) plus 12 L d S
    a token for attention at sequence length S, counted whole (not halved
    for causality); remat's second forward is not counted."""
    return (6.0 * active_params(cfg, params) * tokens
            + 12.0 * cfg.n_layers * cfg.d_model * seq * tokens)


def profile_once(torch, label, fn, wall_ms=None):
    """One call of ``fn`` under ``torch.profiler``: wall, device busy (the
    union of the kernels' intervals), idle share (against ``wall_ms``, the
    call's wall without the profiler, where given), and the largest kernel
    families.  Returns (wall ms, busy ms, {family: ms})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_time(spans) / 1e3
    fam = {}
    for e in kern:
        fam[kernel_family(e.key)] = fam.get(kernel_family(e.key), 0.0) + e.self_device_time_total / 1e3
    ref = wall if wall_ms is None else wall_ms
    print(f"  {label} profiled: wall {wall:.1f} ms under the profiler, device busy "
          f"{busy:.1f} ms over {sum(e.count for e in kern)} kernels, idle share "
          f"{max(0.0, 1 - busy / ref):.3f} of the {ref:.1f} ms wall"
          f"{' without the profiler' if wall_ms is not None else ''}")
    for name, ms in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"    {name}: {ms:.1f} ms")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    top: {e.key[:90]} x{e.count}: {e.self_device_time_total / 1e3:.1f} ms")
    return wall, busy, fam


def sample_leaves(named, tokens):
    """A sample of every leaf, to tell later whether it moved without a
    second copy of the weights: the embedding's rows of (up to 64 of) the
    first batch's tokens (the rows a step's gradient reaches), a strided
    4096 entries of any other leaf."""
    rows = tokens[:, :-1].reshape(-1).unique()[:64].long()
    return {k: (p.detach()[rows].clone() if k == "embed.w" else
                p.detach().reshape(-1)[::max(1, p.numel() // 4096)].clone())
            for k, p in named.items()}


def train_run(torch, label, rates, policy):
    """13a / 13b: ``TRAIN_STEPS`` steps of LLaMA-3.1-8B at depth
    ``TRAIN_DEPTH``; returns (median step seconds, launches, the
    nm_prune_matmul launches of one step)."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.train import OptConfig, adamw_init, adamw_update, make_train_step
    from repro_torch.train import trainable_params

    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = train_model(torch, "llama31_8b", TRAIN_DEPTH)
    named = trainable_params(params)
    n_params = sum(p.numel() for p in named.values())
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    kept, keep = {}, []

    def keep_grads(grads):
        if keep:                        # the profiled step's, for the optimizer's timing
            kept.update(grads)
        return grads

    step = make_train_step(model, opt_cfg, policy, compressor=keep_grads)
    opt = adamw_init(named)
    batches = [lm_batch(data, i) for i in range(TRAIN_STEPS + 1)]
    before = sample_leaves(named, batches[0]["tokens"])
    walls, losses = [], []
    kernels.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, m = step(params, opt, batches[i])[1:]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        losses.append(loss)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{label}: step {i} loss {loss} grad_norm {gnorm}")
        print(f"  {label} step {i}: loss {loss:.4f} grad_norm {gnorm:.4f} "
              f"wall {walls[-1] * 1e3:.1f} ms")
        if i == 0:
            after = sample_leaves(named, batches[0]["tokens"])
            still = [k for k in named if torch.equal(before[k], after[k])]
            no_moment = [k for k, mu in opt["mu"].items() if not bool((mu != 0).any())]
            if no_moment:
                fail(f"{label}: no gradient reached {no_moment[:4]}")
            lr1 = 3e-4 * 1 / 2
            # a bf16 weight moves only where lr * |update| > half an ulp: a
            # norm weight of 1 (ulp 2**-7) does not at lr 1.5e-4
            big = [k for k in still if float(before[k].float().abs().min()) < lr1 * 2**7]
            print(f"  {label}: after step 1 every leaf's AdamW moment is nonzero; "
                  f"{len(named) - len(still)} of {len(named)} leaves moved, the others "
                  f"({len(still)}: {sorted({k.split('.')[-2] for k in still})}) hold values "
                  f"whose bf16 half-ulp exceeds the step lr * |delta| <= {lr1:.1e}")
            if big:
                fail(f"{label}: leaves {big[:4]} did not move though the step exceeds half "
                     "their ulp")
            del before, after
    launches = kernels.launch_counts()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(walls[1:])
    flops = train_flops(cfg, params, tokens, TRAIN_SEQ)
    bound = flops / rates[1]
    print(f"  {label}: step wall {med * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}), "
          f"{tokens / med:.0f} tokens/s; model FLOPs {flops / 1e12:.2f} TFLOP (6 N T + 12 L d "
          f"S T, N = {sum(p.numel() for k, p in named.items() if k != 'embed.w') / 1e9:.3f}B "
          f"without the embedding), bound {bound * 1e3:.1f} ms at {rates[1] / 1e12:.0f} "
          f"TFLOP/s: {bound / med:.3f} of it; losses {[round(x, 4) for x in losses]}")
    dry = train_dry_count(cfg, opt_cfg, policy, rates)
    print(f"  {label}: the dry-run's count of the same step (every op executed on meta, "
          f"remat's second forward and AdamW included): {dry.flops_per_dev / 1e12:.2f} TOP "
          f"({', '.join(f'{c} {n / 1e12:.2f}' for c, n in dry.ops_per_dev.items() if n)}), "
          f"compute bound {dry.compute_s * 1e3:.1f} ms, {dry.bytes_per_dev / 1e9:.2f} GB "
          f"compulsory, memory bound {dry.memory_s * 1e3:.1f} ms, against the 6 N T + 12 L d "
          f"S T figure's {bound * 1e3:.1f} ms")
    print(f"  {label}: peak memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB, reserved {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB "
          f"({n_params / 1e9:.3f}B parameters)")
    if label == "13a" and any(launches.values()):
        fail(f"13a: the dense step launched {launches}")
    keep.append(True)
    prof = profile_once(torch, f"{label} step {TRAIN_STEPS + 1}",
                        lambda: step(params, opt, batches[TRAIN_STEPS]), med * 1e3)
    out = {"step_s": med, "launches": launches, "prof": prof}
    DRY_STEPS[label] = (dry, prof[1])
    if label == "13a":
        # the optimizer pass alone, on the last step's gradients
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        times = []
        for _ in range(3):
            ev[0].record()
            adamw_update(opt_cfg, kept, opt, named)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        byte_ms = TRAIN_BYTES_PER_PARAM * n_params / rates[0] * 1e3
        opt_ms = statistics.median(times)
        print(f"  13a optimizer pass alone: {opt_ms:.1f} ms (median of 3, CUDA events) "
              f"against its byte bound {byte_ms:.1f} ms ({TRAIN_BYTES_PER_PARAM} B a parameter "
              f"at {rates[0] / 1e12:.2f} TB/s): {byte_ms / opt_ms:.3f} of it")
        out["opt_ms"] = opt_ms
        checkpoint_rate(torch, params, opt, named)
    kept.clear()
    del params, opt, named, model, step, batches
    free_device(torch, label)
    return out


# 13a / 13b: (the dry-run's report of the step, the profiled step's busy
# ms), read by phase 16b
DRY_STEPS = {}
# the later slices' subphases' seconds, printed in the "phase seconds:" line
SUBPHASE_SECONDS = {}


def train_dry_count(cfg, opt_cfg, policy, rates):
    """The dry-run's roofline report (``launch/roofline``) of one train step
    of ``cfg`` on ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens: the same step
    function on ``meta`` tensors, counted."""
    import torch

    from repro_torch.launch import roofline
    from repro_torch.launch.cells import meta_params
    from repro_torch.models import build_model
    from repro_torch.train import adamw_init, make_train_step, make_trainable
    from repro_torch.train import trainable_params

    params = make_trainable(meta_params(cfg))
    step = make_train_step(build_model(cfg, device="meta"), opt_cfg, policy)
    batch = {"tokens": torch.empty(TRAIN_BATCH, TRAIN_SEQ + 1, dtype=torch.int32,
                                   device="meta")}
    _, count = roofline.count_step(step, params, adamw_init(trainable_params(params)), batch)
    return roofline.analyze("llama31_8b", "train", "1x1", count, cfg, "train",
                            TRAIN_BATCH * TRAIN_SEQ, roofline.HW(*rates))


def checkpoint_rate(torch, params, opt, named):
    """The write rate of ``save_checkpoint`` (device to host, npz, atomic
    rename) on layer 0's attention projections with their AdamW moments,
    and the time it implies for the whole state."""
    import tempfile

    from repro_torch.checkpoint import save_checkpoint

    keys = [k for k in named if k.startswith("blocks.0.") and k.endswith("_proj.w")
            and ".mlp." not in k]
    part = {"params": {k: named[k] for k in keys},
            "opt": {"mu": {k: opt["mu"][k] for k in keys}, "nu": {k: opt["nu"][k] for k in keys}}}
    size = sum(t.numel() * t.element_size() for d in (part["params"], part["opt"]["mu"],
                                                     part["opt"]["nu"]) for t in d.values())
    whole = sum(p.numel() * (p.element_size() + 8) for p in named.values())  # p, mu, nu
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_checkpoint(f"{tmp}/ckpt.npz", part)
        secs = time.perf_counter() - t0
    rate = size / secs
    print(f"  13a checkpoint write: {size / 2**30:.2f} GiB in {secs:.2f} s = "
          f"{rate / 2**30:.2f} GiB/s (page cache warm, the machine's local disk); the whole "
          f"state, {whole / 2**30:.1f} GiB, would take {whole / rate:.0f} s at that rate")


def train_gradient_gate(torch):
    """13c: full width, depth 2, float32, 1 x 256 tokens: the kernel path's
    gradients against the plain path's on the kernel path's N:M selections,
    with a zeroed 16-channel group of layer 0's ``ln1`` weight."""
    from repro_torch.core.policy import paper_policy
    from repro_torch.train import loss_fn, trainable_params

    cfg, model, params = train_model(torch, "llama31_8b", 2, dtype="float32")
    with torch.no_grad():
        params.blocks[0].ln1.w[:16] = 0.0
    named = trainable_params(params)
    gen = torch.Generator().manual_seed(SEED + 13)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 257), generator=gen).to(model.device)}
    policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(phases=("train", "prefill"),
                                                              use_kernels=True)

    def grads(pol):
        loss = loss_fn(model, params, batch, pol)
        return [loss.detach()] + list(torch.autograd.grad(loss, list(named.values())))

    kept_zero = []

    def spy_keep(x, p, module, pol, phase, layer):
        if module == "q_proj" and layer == 0 and pol.use_kernels and not kept_zero:
            from repro_torch.core import nm, scoring

            x = x.detach()     # recording nothing for autograd: remat counts saved tensors
            keep = nm.nm_topk_mask(scoring.score_activations(x, p.amber_scale), 8, 16)
            kept_zero.append(bool(keep[..., :8].all()) and not bool(keep[..., 8:16].any())
                             and not bool(x[..., :16].any()))

    with spy_projections(spy_keep):
        got, want = forced_selection_logits(torch, grads, policy)
    if kept_zero != [True]:
        fail(f"13c: layer 0's q input does not hold a kept zero group ({kept_zero})")
    check_close("13c loss (kernel path vs plain on its selections)", got[0], want[0], F32_TOL)
    worst = 0.0
    for (k, _), g, w in zip(named.items(), got[1:], want[1:]):
        if not bool(g.isfinite().all()):
            fail(f"13c: gradient of {k} is not finite")
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, err)
        if err > F32_TOL:
            fail(f"13c: gradient of {k}: max|diff| / max|g| = {err:.3e} > {F32_TOL}")
    q_in = got[1 + list(named).index("blocks.0.ln1.w")]
    print(f"  13c: {len(named)} gradients within {F32_TOL} of the largest entry (worst "
          f"{worst:.3e}); layer 0's zeroed ln1 channels 0-7 (kept) get gradient "
          f"{float(q_in[:8].abs().max()):.3e}")
    table = nm_flips(torch, lambda uk: grads(policy.with_(use_kernels=uk)))
    print_flips("13c free-running", table)


class SeededCopy:
    """A model whose ``init`` returns a copy of given weights; everything
    else is the wrapped model's."""

    def __init__(self, model, weights):
        self._model, self._weights = model, weights

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init(self, seed):
        return copy.deepcopy(self._weights)


def train_crash_resume(torch):
    """13d: the CPU tests' crash and resume, on the card."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, Trainer, TrainerConfig

    cfg = dataclasses.replace(get_smoke_config("llama31_8b"), dtype="float32")

    def trainer(path, resume="auto", device=None):
        return Trainer(build_model(cfg, device=device),
                       DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2),
                       OptConfig(lr=1e-3, total_steps=12),
                       TrainerConfig(total_steps=12, ckpt_every=5, ckpt_dir=path, keep=5,
                                     resume=resume))

    with tempfile.TemporaryDirectory() as tmp:
        ref = trainer(f"{tmp}/ref", "none").run(SEED)
        try:
            trainer(f"{tmp}/crash").run(SEED, crash_at=7)
            fail("13d: the crash at step 7 did not happen")
        except RuntimeError as e:
            if "simulated node failure at step 7" not in str(e):
                raise
        out = trainer(f"{tmp}/crash").run(SEED)
        # the same run on the CPU from the card's seeded weights (a CUDA
        # generator draws other numbers than the CPU's from one seed)
        on_cpu = trainer(f"{tmp}/cpu", "none", device="cpu")
        on_cpu.model = SeededCopy(on_cpu.model, build_model(cfg).init(SEED).to("cpu"))
        cpu = on_cpu.run(SEED)
    if out["resumed_from"] != 5:
        fail(f"13d: resumed from {out['resumed_from']}, not 5")
    a, b = ref["metrics"][-1]["loss"], out["metrics"][-1]["loss"]
    if not abs(a - b) <= 1e-5 * abs(a):
        fail(f"13d: final loss {b} against {a} uninterrupted")
    same = all(torch.equal(ref["state"]["params"][k], out["state"]["params"][k])
               for k in ref["state"]["params"])
    # the card's run against the same trainer on the CPU: float32 with TF32
    # off, so summation order only
    parted = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                 for x, y in zip(ref["metrics"], cpu["metrics"]))
    if not parted <= TRAIN_CPU_RTOL:
        fail(f"13d: the card's losses part from the CPU's by rel {parted:.2e}")
    print(f"  13d: the card's 12 losses against the same run on the CPU: rel {parted:.2e} at "
          f"most (limit {TRAIN_CPU_RTOL})")
    print(f"  13d: resumed from step 5; final loss {b:.7f} against {a:.7f} uninterrupted "
          f"(rel {abs(a - b) / abs(a):.2e}); parameters bit-identical: {same} (default "
          "settings: torch.use_deterministic_algorithms off, cuBLAS's default workspace; "
          f"median step {statistics.median(m['step_time_s'] for m in out['metrics']) * 1e3:.1f} "
          "ms)")


def train_cli(torch):
    """13e: the train CLI on the card with ``--sparse-train``, and its
    resume."""
    import contextlib
    import io
    import tempfile

    from repro_torch import kernels
    from repro_torch.launch.train import main as train_main

    with tempfile.TemporaryDirectory() as tmp:
        for steps, start in (("20", 0), ("30", 20)):
            argv = ["--arch", "llama31_8b", "--smoke", "--steps", steps, "--sparsity", "8:16",
                    "--sparse-train", "--ckpt-dir", tmp]
            print(f"13e: python -m repro_torch.launch.train {' '.join(argv)}")
            buf = io.StringIO()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_main(argv)
            torch.cuda.synchronize()
            out = buf.getvalue()
            print("  " + out.strip().replace("\n", "\n  "))
            launches = kernels.launch_counts()
            if rc != 0 or f"(resumed_from={start})" not in out:
                fail(f"13e: rc {rc}, expected resumed_from={start}")
            if not launches["nm_prune_matmul"]:
                fail("13e: the CLI launched no nm_prune_matmul")
            print(f"  rc 0 in {time.perf_counter() - t0:.1f} s; launches "
                  f"{ {k: v for k, v in launches.items() if v} }")


# 13f-13h: Qwen3-30B-A3B at full width; depth 4 of 48 (3.11B parameters: bf16
# weights and gradients, float32 moments, ~40-45 GiB with remat; depth 8
# would need ~70 GiB), TRAIN_BATCH x TRAIN_SEQ tokens, MOE_TRAIN_STEPS steps
MOE_TRAIN_DEPTH = 4
MOE_TRAIN_STEPS = 4


def moe_train_run(torch, label, rates, policy):
    """13f / 13g: ``MOE_TRAIN_STEPS`` steps of Qwen3-30B-A3B at depth
    ``MOE_TRAIN_DEPTH`` on ``lm_batch``; returns (median step seconds,
    launches)."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.train import OptConfig, adamw_init, make_train_step, trainable_params

    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = train_model(torch, "qwen3_30b_a3b", MOE_TRAIN_DEPTH)
    named = trainable_params(params)
    n_params = sum(p.numel() for p in named.values())
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=MOE_TRAIN_STEPS)
    step = make_train_step(model, opt_cfg, policy)
    opt = adamw_init(named)
    batches = [lm_batch(data, i) for i in range(MOE_TRAIN_STEPS + 1)]
    walls, losses = [], []
    kernels.reset_launch_counts()
    for i in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, m = step(params, opt, batches[i])[1:]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        losses.append(loss)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{label}: step {i} loss {loss} grad_norm {gnorm}")
        print(f"  {label} step {i}: loss {loss:.4f} grad_norm {gnorm:.4f} "
              f"wall {walls[-1] * 1e3:.1f} ms")
        if i == 0:
            no_moment = [k for k, mu in opt["mu"].items() if not bool((mu != 0).any())]
            if no_moment:
                fail(f"{label}: no gradient reached {no_moment[:4]}")
            print(f"  {label}: after step 1 every leaf's AdamW moment is nonzero ({len(named)} "
                  "leaves, the expert stacks and the float32 routers among them)")
    launches = kernels.launch_counts()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(walls[1:])
    active = active_params(cfg, params)
    flops = train_flops(cfg, params, tokens, TRAIN_SEQ)
    bound = flops / rates[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label}: step wall {med * 1e3:.1f} ms (median of steps 2-{MOE_TRAIN_STEPS}), "
          f"{tokens / med:.0f} tokens/s; model FLOPs {flops / 1e12:.2f} TFLOP (6 N_active T + "
          f"12 L d S T, N_active = {active / 1e9:.3f}B: the routed experts at top_k / E = "
          f"{cfg.top_k} / {cfg.n_experts}), bound {bound * 1e3:.1f} ms at "
          f"{rates[1] / 1e12:.0f} TFLOP/s: {bound / med:.3f} of it; losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"  {label}: peak memory allocated {peak:.2f} GiB, reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB ({n_params / 1e9:.3f}B "
          "parameters)")
    if label == "13f" and any(launches.values()):
        fail(f"13f: the dense step launched {launches}")
    wall, busy, fam = profile_once(torch, f"{label} step {MOE_TRAIN_STEPS + 1}",
                                   lambda: step(params, opt, batches[MOE_TRAIN_STEPS]),
                                   med * 1e3)
    grouped = fam.get(GROUPED_GEMM[0], 0.0)
    if grouped <= 0:
        fail(f"{label}: the profiled step shows no grouped product")
    print(f"  {label}: the grouped product (forward and backward, torch._grouped_mm) "
          f"{grouped:.1f} ms of the step's {busy:.1f} ms device busy: a share of "
          f"{grouped / busy:.3f}")
    del params, opt, named, model, step, batches
    free_device(torch, label)
    return {"step_s": med, "launches": launches, "peak_gib": peak,
            "grouped_share": grouped / busy}


def moe_train_gate(torch):
    """13h: Qwen3-30B-A3B at full width, depth 2, float32, 1 x 256 tokens:
    the kernel path's loss and gradients (q through ``PruneMatmul``, the
    routed experts' gate and down inputs through ``nm_prune``'s Function,
    the grouped product through ``torch._grouped_mm``) against the plain
    path's on the kernel path's N:M selections."""
    from repro_torch.core.policy import paper_policy
    from repro_torch.train import loss_fn, trainable_params

    cfg, model, params = train_model(torch, "qwen3_30b_a3b", 2, dtype="float32")
    named = trainable_params(params)
    gen = torch.Generator().manual_seed(SEED + 14)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 257), generator=gen).to(model.device)}
    policy = paper_policy(8, 16, ()).with_(phases=("train", "prefill"), use_kernels=True)

    def grads(pol):
        loss = loss_fn(model, params, batch, pol)
        return [loss.detach()] + list(torch.autograd.grad(loss, list(named.values())))

    got, want = forced_selection_logits(torch, grads, policy)
    check_close("13h loss (kernel path vs plain on its selections)", got[0], want[0], F32_TOL)
    worst, where = 0.0, ""
    for (k, _), g, w in zip(named.items(), got[1:], want[1:]):
        if not bool(g.isfinite().all()):
            fail(f"13h: gradient of {k} is not finite")
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if err > worst:
            worst, where = err, k
        if err > F32_TOL:
            fail(f"13h: gradient of {k}: max|diff| / max|g| = {err:.3e} > {F32_TOL}")
    stacks = sum(".moe.experts." in k for k in named)
    print(f"  13h: loss and {len(named)} gradients ({stacks} expert stacks, "
          f"{sum('.moe.router.' in k for k in named)} float32 routers) within {F32_TOL} of "
          f"the largest entry (worst {worst:.3e}, {where})")
    del params, model, named, got, want
    free_device(torch, "13h")


# 13i-13k: the recurrent and encoder-decoder families' training at full
# width, bf16: per arch (depth, None: the config's whole stacks; batch rows;
# decoder tokens a row).  RWKV6-7B at depth 4 (1.41B parameters: ~2.6 GiB
# of bf16 weights, as much in gradients, 10.5 GiB of float32 moments),
# RecurrentGemma-2B at its smoke pattern's depth 5 (a period and two rglru
# layers), Whisper-medium whole (24 + 24, 0.81B) over 2 x 1500 seeded
# frames: its encoder's float32 attention probabilities saved for the
# backward are ~7 GiB at B = 2 (24 layers x 2 x 16 heads x 1500²), and it
# has no remat (as the reference's encoder-decoder)
FAMILY_TRAIN = {"rwkv6_7b": (4, 4, 512), "recurrentgemma_2b": (5, 4, 512),
                "whisper_medium": (None, 2, 256)}
FAMILY_TRAIN_STEPS = 3
# 13k: the gradients' depth (RecurrentGemma-2B: one period, its attention
# layer included), float32, one row of FAMILY_GATE_T tokens
FAMILY_GATE_DEPTH = {"rwkv6_7b": 2, "recurrentgemma_2b": 3, "whisper_medium": 2}
FAMILY_GATE_T = 256
# what 13i/13j time apart as the family's own part of a step, by arch
FAMILY_PART = {"rwkv6_7b": "the WKV recurrence (wkv_chunked)",
               "recurrentgemma_2b": "the RG-LRU scan (_rglru_scan)",
               "whisper_medium": "the encoder (forward and backward over its frames)"}


def family_frames(torch, cfg, b, seed=SEED + 33):
    """``(b, encoder_seq, d_model)`` seeded frame embeddings on the card in
    the model dtype (an encoder-decoder's), else None."""
    if not cfg.is_encdec:
        return None
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(b, cfg.encoder_seq, cfg.d_model, generator=g,
                       device="cuda").to(getattr(torch, cfg.dtype))


def family_train_flops(cfg, params, b: int, t: int) -> float:
    """Model FLOPs of one train step (the PaLM convention of
    :func:`train_flops`): 6 N a token for the parameters each token's
    products meet (the embedding's lookup not counted), and 12 d S a token
    for each attention layer at the keys S it reads (RecurrentGemma-2B's
    window; Whisper-medium's encoder over its 1500 frames, its decoder's
    self-attention over T and cross-attention over the frames); a tied LM
    head counts as the embedding's size.  The recurrences' own products
    (WKV state updates, the RG-LRU's gates' elementwise terms) are not
    counted."""
    from repro_torch.models.transformer import layer_kinds

    if cfg.is_encdec:
        enc = sum(p.numel() for k, p in params.named_parameters() if k.startswith("enc_"))
        dec = sum(p.numel() for k, p in params.named_parameters()
                  if not k.startswith("enc_") and k != "embed.w")
        s = cfg.encoder_seq
        return (6.0 * enc * b * s + 6.0 * dec * b * t
                + 12.0 * cfg.n_encoder_layers * cfg.d_model * s * b * s
                + 12.0 * cfg.n_layers * cfg.d_model * (t + s) * b * t)
    attn = sum(kind == "attn" for kind in layer_kinds(cfg))
    keys = min(t, cfg.window) if cfg.window else t
    head = params.embed.w.numel() if cfg.tie_embeddings else 0   # a tied LM head's product
    return (6.0 * (active_params(cfg, params) + head) * b * t
            + 12.0 * attn * cfg.d_model * keys * b * t)


def family_train_launches(cfg, policy) -> int:
    """``nm_prune_matmul`` launches of one train forward under ``policy``:
    every pruned projection of every layer (:func:`prune_launches`; the
    encoder-decoder's q of its encoder, self- and cross-attention, fc1 and
    fc2 in every layer, :func:`_family_prefill_launches`)."""
    return _family_prefill_launches(cfg) if cfg.is_encdec else prune_launches(cfg, policy)[0]


def device_busy(torch, fn) -> float:
    """Device busy ms (the union of the kernels' intervals) of one call of
    ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return busy_time([(e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]) / 1e3


def family_part_busy(torch, cfg, model, params, batch, policy) -> float:
    """Device busy ms of the family's own part of one train step
    (``FAMILY_PART``), run apart on the step's shapes and counted as the
    step runs it: RWKV6's WKV and the RG-LRU scan a forward without grad
    (remat's first), a forward with grad and its backward, in every such
    layer, on inputs drawn like the step's (RWKV6's decays at its init's
    -exp(-4)); Whisper's encoder a forward and its backward (no remat)."""
    from repro_torch.models import encdec, rglru, rwkv6
    from repro_torch.models.transformer import layer_kinds

    g = torch.Generator(device="cuda").manual_seed(SEED + 34)
    b, t = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encdec:
        enc = [p for k, p in params.named_parameters() if k.startswith("enc_")]

        def part():
            out = encdec._encode(cfg, params, batch["frame_embeds"], policy, "train")
            torch.autograd.grad(out, enc, torch.ones_like(out))
        return device_busy(torch, part)
    kinds = layer_kinds(cfg)
    if cfg.block_pattern[0] == "rwkv6":
        hd, d = cfg.d_model // cfg.n_heads, cfg.d_model
        r, k, v = (torch.randn(b, t, d, generator=g, device="cuda").to(dt).requires_grad_()
                   for _ in range(3))
        lw = torch.full((b, t, d), -math.exp(-4.0), device="cuda").requires_grad_()
        u = torch.zeros(cfg.n_heads, hd, device="cuda").requires_grad_()
        s0 = torch.zeros(b, cfg.n_heads, hd, hd, device="cuda")
        fn, args, n = (lambda *a: rwkv6.wkv_chunked(*a, cfg.n_heads)[1]), (s0, r, k, v, lw, u), \
            kinds.count("rwkv6")
    else:
        w = cfg.rnn_width or cfg.d_model
        a = torch.rand(b, t, w, generator=g, device="cuda").requires_grad_()
        bx = torch.randn(b, t, w, generator=g, device="cuda").requires_grad_()
        h0 = torch.zeros(b, w, device="cuda")
        fn, args, n = rglru._rglru_scan, (a, bx, h0), kinds.count("rglru")

    wrt = [x for x in args if x.requires_grad]

    def part():
        for _ in range(n):
            with torch.no_grad():
                fn(*args)
            out = fn(*args)
            torch.autograd.grad(out, wrt, torch.ones_like(out))
    return device_busy(torch, part)


def family_train_run(torch, label, arch, rates, policy, profile=True):
    """13i / 13j for ``arch`` (``FAMILY_TRAIN``): ``FAMILY_TRAIN_STEPS`` steps
    on ``lm_batch`` (Whisper-medium: with seeded frames); ``profile``: one
    more step profiled, and the family's part apart (13i's: the profiler's
    event lists take seconds a step here, so 13j, whose work differs by its
    prunes, is timed alone); returns {step_s, launches, peak_gib, tokens_s,
    cfg}."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.train import OptConfig, adamw_init, make_train_step, trainable_params

    depth, b, t = FAMILY_TRAIN[arch]
    steps = FAMILY_TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = train_model(torch, arch, depth)
    named = trainable_params(params)
    n_params = sum(p.numel() for p in named.values())
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=t, global_batch=b)
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=steps)
    step = make_train_step(model, opt_cfg, policy)
    opt = adamw_init(named)
    frames = family_frames(torch, cfg, b)
    batches = [dict(lm_batch(data, i), **({} if frames is None else {"frame_embeds": frames}))
               for i in range(steps + 1)]
    walls, losses = [], []
    kernels.reset_launch_counts()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, m = step(params, opt, batches[i])[1:]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        losses.append(loss)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{label} {arch}: step {i} loss {loss} grad_norm {gnorm}")
        if i == 0:
            no_moment = [k for k, mu in opt["mu"].items() if not bool((mu != 0).any())]
            if no_moment:
                fail(f"{label} {arch}: no gradient reached {no_moment[:4]}")
    launches = kernels.launch_counts()
    tokens = b * t
    med = statistics.median(walls[1:])
    flops = family_train_flops(cfg, params, b, t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    enc = f" + {cfg.n_encoder_layers}" if cfg.is_encdec else ""
    print(f"  {label} {cfg.name} depth {cfg.n_layers}{enc} "
          f"({n_params / 1e9:.3f}B parameters), {b} x {t} tokens"
          f"{f' over {b} x {cfg.encoder_seq} frames' if cfg.is_encdec else ''}: step wall "
          f"{med * 1e3:.1f} ms (median of steps 2-{steps}), {tokens / med:.0f} tokens/s; model "
          f"FLOPs {flops / 1e12:.3f} TFLOP, a share of {flops / (med * rates[1]):.3f} of the "
          f"wall at {rates[1] / 1e12:.0f} TFLOP/s; peak {peak:.2f} GiB allocated, "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} reserved; losses "
          f"{[round(x, 4) for x in losses]}; every leaf's AdamW moment nonzero after step 1")
    if profile:
        busy = device_busy(torch, lambda: step(params, opt, batches[steps]))
        part = family_part_busy(torch, cfg, model, params, batches[steps], policy)
        print(f"  {label} {cfg.name}: one step profiled, device busy {busy:.1f} ms (idle share "
              f"{max(0.0, 1 - busy / (med * 1e3)):.3f} of the median wall); "
              f"{FAMILY_PART[arch]} run apart at the step's shapes, as often as the step runs "
              f"it: {part:.1f} ms busy, {part / busy:.3f} of the step's")
    del params, opt, named, model, step, batches, frames
    free_device(torch, f"{label} {arch}")
    return {"step_s": med, "launches": launches, "peak_gib": peak, "tokens_s": tokens / med,
            "cfg": cfg}


def family_gradient_gate(torch, arch):
    """13k for ``arch``: full width, depth ``FAMILY_GATE_DEPTH``, float32,
    1 x ``FAMILY_GATE_T`` tokens (Whisper-medium over 1 x 1500 seeded
    frames): the kernel path's loss and every gradient (``PruneMatmul``)
    within ``F32_TOL`` of the plain path's on the kernel path's N:M
    selections, remat's recompute included."""
    from repro_torch.core.policy import paper_policy
    from repro_torch.train import loss_fn, trainable_params

    cfg, model, params = train_model(torch, arch, FAMILY_GATE_DEPTH[arch], dtype="float32")
    named = trainable_params(params)
    gen = torch.Generator().manual_seed(SEED + 15)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, FAMILY_GATE_T + 1),
                                     generator=gen).to(model.device)}
    frames = family_frames(torch, cfg, 1)
    if frames is not None:
        batch["frame_embeds"] = frames
    policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(phases=("train", "prefill"),
                                                              use_kernels=True)

    def grads(pol):
        loss = loss_fn(model, params, batch, pol)
        return [loss.detach()] + list(torch.autograd.grad(loss, list(named.values())))

    got, want = forced_selection_logits(torch, grads, policy)
    check_close(f"13k {arch} loss (kernel path vs plain on its selections)", got[0], want[0],
                F32_TOL)
    worst, where = 0.0, ""
    for (k, _), g, w in zip(named.items(), got[1:], want[1:]):
        if not bool(g.isfinite().all()):
            fail(f"13k {arch}: gradient of {k} is not finite")
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if err > worst:
            worst, where = err, k
        if err > F32_TOL:
            fail(f"13k {arch}: gradient of {k}: max|diff| / max|g| = {err:.3e} > {F32_TOL}")
    print(f"  13k {cfg.name} depth {cfg.n_layers}: loss and {len(named)} gradients within "
          f"{F32_TOL} of the largest entry (worst {worst:.3e}, {where})")
    del params, model, named, got, want
    free_device(torch, f"13k {arch}")


def phase_family_training(torch, rates):
    """13i-13k (after 13h): the recurrent and encoder-decoder families'
    training.  Returns the launches of each 13j run by label."""
    from repro_torch.core.policy import DENSE, paper_policy

    out = {}
    for arch in FAMILY_TRAIN:
        dense = family_train_run(torch, "13i", arch, rates, DENSE)
        if any(dense["launches"].values()):
            fail(f"13i {arch}: the dense step launched {dense['launches']}")
        cfg = dense["cfg"]
        policy = paper_policy(8, 16, cfg.qgate_skip_layers).with_(
            phases=("train", "prefill"), use_kernels=True)
        sparse = family_train_run(torch, "13j", arch, rates, policy, profile=False)
        twice = cfg.remat and not cfg.is_encdec     # the encoder-decoder has no remat
        per_step = family_train_launches(cfg, policy) * (2 if twice else 1)
        check_launches(f"13j {arch}", sparse["launches"], {
            "nm_prune_matmul": per_step * FAMILY_TRAIN_STEPS, "nm_prune": 0,
            "paged_kv_scatter": 0, "paged_attention": 0, "nm_spmm": 0, "flash_attention": 0,
            "osparse_matmul": 0, "w8a8_matmul": 0})
        print(f"  13j {cfg.name}: {per_step} nm_prune_matmul a step"
              f"{' (remat runs each forward twice)' if twice else ' (no remat)'}, exact; step "
              f"wall {sparse['step_s'] * 1e3:.1f} ms against 13i's "
              f"{dense['step_s'] * 1e3:.1f} ms ({sparse['step_s'] / dense['step_s']:.3f}x)")
        out[f"13j {arch}"] = sparse["launches"]
    t0 = time.perf_counter()
    for arch in FAMILY_TRAIN:
        family_gradient_gate(torch, arch)
    SUBPHASE_SECONDS["13k"] = time.perf_counter() - t0
    return out


def phase_training(torch, rates):
    """Phase 13 (module docstring).  Returns {"13b": launches, "13g": launches}."""
    from repro_torch.core.policy import DENSE, paper_policy

    print(f"phase 13: training, LLaMA-3.1-8B at full width and depth {TRAIN_DEPTH}, bf16")
    from repro_torch.configs import get_config

    dense = train_run(torch, "13a", rates, DENSE)
    skips = get_config("llama31_8b").qgate_skip_layers
    if min(skips) < TRAIN_DEPTH:
        fail(f"13b: the skip list {skips} reaches below depth {TRAIN_DEPTH}")
    sparse = train_run(torch, "13b", rates, paper_policy(8, 16, skips).with_(
        phases=("train", "prefill"), use_kernels=True))
    want = 2 * 3 * TRAIN_DEPTH * TRAIN_STEPS     # q, gate, down; remat runs each twice
    check_launches("13b", sparse["launches"], {
        "nm_prune_matmul": want, "nm_prune": 0, "paged_kv_scatter": 0, "paged_attention": 0,
        "nm_spmm": 0, "flash_attention": 0, "osparse_matmul": 0, "w8a8_matmul": 0})
    print(f"  13b: {want // TRAIN_STEPS} nm_prune_matmul a step ({3 * TRAIN_DEPTH} a forward, "
          f"remat's second forward as many; the backward launches none); step wall "
          f"{sparse['step_s'] * 1e3:.1f} ms against 13a's {dense['step_s'] * 1e3:.1f} ms "
          f"({sparse['step_s'] / dense['step_s']:.3f}x)")
    train_gradient_gate(torch)
    free_device(torch, "13c")
    train_crash_resume(torch)
    train_cli(torch)
    t0 = time.perf_counter()
    print(f"phase 13f-13h: training Qwen3-30B-A3B at full width and depth {MOE_TRAIN_DEPTH}, "
          f"bf16, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, {MOE_TRAIN_STEPS} steps, remat")
    # DENSE on the card's routes: no prune is active, the grouped product is
    # torch._grouped_mm (use_kernels=False would take the per-expert loop)
    moe_dense = moe_train_run(torch, "13f", rates, DENSE.with_(use_kernels=True))
    moe_sparse = moe_train_run(torch, "13g", rates, paper_policy(8, 16, ()).with_(
        phases=("train", "prefill"), use_kernels=True))
    # q (PruneMatmul) and the expert gate and down inputs (Prune) a layer;
    # remat runs each forward twice
    per_step = 2 * MOE_TRAIN_DEPTH
    check_launches("13g", moe_sparse["launches"], {
        "nm_prune_matmul": per_step * MOE_TRAIN_STEPS,
        "nm_prune": 2 * per_step * MOE_TRAIN_STEPS, "paged_kv_scatter": 0,
        "paged_attention": 0, "nm_spmm": 0, "flash_attention": 0, "osparse_matmul": 0,
        "w8a8_matmul": 0})
    print(f"  13g: {per_step} nm_prune_matmul and {2 * per_step} nm_prune a step (1 and 2 a "
          f"layer a forward, remat's second forward as many; the backwards launch none); step "
          f"wall {moe_sparse['step_s'] * 1e3:.1f} ms against 13f's "
          f"{moe_dense['step_s'] * 1e3:.1f} ms ({moe_sparse['step_s'] / moe_dense['step_s']:.3f}"
          "x)")
    t1 = time.perf_counter()
    moe_train_gate(torch)
    t2 = time.perf_counter()
    print(f"phase 13f-13h seconds: 13f and 13g {t1 - t0:.1f}, 13h {t2 - t1:.1f}")
    print(f"phase 13i-13k: training RWKV6-7B, RecurrentGemma-2B and Whisper-medium at full "
          f"width, bf16, {FAMILY_TRAIN_STEPS} steps each ({FAMILY_TRAIN}: depth, batch, "
          "tokens), DENSE (13i) and --sparse-train (13j); 13k their gradients in float32")
    family = phase_family_training(torch, rates)
    SUBPHASE_SECONDS["13i-13k"] = time.perf_counter() - t2     # 13k's also apart
    return {"13b": sparse["launches"], "13g": moe_sparse["launches"], **family}


# ------------------------------------------------------ tensor parallelism
TP_DEPTH = 2                # LLaMA-3.1-8B's layers in 14b and 14c (of 32; 16 until phase 16,
                            # 8 until 15d/15e, 4 until 13f-13h and 15f)
# 14d: the CLI at the smoke size (14b and 14c serve the full width)
TP_CLI_FLAGS = ["--arch", "llama31_8b", "--smoke", "--trace", "--num-requests", "6",
                "--len-range", "6:40", "--slots", "2", "--chunk", "16", "--new-tokens", "8",
                "--sparsity", "8:16"]


def shards_equal(torch, label, full, shards, plan=None, own=None):
    """The shards concatenated along the last (column) or head axis against
    the unsharded launch: bit-identical, or the phase fails.  ``plan``: the
    unsharded call's, which every shard took; ``own``: the plan a shard
    would have picked alone."""
    torch.cuda.synchronize()
    got = torch.cat(shards, dim=1 if full.dim() == 2 else 2)
    same = torch.equal(got, full)
    plans = ("" if plan is None else f"shards on the full call's plan {tuple(plan)}, alone "
             f"a shard would take {tuple(own)}; ")
    print(f"  {label}: {plans}concatenated bit-identical={same}")
    if not same:
        fail(f"phase 14a: {label}: the shards differ from the unsharded launch")


def tp_kernel_shards(torch):
    """Phase 14a: each sharded entry point at LLaMA-3.1-8B's shapes, at tp = 2
    and 4, every rank's shard computed in this process on the unsharded
    call's plan (as ``kernels.ops`` and ``models.attention`` hand it under a
    TP scope), against the unsharded launch."""
    from repro_torch.core import quant
    from repro_torch.distributed.tp import shard_columns
    from repro_torch.kernels import nm_prune_matmul as knm
    from repro_torch.kernels import nm_spmm as kns
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import w8a8_matmul as kw8

    print("phase 14a: the sharded entry points at LLaMA-3.1-8B shapes, tp = 2 and 4: each "
          "rank's shard on the unsharded call's plan, in this process, against the "
          "unsharded launch")
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).bfloat16()

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev).to(torch.int8)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, d, n_out in (("q", 4096, 4096), ("gate", 4096, 14336), ("down", 14336, 4096)):
        x, w = randn(256, d), randn(d, n_out, scale=d**-0.5)
        sc = torch.rand(d, generator=g, device=dev) + 0.5
        plan = knm.gemm_plan(w, 256)
        full = knm.nm_prune_matmul(x, w, sc, 8, 16)
        wq = quant.k_major(int8(d, n_out))
        smooth = torch.rand(d, generator=g, device=dev) + 0.5
        amber = torch.rand(d, generator=g, device=dev) + 0.5
        ws = torch.rand(n_out, generator=g, device=dev) * 1e-3
        act = torch.full((1,), 0.02, device=dev)
        for tp in (2, 4):
            cols = [shard_columns(w, r, tp) for r in range(tp)]
            shards_equal(torch, f"nm_prune_matmul {name} {d}x{n_out} T=256 tp={tp}", full,
                         [knm.nm_prune_matmul(x, c, sc, 8, 16, plan=plan) for c in cols],
                         (plan,), (knm.gemm_plan(cols[0], 256),))
            qcols = [(shard_columns(wq, r, tp), shard_columns(ws, r, tp)) for r in range(tp)]
            if qcols[1][0].data_ptr() != wq.data_ptr() + d * (n_out // tp):
                fail("phase 14a: a K-major wq's column shard is not a view")
            for t, prune in ((256, True), (4, False)):
                xt = x[:t].contiguous()
                op = kos.call_plan(xt, wq, smooth, amber, 16, prune, False)
                shards_equal(
                    torch, f"osparse_matmul {name} T={t} prune={prune} tp={tp}",
                    kos.osparse_matmul(xt, wq, smooth, amber, ws, 8, 16, act_scale=act,
                                       prune=prune),
                    [kos.osparse_matmul(xt, c, smooth, amber, s, 8, 16, act_scale=act,
                                        prune=prune, plan=op) for c, s in qcols],
                    op, kos.call_plan(xt, qcols[0][0], smooth, amber, 16, prune, False))
    # nm_spmm and w8a8_matmul at phase 2's shapes (2h, 2e)
    for name, d, n_out in QWEN_SPARSE_PROJS:
        x, w = randn(2048, d), randn(d, n_out, scale=d**-0.5)
        plan = kns.gemm_plan(x.dtype, 2048, d, n_out, 8, 16, 256, True, sms)
        full = kns.nm_spmm(x, w, None, 8, 16)
        for tp in (2, 4):
            shards_equal(torch, f"nm_spmm Qwen2-7B {name} T=2048 tp={tp}", full,
                         [kns.nm_spmm(x, shard_columns(w, r, tp), None, 8, 16, plan=plan)
                          for r in range(tp)], plan,
                         kns.gemm_plan(x.dtype, 2048, d, n_out // tp, 8, 16, 256, True, sms))
    for t, d, n_out in ((256, 4096, 14336), (4, 4096, 1024)):
        xq, wq = int8(t, d), quant.k_major(int8(d, n_out))
        ws = torch.rand(n_out, generator=g, device=dev) * 1e-3
        xs = torch.full((1,), 0.013, device=dev)
        plan = kw8.call_plan(xq, wq)
        full = kw8.w8a8_matmul(xq, wq, xs, ws)
        for tp in (2, 4):
            cols = [(shard_columns(wq, r, tp), shard_columns(ws, r, tp)) for r in range(tp)]
            shards_equal(torch, f"w8a8_matmul {t}x{d}x{n_out} tp={tp}", full,
                         [kw8.w8a8_matmul(xq, c, xs, s, plan=plan) for c, s in cols], plan,
                         kw8.call_plan(xq, cols[0][0]))
    # paged attention and the scatter: 32 / 8 heads of 128, blocks of 16
    mb, bs = 48, 16
    kp, vp = randn(4 * mb + 1, bs, 8, 128), randn(4 * mb + 1, bs, 8, 128)
    tab = torch.arange(4 * mb, dtype=torch.int32, device=dev).reshape(4, mb)

    def heads(t, r, tp):
        h = t.shape[2] // tp
        return t[:, :, r * h:(r + 1) * h].contiguous()

    i32 = dict(dtype=torch.int32, device=dev)
    for case, b, tq, qo in (("chunk", 1, 256, [444]), ("decode", 4, 1, [700, 513, 64, 1])):
        q = randn(b, tq, 32, 128)
        qo_t = torch.tensor(qo, **i32)
        kvl = qo_t + tq
        plan = kpa.call_plan(q, kp, vp, tab[:b])
        full = kpa.paged_attention(q, kp, vp, tab[:b], qo_t, kvl, causal=tq > 1)
        for tp in (2, 4):
            parts = [(heads(q, r, tp), heads(kp, r, tp), heads(vp, r, tp)) for r in range(tp)]
            shards_equal(torch, f"paged_attention {case} B={b} Tq={tq} tp={tp}", full,
                         [kpa.paged_attention(qq, kk, vv, tab[:b], qo_t, kvl, causal=tq > 1,
                                              plan=plan) for qq, kk, vv in parts], plan,
                         kpa.call_plan(*parts[0], tab[:b]))
    kn, vn = randn(1, 256, 8, 128), randn(1, 256, 8, 128)
    pos, clen = torch.tensor([300], **i32), torch.tensor([256], **i32)
    kp_full, vp_full = kp.clone(), vp.clone()
    kpa.paged_kv_scatter(kn, vn, kp_full, vp_full, tab[:1], pos, clen)
    for tp in (2, 4):
        pools = [(heads(kp, r, tp), heads(vp, r, tp)) for r in range(tp)]
        for r, (k_r, v_r) in enumerate(pools):
            kpa.paged_kv_scatter(heads(kn, r, tp), heads(vn, r, tp), k_r, v_r, tab[:1], pos,
                                 clen)
        for leaf, full, i in (("k", kp_full, 0), ("v", vp_full, 1)):
            shards_equal(torch, f"paged_kv_scatter of a 256-row chunk into each rank's {leaf} "
                         f"pool tp={tp}", full, [p[i] for p in pools])


def gather_steps(ex):
    """Record, per step program of the executor ``ex``, its calls, the
    gathers and gathered bytes of ``distributed.tp.gather`` and its wall
    seconds (eager steps: the host waits on every gather); filled as the
    engine runs.  Holds the executor weakly, as :func:`program_shapes`."""
    import weakref

    from repro_torch.distributed import tp

    steps = {}
    real, ref = type(ex)._run, weakref.ref(ex)

    def run(params, plan, name, fault, extras=None):
        c0, b0, t0 = tp.gather.calls, tp.gather.bytes, time.perf_counter()
        out = real(ref(), params, plan, name, fault, extras)
        st = steps.setdefault(name, dict(calls=0, gathers=0, bytes=0, seconds=0.0))
        st["calls"] += 1
        st["gathers"] += tp.gather.calls - c0
        st["bytes"] += tp.gather.bytes - b0
        st["seconds"] += time.perf_counter() - t0
        return out

    ex._run = run
    return steps


def tp_serve_rank(n_layers: int):
    """One of 14b's and 14c's two ranks: LLaMA-3.1-8B at ``n_layers`` with
    phase 3's weights and policy serves phase 3's stream through ``Engine``
    at tp = 2 (14b), then, rewritten in place as 3b rewrites them, 3b's
    stream (14c).  No warm-up: every step is eager, so a bucket's first
    step costs what the others do.  Returns, for every rank, each run's
    record (tokens, launches counted from 0 over the stream, gathers by
    step program, memory), gathered to every rank."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.serve import Engine, EngineConfig

    numerics(torch)
    t0 = time.perf_counter()
    cfg, model, params, policy = dense_model(torch, "llama31_8b", n_layers)
    records = {}
    for label in ("14b", "14c"):
        if label == "14c":
            t0 = time.perf_counter()
            w8a8_rewrite(cfg, params)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        _, prompts, arrivals, new, scfg = serving_stream(torch, cfg.vocab_size)
        eng = Engine.from_config(model, EngineConfig(tp=2, serving=scfg), policy=policy)
        ex = eng.replica.exec
        steps = gather_steps(ex)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        rids = [eng.submit(p, max_new_tokens=new, arrival=a)
                for p, a in zip(prompts, arrivals)]
        t1 = time.perf_counter()
        res = eng.run(params)
        torch.cuda.synchronize()
        records[label] = dict(
            rank=dist.get_rank(), outputs=[res["outputs"][r] for r in rids],
            launches=kernels.counters(), steps=steps, buckets=res["metrics"]["buckets"],
            trace_counts=dict(eng.replica.trace_counts), wall=time.perf_counter() - t1,
            built=built, captures=ex._graphs.capture,
            pool_heads=ex.cache["layers"][0]["k"].shape[2],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            reserved_gib=torch.cuda.max_memory_reserved() / 2**30,
            dpi=res["metrics"]["dispatches_per_iteration"])
        del eng, ex
        torch.cuda.empty_cache()
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, records)
    return everyone


def tp_reference(torch):
    """14b's and 14c's tokens at tp = 1: phase 3's weights, policy and
    stream at ``TP_DEPTH`` layers served by this process through ``Engine``
    (graphs), then 3b's W8A8 rewrite of them and its stream."""
    from repro_torch.serve import Engine, EngineConfig

    cfg, model, params, policy = dense_model(torch, "llama31_8b", TP_DEPTH)
    out = []
    for quantized in (False, True):
        if quantized:
            w8a8_rewrite(cfg, params)
        _, prompts, arrivals, new, scfg = serving_stream(torch, cfg.vocab_size)
        eng = Engine.from_config(model, EngineConfig(serving=scfg), policy=policy)
        rids = [eng.submit(p, max_new_tokens=new, arrival=a) for p, a in zip(prompts, arrivals)]
        res = eng.run(params)
        out.append([res["outputs"][r] for r in rids])
        del eng
    del model, params
    free_device(torch, "14b/14c's tp = 1 references")
    return out


def tp_serve(torch):
    """14b and 14c: two ranks on this card over gloo (``launch.mesh.spawn``)
    serve LLaMA-3.1-8B at full width and ``TP_DEPTH`` layers, in bf16 and
    then in W8A8; every request's tokens must equal the same model's at
    tp = 1 (:func:`tp_reference`: phase 3's and 3b's stream, weights and
    policy at that depth) on both ranks, the launches and gathers of each
    rank exact.  Returns rank 0's launch counts by run."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    want3, want3b = tp_reference(torch)
    print(f"phase 14b / 14c: tp = 1 references at depth {TP_DEPTH} served in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = dataclasses.replace(get_config("llama31_8b"), n_layers=TP_DEPTH)
    policy = paper_policy(8, 16, cfg.qgate_skip_layers)
    print(f"phase 14b / 14c: LLaMA-3.1-8B at full width, depth {TP_DEPTH} of 32, "
          f"paper_policy(8, 16) with the kernels, phase 3's weights and stream (14b), then "
          f"3b's W8A8 rewrite of them and its stream (14c), at tp = 2: two ranks on cuda:0 "
          f"over gloo, eager steps ({nvidia_smi_line()})")
    t0 = time.perf_counter()
    ranks = spawn(tp_serve_rank, 2, TP_DEPTH, device="cuda")
    print(f"  spawned, built, served and joined in {time.perf_counter() - t0:.1f} s")
    fused, _ = prune_launches(cfg, policy)
    pruned_q = sum(policy.should_prune(mod, i) for i in range(cfg.n_layers)
                   for mod in ("q_proj", "gate_proj"))
    layers = cfg.n_layers
    runs = {}
    for label, want, of in (("14b", want3, "tp = 1's"), ("14c", want3b, "tp = 1's W8A8")):
        for me in (records[label] for records in ranks):
            r = me["rank"]
            check_tokens(f"phase {label} rank {r}", me["outputs"], want, of)
            if me["captures"] or me["pool_heads"] != cfg.n_kv_heads // 2 or me["dpi"] != 1.0:
                fail(f"phase {label} rank {r}: captures {me['captures']}, pool heads "
                     f"{me['pool_heads']}, dispatches/iteration {me['dpi']}")
            if any(n != 1 for n in me["trace_counts"].values()):
                fail(f"phase {label} rank {r}: trace_counts {me['trace_counts']}")
            _, _, st = step_counts(me["buckets"], fused=True)
            halves = st["prefill_halves"] + st["decode_halves"]
            if label == "14c":   # q/k/v/o/gate/up in W8A8; down bf16 on nm_prune_matmul
                want_l = {"osparse_matmul": len(QPROJS) * layers * halves,
                          "osparse_matmul.pruned": pruned_q * st["sparse_chunks"],
                          "nm_prune_matmul": layers * st["sparse_chunks"]}
                per_chunk, per_decode = (len(QPROJS) + 2) * layers, (len(QPROJS) + 1) * layers
            else:
                want_l = {"nm_prune_matmul": fused * st["sparse_chunks"], "osparse_matmul": 0}
                per_chunk, per_decode = fused + layers, layers
            want_l.update(paged_kv_scatter=layers * halves, paged_attention=layers * halves,
                          nm_prune=0, nm_spmm=0, flash_attention=0)
            check_launches(f"phase {label} rank {r}", me["launches"], want_l)
            steps = me["steps"]
            for name, per in (("step_prefill", per_chunk), ("step_decode", per_decode),
                              ("step_prefill_decode", per_chunk + per_decode)):
                got = steps[name]["gathers"] / steps[name]["calls"]
                if got != per:
                    fail(f"phase {label} rank {r}: {got} gathers a {name} step, expected {per}")
            pf, dec = steps["step_prefill"], steps["step_decode"]
            print(f"  {label} rank {r}: weights built in {me['built']:.1f} s; stream "
                  f"{me['wall']:.2f} s; peak {me['peak_gib']:.2f} GiB allocated, "
                  f"{me['reserved_gib']:.2f} GiB reserved; pools hold {me['pool_heads']} of "
                  f"{cfg.n_kv_heads} KV heads; a chunk alone (step_prefill, {pf['calls']} "
                  f"calls): {per_chunk} gathers, {pf['bytes'] / pf['calls'] / 2**20:.2f} MiB "
                  f"gathered, {1e3 * pf['seconds'] / pf['calls']:.1f} ms eager wall; a decode "
                  f"step (step_decode, {dec['calls']} calls): {per_decode} gathers, "
                  f"{dec['bytes'] / dec['calls'] / 2**20:.3f} MiB, "
                  f"{1e3 * dec['seconds'] / dec['calls']:.1f} ms eager wall")
            print(f"  {label} rank {r}: launches {me['launches']}; steps {json.dumps(steps)}")
        runs[label] = {k: v for k, v in ranks[0][label]["launches"].items() if "." not in k}
    return runs


def tp_cli(torch):
    """14d: ``python -m repro_torch.launch.serve --tp 2`` on the card (the
    smoke LLaMA-3.1 config: 14b and 14c serve the full width) exits 0 with
    the ``--tp 1`` run's tokens (the report's digest); ``--tp 1`` runs in
    this process, ``--tp 2`` as a command (its ranks print to its output)."""
    import os

    def digest(out):
        return next(x for x in out.splitlines() if x.startswith("# tokens:"))

    one = digest(run_cli(torch, TP_CLI_FLAGS + ["--tp", "1"], "phase 14d")[0])
    argv = [sys.executable, "-m", "repro_torch.launch.serve", *TP_CLI_FLAGS, "--tp", "2"]
    print(f"phase 14d: python -m repro_torch.launch.serve {' '.join(argv[3:])}")
    t0 = time.perf_counter()
    r = subprocess.run(argv, env=dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parent / "src")), capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        print(r.stdout[-4000:], r.stderr[-4000:])
        fail(f"phase 14d: --tp 2 exited {r.returncode}")
    for x in r.stdout.splitlines():
        if x.startswith("#"):
            print(f"  {x}")
    print(f"  rc 0 in {time.perf_counter() - t0:.1f} s")
    if digest(r.stdout) != one:
        fail(f"phase 14d: --tp 2 served other tokens than --tp 1: {digest(r.stdout)} / {one}")
    print(f"  phase 14d: --tp 2 tokens identical to --tp 1's ({one})")


def phase_tp(torch):
    """Phase 14 (after 13 freed its models): 14a, 14b, 14c, 14d.  Returns
    14b's and 14c's rank-0 launches."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_kernel_shards(torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    runs = tp_serve(torch)
    t2 = time.perf_counter()
    tp_cli(torch)
    print(f"phase 14 seconds: 14a {t1 - t0:.1f}, 14b and 14c {t2 - t1:.1f}, "
          f"14d {time.perf_counter() - t2:.1f}")
    return runs



# ------------------------------------------------------------ sharded cells
# 15a: Qwen3-30B-A3B at full width and depth, prefill_32k cut to B x T (its
# 32 x 32768 would hold a 24 GiB cache a rank and take minutes over gloo)
CELL_MOE_BT = (2, 1024)
CELL_DEPTH = 4              # 15a's parity depth
CELL_DENSE_DEPTH = 2        # 15b's and 15c's (4 until the recurrent and enc-dec cells came)
# 15b: LLaMA-3.1-8B's train cell: batch, tokens, grad_accum, steps (train_4k
# is 256 x 4096; 3 steps and a checkpoint after 2 until the recurrent and
# enc-dec cells came, 2 steps and a checkpoint after 1 until 15g took the
# checkpoint)
CELL_TRAIN = (4, 512, 2, 1)
# 15g: the recurrent and encoder-decoder train cells at full width in phase
# 15's spawn: per arch (record key, depth, batch, decoder tokens, grid),
# CELL_FAMILY_STEPS steps each, OptConfig(3e-4, warmup 2), grad_accum 1;
# RecurrentGemma-2B at one period (its attention layer, whose 10 / 1 heads
# the model axis does not split, included); Whisper-medium (2 + 2 layers)
# over 2 x 1500 seeded frames on (data 2, model 1), checkpointed whole after
# CELL_CKPT_AT steps and restored in one process (the elastic check, 15b's
# until 15g: 2.6 GiB against 15b's 13.9)
CELL_FAMILY_TRAIN = {"rwkv6_7b": ("gr", 2, 2, 512, (1, 2)),
                     "recurrentgemma_2b": ("gg", 3, 2, 512, (1, 2)),
                     "whisper_medium": ("gw", 2, 2, 256, (2, 1))}
CELL_FAMILY_STEPS = 2
CELL_CKPT_AT = 1
CELL_TRAIN_RTOL = 2e-3      # 15b, 15f: bf16 gradients summed over two ranks
# 15f: Qwen3-30B-A3B's train cell at depth CELL_DENSE_DEPTH on (data 1, model
# 2): batch, tokens, steps (train_4k is 256 x 4096), grad_accum 1
CELL_MOE_TRAIN = (2, 512, 2)
# 15c: LLaMA-3.1-8B's decode cell: batch, cache depth, greedy steps
CELL_DECODE = (4, 4096, 2)
# 15d / 15e: the recurrent and encoder-decoder cells at full width on (data
# 1, model 2), paper_policy(8, 16, ()) with the kernels in prefill: per
# arch (depth, None: the config's; prefill B x T; decode B, cache depth,
# greedy steps; whether its decode parity is held at float32, depth
# CELL_F32_DEPTH).  RWKV6-7B at phase 11a's depth; Whisper-medium whole (24
# + 24 layers, 0.81B parameters), prefill T decoder tokens over 1500 frames
CELL_FAMILIES = {"rwkv6_7b": ("15d", 8, (2, 1024), (4, 4096, 2), False),
                 "whisper_medium": ("15e", None, (2, 256), (4, 512, 2), True)}
CELL_F32_DEPTH = 2
# 15d / 15e: the most a rank may hold of one rank's state (the weights the
# specs replicate: norms, token-shift mixes, Whisper's LM head of an odd
# vocabulary; the states held on batch only)
CELL_HELD_SHARE = 0.6


def phase_cell_kernels(torch, timer, rates, records):
    """2p: ``nm_prune`` at the slot tensors 15a's ``_moe_shard_map`` prunes:
    ``(E·C, 2048)``, the gate input, and ``(E·C, 384)``, a rank's down input
    (E = 128 experts, C the capacity of 2048 tokens routed 8 ways), no
    scale, bit-exact, timed beside its bound, its plain version and
    ``x.clone()`` (no single library call does the same)."""
    from repro_torch.kernels import nm_prune as knp
    from repro_torch.models.moe import capacity

    bw = rates[0]
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    keep = functools.partial(keep_case, records)
    rows = 128 * capacity(CELL_MOE_BT[0] * CELL_MOE_BT[1], 8, 128)
    print(f"phase 2p: nm_prune at 15a's slot tensors ({rows} = 128 experts x "
          f"{rows // 128} slots), no scale")
    for name, d in (("slot gate input", 2048), ("slot down input (a rank's)", 384)):
        x = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
        if not torch.equal(knp.nm_prune(x, None, 8, 16), knp.nm_prune_plain(x, None, 8, 16)):
            fail(f"nm_prune {name}: kernel and plain version differ")
        ms = timer.ms(lambda: knp.nm_prune(x, None, 8, 16))
        plain_ms = timer.ms(lambda: knp.nm_prune_plain(x, None, 8, 16), 5)
        copy_ms = timer.ms(x.clone)
        bound = 2 * x.numel() * 2 / bw * 1e3
        print(f"  {name} {rows} x {d}: bit-exact; kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes), plain {plain_ms:.4f} ms, x.clone() {copy_ms:.4f} ms")
        keep("nm_prune", f"15a {name}", 0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
             bound_ms=bound, bound_by="bytes", clone_ms=copy_ms)


def _gib(n_bytes) -> float:
    return n_bytes / 2**30


def _local_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _mask_spy(moe_lib, layers: int):
    """Record the N:M keep-masks of the first ``layers`` layers' expert
    inputs (the pruned gate input, then the down input, each layer); returns
    (the list, a function that restores ``_maybe_prune``)."""
    seen, orig = [], moe_lib._maybe_prune

    def spy(x, module, policy, phase):
        out = orig(x, module, policy, phase)
        if module != "up_proj" and len(seen) < 2 * layers:
            seen.append((out != 0).cpu())
        return out

    moe_lib._maybe_prune = spy
    return seen, lambda: setattr(moe_lib, "_maybe_prune", orig)


def _reset_counts(torch):
    from repro_torch import kernels
    from repro_torch.distributed import sharding, tp
    from repro_torch.models import moe

    kernels.reset_launch_counts()
    for v in sharding.collectives.values():
        v[:] = [0, 0]
    tp.gather.calls = tp.gather.bytes = 0
    moe.shard_map_stats.update(calls=0, pairs=0, dropped=0, capacity=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _counts(torch):
    from repro_torch import kernels
    from repro_torch.launch import dryrun
    from repro_torch.models import moe

    torch.cuda.synchronize()
    return dict(launches=kernels.counters(), moe=dict(moe.shard_map_stats),
                collectives=dryrun._tallies(), peak_gib=_gib(torch.cuda.max_memory_allocated()))


def _moe_cell(mesh, n_layers):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.policy import paper_policy
    from repro_torch.launch.cells import build_cell

    cfg = dataclasses.replace(get_config("qwen3_30b_a3b"), n_layers=n_layers)
    b, t = CELL_MOE_BT
    return build_cell("qwen3_30b_a3b", "prefill_32k", mesh, cfg=cfg,
                      policy=paper_policy(8, 16, (41, 46, 47), use_kernels=True),
                      shape=ShapeCell("prefill_32k", t, b, "prefill"))


def _train_cell(mesh):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell
    from repro_torch.train import OptConfig

    b, t, ga, steps = CELL_TRAIN
    cfg = dataclasses.replace(get_config("llama31_8b"), n_layers=CELL_DENSE_DEPTH)
    return build_cell("llama31_8b", "train_4k", mesh, cfg=cfg, grad_accum=ga,
                      shape=ShapeCell("train_4k", t, b, "train"),
                      opt_cfg=OptConfig(lr=3e-4, warmup_steps=2, total_steps=steps))


def _decode_cell(mesh):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell

    b, s, _ = CELL_DECODE
    cfg = dataclasses.replace(get_config("llama31_8b"), n_layers=CELL_DENSE_DEPTH)
    return build_cell("llama31_8b", "decode_32k", mesh, cfg=cfg,
                      shape=ShapeCell("decode_32k", s, b, "decode"))


def _family_cell(mesh, arch, kind, f32=False):
    """15d / 15e's cell of ``arch`` (``CELL_FAMILIES``): prefill or decode;
    ``f32``: in float32 at depth ``CELL_F32_DEPTH``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.policy import paper_policy
    from repro_torch.launch.cells import build_cell

    _, depth, (b, t), (db, ds, _), _ = CELL_FAMILIES[arch]
    cfg = get_config(arch)
    if f32:
        depth = CELL_F32_DEPTH
        cfg = dataclasses.replace(cfg, dtype="float32", n_encoder_layers=min(
            cfg.n_encoder_layers, depth))
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    if kind == "prefill":
        return build_cell(arch, "prefill_32k", mesh, cfg=cfg,
                          policy=paper_policy(8, 16, (), use_kernels=True),
                          shape=ShapeCell("prefill_32k", t, b, "prefill"))
    return build_cell(arch, "decode_32k", mesh, cfg=cfg,
                      shape=ShapeCell("decode_32k", ds, db, "decode"))


def _family_prefill_launches(cfg) -> int:
    """``nm_prune_matmul`` launches a rank of 15d / 15e makes in a prefill:
    RWKV6-7B's r/k/v/g (column shards), gate (a column shard) and down
    (gathered whole) a layer; Whisper-medium's q and fc1 (column shards)
    and fc2 (whole) of every encoder layer, q of self- and cross-attention,
    fc1 and fc2 of every decoder layer (no layer index: no skips)."""
    if cfg.is_encdec:
        return 3 * cfg.n_encoder_layers + 4 * cfg.n_layers
    return 6 * cfg.n_layers


def _moe_train_cell(mesh):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell
    from repro_torch.train import OptConfig

    b, t, steps = CELL_MOE_TRAIN
    cfg = dataclasses.replace(get_config("qwen3_30b_a3b"), n_layers=CELL_DENSE_DEPTH)
    return build_cell("qwen3_30b_a3b", "train_4k", mesh, cfg=cfg, grad_accum=1,
                      shape=ShapeCell("train_4k", t, b, "train"),
                      opt_cfg=OptConfig(lr=3e-4, warmup_steps=2, total_steps=steps))


def _family_train_cell(mesh, arch, ga=1):
    """15g's train cell of ``arch`` (``CELL_FAMILY_TRAIN``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell
    from repro_torch.train import OptConfig

    _, depth, b, t, _ = CELL_FAMILY_TRAIN[arch]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=depth,
                              n_encoder_layers=min(cfg.n_encoder_layers, depth))
    return build_cell(arch, "train_4k", mesh, cfg=cfg, grad_accum=ga,
                      shape=ShapeCell("train_4k", t, b, "train"),
                      opt_cfg=OptConfig(lr=3e-4, warmup_steps=2, total_steps=CELL_FAMILY_STEPS))


def _family_train_rank(torch, me, meshes, ckpt):
    """15g on one of phase 15's ranks: each arch's train cell on its grid
    (``meshes`` by grid), ``CELL_FAMILY_STEPS`` steps; Whisper-medium's
    state checkpointed after ``CELL_CKPT_AT`` steps."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.dryrun import state_bytes

    for arch, (key, _, _, _, grid) in CELL_FAMILY_TRAIN.items():
        t0 = time.perf_counter()
        cell = _family_train_cell(meshes[grid], arch)
        state = cell.materialize(SEED, "cuda")
        torch.cuda.synchronize()
        me[f"{key}_built"] = time.perf_counter() - t0
        me[f"{key}_held"] = {"params": _gib(_local_bytes(state["params"].parameters())),
                             "moments": _gib(_local_bytes(list(state["opt"]["mu"].values())
                                                          + list(state["opt"]["nu"].values())))}
        me[f"{key}_bytes"] = state_bytes(state)
        _reset_counts(torch)
        me[f"{key}_steps"] = []
        for i in range(CELL_FAMILY_STEPS):
            if arch == "whisper_medium" and i == CELL_CKPT_AT:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                save_checkpoint(ckpt, _train_state(state), cell.shardings())
                me[f"{key}_ckpt_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = cell.run(state, step=i)
            torch.cuda.synchronize()
            me[f"{key}_steps"].append(dict(loss=float(m["loss"]),
                                           grad_norm=float(m["grad_norm"]),
                                           wall=time.perf_counter() - t0))
            if i == 0:
                me[f"{key}_first"] = _counts(torch)
        me[key] = _counts(torch)
        me[f"{key}_digest"] = _digest(torch, state, meshes[grid])
        del cell, state
        torch.cuda.empty_cache()
        if me["rank"] == 0:
            print(f"  15g {arch} rank 0: steps {me[f'{key}_steps']}", flush=True)


def _moe_train_rank(torch, me, mesh):
    """15f on one of phase 15's ranks: Qwen3-30B-A3B's train cell, its
    expert stacks held on (D over data, d_ff over model), ``CELL_MOE_TRAIN``
    steps."""
    from repro_torch.launch.dryrun import state_bytes

    t0 = time.perf_counter()
    cell = _moe_train_cell(mesh)
    state = cell.materialize(SEED, "cuda")
    torch.cuda.synchronize()
    me["f_built"] = time.perf_counter() - t0
    me["f_held"] = {"params": _gib(_local_bytes(state["params"].parameters())),
                    "moments": _gib(_local_bytes(list(state["opt"]["mu"].values())
                                                 + list(state["opt"]["nu"].values())))}
    me["f_bytes"] = state_bytes(state)
    _reset_counts(torch)
    me["f_steps"] = []
    for i in range(CELL_MOE_TRAIN[2]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = cell.run(state, step=i)
        torch.cuda.synchronize()
        me["f_steps"].append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                  wall=time.perf_counter() - t0))
        if i == 0:
            me["f_first"] = _counts(torch)
        if me["rank"] == 0:
            print(f"  15f rank 0 step {i}: {me['f_steps'][-1]}", flush=True)
    me["f"] = _counts(torch)
    me["f_digest"] = _digest(torch, state, mesh)
    del cell, state
    torch.cuda.empty_cache()


def _steps(torch, cell, state, steps, forced=None):
    """``steps`` decode steps → (each row's tokens, each step's logits on
    the host): greedy, or with ``forced`` (a list of ``(B,)`` token lists)
    each step's next input given, so that a reference takes the ranks'
    inputs."""
    from repro_torch.distributed import sharding

    tokens, logits = [], []
    for j in range(steps):
        out = cell.run(state)[0]
        logits.append(out.float().cpu())
        nxt = out.float().argmax(-1).to(torch.int32)
        if forced is not None:
            nxt = torch.tensor(forced[j], dtype=torch.int32, device=nxt.device)
        tokens.append(nxt.cpu().tolist())
        state["tokens"] = sharding.local(nxt[:, None], cell._bspec(), cell.mesh).contiguous() \
            if cell.mesh.bound else nxt[:, None]
    return [list(row) for row in zip(*tokens)], logits


def _family_rank(torch, me, mesh):
    """15d / 15e on one of phase 15's ranks: each arch's prefill cell, then
    its decode cell, into ``me``."""
    from repro_torch.launch.dryrun import state_bytes

    for arch, (label, _, _, (_, ds, steps), f32) in CELL_FAMILIES.items():
        key = label[2:]
        t0 = time.perf_counter()
        cell = _family_cell(mesh, arch, "prefill")
        state = cell.materialize(SEED, "cuda")
        torch.cuda.synchronize()
        me[f"{key}_built"] = time.perf_counter() - t0
        me[f"{key}_bytes"] = state_bytes(state)
        _reset_counts(torch)
        t0 = time.perf_counter()
        me[f"{key}_logits"] = cell.run(state)[0].float().cpu()
        torch.cuda.synchronize()
        me[f"{key}_wall"] = time.perf_counter() - t0
        me[key] = _counts(torch)
        me[f"{key}_heads"] = {n: tuple(t.shape) for n, t in state["cache"]["layers"][0].items()}
        del cell, state
        torch.cuda.empty_cache()
        cell = _family_cell(mesh, arch, "decode")
        state = cell.materialize(SEED, "cuda", filled=ds - steps)
        me[f"{key}d_bytes"] = state_bytes(state)
        _reset_counts(torch)
        t0 = time.perf_counter()
        me[f"{key}d_tokens"], me[f"{key}d_logits"] = _steps(torch, cell, state, steps)
        torch.cuda.synchronize()
        me[f"{key}d_wall"] = time.perf_counter() - t0
        me[f"{key}d"] = _counts(torch)
        del cell, state
        torch.cuda.empty_cache()
        if f32:
            cell = _family_cell(mesh, arch, "decode", f32=True)
            state = cell.materialize(SEED, "cuda", filled=ds - steps)
            me[f"{key}f_tokens"], me[f"{key}f_logits"] = _steps(torch, cell, state, steps)
            del cell, state
            torch.cuda.empty_cache()
        if me["rank"] == 0:
            print(f"  {label} done: prefill {me[f'{key}_wall']:.1f} s, decode "
                  f"{me[f'{key}d_wall']:.1f} s", flush=True)


def _train_state(state):
    return {"params": dict(state["params"].named_parameters()),
            "opt": {k: state["opt"][k] for k in ("mu", "nu")}}


def _digest(torch, state, mesh):
    """Per parameter: this rank's slice of it as (spec, sum, sum of squares)."""
    from repro_torch.train.optimizer import spec_of

    return {k: (spec_of(p), float(p.detach().double().sum()),
                float(p.detach().double().square().sum()))
            for k, p in state["params"].named_parameters()}


def cell_rank(ckpt: str):
    """One of phase 15's two ranks: 15a on a (1, 2) cell mesh, 15b on
    (2, 1), 15f and 15c-15e on (1, 2), 15g on (1, 2) and (2, 1), each rank's
    records gathered to every rank."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.dryrun import state_bytes
    from repro_torch.launch.mesh import make_cell_mesh
    from repro_torch.models import moe as moe_lib

    numerics(torch)
    mp, dp = make_cell_mesh((1, 2)), make_cell_mesh((2, 1))
    me = {"rank": dist.get_rank()}

    # 15a: full depth
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cell = _moe_cell(mp, get_config("qwen3_30b_a3b").n_layers)
    state = cell.materialize(SEED, "cuda")
    torch.cuda.synchronize()
    me["a_built"] = time.perf_counter() - t0
    me["a_held_gib"] = _gib(torch.cuda.memory_allocated())
    me["a_bytes"] = state_bytes(state)
    _reset_counts(torch)
    t0 = time.perf_counter()
    logits = cell.run(state)[0]
    torch.cuda.synchronize()
    me["a_wall"] = time.perf_counter() - t0
    me["a"] = _counts(torch)
    me["a_logits"] = (tuple(logits.shape), bool(logits.float().isfinite().all()))
    del cell, state, logits
    torch.cuda.empty_cache()
    # 15a at depth 4: logits and layer 0's expert-input masks
    cell = _moe_cell(mp, CELL_DEPTH)
    state = cell.materialize(SEED, "cuda")
    seen, restore = _mask_spy(moe_lib, 1)
    try:
        me["a4_logits"] = cell.run(state)[0].float().cpu()
    finally:
        restore()
    me["a4_masks"] = seen
    del cell, state
    torch.cuda.empty_cache()
    if me["rank"] == 0:
        print(f"  15a done at {time.perf_counter() - t0:.1f} s", flush=True)

    # 15b
    b, t, ga, steps = CELL_TRAIN
    cell = _train_cell(dp)
    state = cell.materialize(SEED, "cuda")
    torch.cuda.synchronize()
    me["b_held"] = {"params": _gib(_local_bytes(state["params"].parameters())),
                    "moments": _gib(_local_bytes(list(state["opt"]["mu"].values())
                                                 + list(state["opt"]["nu"].values())))}
    me["b_bytes"] = state_bytes(state)
    _reset_counts(torch)
    me["b_steps"] = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = cell.run(state, step=i)
        torch.cuda.synchronize()
        me["b_steps"].append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                  wall=time.perf_counter() - t0))
        if i == 0:
            me["b_first"] = _counts(torch)
        if me["rank"] == 0:
            print(f"  15b rank 0 step {i}: {me['b_steps'][-1]}", flush=True)
    me["b"] = _counts(torch)
    me["b_acc_gib"] = _accumulator_gib(state, dp)
    me["b_digest"] = _digest(torch, state, dp)
    me["b_coords"] = dp.coords()
    del cell, state
    torch.cuda.empty_cache()

    # 15f, 15g
    _moe_train_rank(torch, me, mp)
    t0 = time.perf_counter()
    _family_train_rank(torch, me, {(1, 2): mp, (2, 1): dp}, ckpt)
    me["g_s"] = time.perf_counter() - t0

    # 15c
    cell = _decode_cell(mp)
    state = cell.materialize(SEED, "cuda", filled=CELL_DECODE[1] - CELL_DECODE[2])
    me["c_heads"] = state["cache"]["layers"][0]["k"].shape[2]
    me["c_bytes"] = state_bytes(state)
    _reset_counts(torch)
    t0 = time.perf_counter()
    me["c_tokens"] = _steps(torch, cell, state, CELL_DECODE[2])[0]
    torch.cuda.synchronize()
    me["c_wall"] = time.perf_counter() - t0
    me["c"] = _counts(torch)
    del cell, state
    torch.cuda.empty_cache()

    # 15d, 15e
    _family_rank(torch, me, mp)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, me)
    return everyone


def _accumulator_gib(state, mesh) -> float:
    """The float32 ZeRO-2 accumulator a rank holds (``shard_zero1``'s slices)."""
    import torch

    from repro_torch.distributed import sharding

    n = 0
    for p in state["params"].parameters():
        shape = sharding.full_shape(p)
        n += sharding.local(torch.empty(shape, device="meta"),
                            sharding.shard_zero1(shape, mesh), mesh).numel()
    return _gib(4 * n)


def check_train_rank(label, me, key, steps, whole, grid):
    """A train cell's rank ``me`` against the one-rank cell: its losses and
    grad norms (``me[key + "_steps"]``) within ``CELL_TRAIN_RTOL`` of
    ``steps``, and the sums of squares of its parameter slices
    (``me[key + "_digest"]``) within it of ``whole``'s same slices on the
    ``grid``; prints both."""
    from repro_torch.distributed import sharding

    r = me["rank"]
    for i, (got, ref) in enumerate(zip(me[f"{key}_steps"], steps)):
        for k in ("loss", "grad_norm"):
            if not abs(got[k] - ref[k]) <= CELL_TRAIN_RTOL * abs(ref[k]):
                fail(f"{label} rank {r} step {i}: {k} {got[k]} against one rank's {ref[k]}")
    mesh = dataclasses.replace(sharding.Mesh(("data", "model"), grid), rank=r)
    worst = 0.0
    for k, (spec, s1, s2) in me[f"{key}_digest"].items():
        sq = float(sharding.local(whole[k], spec, mesh).double().square().sum())
        worst = max(worst, abs(s2 - sq) / max(sq, 1e-30))
    if not worst <= CELL_TRAIN_RTOL:
        fail(f"{label} rank {r}: parameter slices' sums of squares off by {worst:.2e}")
    print(f"  {label} rank {r}: losses {[round(s['loss'], 5) for s in me[f'{key}_steps']]} "
          f"against one rank's {[round(s['loss'], 5) for s in steps]}; grad norms "
          f"{[round(s['grad_norm'], 4) for s in me[f'{key}_steps']]} / "
          f"{[round(s['grad_norm'], 4) for s in steps]}; parameter slices' sums of "
          f"squares within {worst:.2e} (limit {CELL_TRAIN_RTOL})")


def cells_reference(torch, ranks, ckpt):
    """15a-15g's one-rank cells in this process, and the checks against the
    ranks' records."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe as moe_lib

    one = make_local_mesh()
    # 15a: the same function at model 1 (_moe_shard_map on a 1 x 1 mesh)
    local_path = moe_lib._moe_local
    moe_lib._moe_local = lambda x, p, policy, phase, top_k, act_fn, impl, layer_idx: \
        moe_lib._moe_shard_map(one, x, p, policy, phase, top_k, act_fn, layer_idx)
    seen, restore = _mask_spy(moe_lib, 1)
    try:
        cell = _moe_cell(one, CELL_DEPTH)
        want = cell.run(cell.materialize(SEED, "cuda"))[0].float().cpu()
    finally:
        restore()
        moe_lib._moe_local = local_path
    del cell
    torch.cuda.empty_cache()
    for me in ranks:
        r = me["rank"]
        check_close(f"15a depth {CELL_DEPTH} rank {r} logits vs model 1", me["a4_logits"], want,
                    BF16_TOL)
        gate, down = me["a4_masks"]
        if not torch.equal(gate, seen[0]):
            fail(f"15a rank {r}: layer 0's expert gate-input masks differ from model 1's")
        cols = down.shape[-1]
        if not torch.equal(down, seen[1][..., r * cols:(r + 1) * cols]):
            fail(f"15a rank {r}: layer 0's expert down-input masks differ from model 1's")
    print(f"  15a depth {CELL_DEPTH}: layer 0's expert-input keep-masks bit-identical to model "
          f"1's on both ranks (gate {tuple(seen[0].shape)}, down {tuple(seen[1].shape)} "
          "split on d_ff)")

    # 15b: the one-rank cell
    cell = _train_cell(one)
    state = cell.materialize(SEED, "cuda")
    held = {"params": _gib(_local_bytes(state["params"].parameters())),
            "moments": _gib(_local_bytes(list(state["opt"]["mu"].values())
                                         + list(state["opt"]["nu"].values())))}
    acc = _gib(4 * sum(p.numel() for p in state["params"].parameters()))
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(CELL_TRAIN[3]):
        m = cell.run(state, step=i)
        steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
    peak = _gib(torch.cuda.max_memory_allocated())
    whole = {k: p.detach() for k, p in state["params"].named_parameters()}
    for me in ranks:
        r = me["rank"]
        check_train_rank("15b", me, "b", steps, whole, (2, 1))
        for what, mine, full in (("weights", me["b_held"]["params"], held["params"]),
                                 ("moments", me["b_held"]["moments"], held["moments"]),
                                 ("accumulator", me["b_acc_gib"], acc)):
            if not mine <= 0.5 * full + 0.01:
                fail(f"15b rank {r}: {what} {mine:.3f} GiB is not half of one rank's "
                     f"{full:.3f}")
        print(f"  15b rank {r}: holds weights {me['b_held']['params']:.3f} GiB, moments "
              f"{me['b_held']['moments']:.3f}, accumulator {me['b_acc_gib']:.3f} against one "
              f"rank's {held['params']:.3f} / {held['moments']:.3f} / {acc:.3f}; peak "
              f"{me['b']['peak_gib']:.2f} GiB allocated (one rank {peak:.2f}); steps "
              f"{[round(s['wall'], 2) for s in me['b_steps']]} s; collectives "
              f"{me['b']['collectives']}")
    del whole, state, cell
    torch.cuda.empty_cache()

    moe_train_reference(torch, ranks, one)
    t0 = time.perf_counter()
    family_train_reference(torch, ranks, one, ckpt)
    SUBPHASE_SECONDS["15g"] = ranks[0]["g_s"] + time.perf_counter() - t0

    # 15c
    cell = _decode_cell(one)
    state = cell.materialize(SEED, "cuda", filled=CELL_DECODE[1] - CELL_DECODE[2])
    want = _steps(torch, cell, state, CELL_DECODE[2])[0]
    del state, cell
    torch.cuda.empty_cache()
    for me in ranks:
        check_tokens(f"15c rank {me['rank']}", me["c_tokens"], want, "one rank's")
    family_reference(torch, ranks, one)
    return steps


def moe_train_reference(torch, ranks, one):
    """15f's one-rank cell (``_moe_shard_map`` on the 1 x 1 mesh, the same
    capacity and drops as the ranks': data 1 routes the same tokens) and the
    checks: each rank's losses, grad norms and parameter slices within
    ``CELL_TRAIN_RTOL`` of one rank's."""
    from repro_torch.models import moe as moe_lib

    local_path = moe_lib._moe_local
    moe_lib._moe_local = lambda x, p, policy, phase, top_k, act_fn, impl, layer_idx: \
        moe_lib._moe_shard_map(one, x, p, policy, phase, top_k, act_fn, layer_idx)
    try:
        cell = _moe_train_cell(one)
        state = cell.materialize(SEED, "cuda")
        held = {"params": _gib(_local_bytes(state["params"].parameters())),
                "moments": _gib(_local_bytes(list(state["opt"]["mu"].values())
                                             + list(state["opt"]["nu"].values())))}
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(CELL_MOE_TRAIN[2]):
            m = cell.run(state, step=i)
            steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
        peak = _gib(torch.cuda.max_memory_allocated())
    finally:
        moe_lib._moe_local = local_path
    whole = {k: p.detach() for k, p in state["params"].named_parameters()}
    for me in ranks:
        r = me["rank"]
        check_train_rank("15f", me, "f", steps, whole, (1, 2))
        f, mo = me["f"], me["f"]["moe"]
        print(f"  15f rank {r}: built in {me['f_built']:.1f} s; holds weights "
              f"{me['f_held']['params']:.3f} GiB, moments {me['f_held']['moments']:.3f} against "
              f"one rank's {held['params']:.3f} / {held['moments']:.3f}; peak "
              f"{f['peak_gib']:.2f} GiB allocated (one rank {peak:.2f}); steps "
              f"{[round(s['wall'], 2) for s in me['f_steps']]} s; capacity {mo['capacity']} "
              f"slots an expert, {mo['dropped']} of {mo['pairs']} (token, expert) pairs dropped "
              f"({mo['dropped'] / max(mo['pairs'], 1):.4f}; the pairs and calls count each "
              f"forward once: remat's recompute stops before the count); collectives "
              f"{f['collectives']}")
    del state, cell, whole
    torch.cuda.empty_cache()


def family_train_reference(torch, ranks, one, ckpt):
    """15g's one-rank cells (a microbatch per DP rank's) and the checks: each
    rank's losses, grad norms and parameter slices within
    ``CELL_TRAIN_RTOL`` of one rank's, what it holds against one rank; then
    Whisper-medium's checkpoint, saved whole by its (2, 1) ranks after
    ``CELL_CKPT_AT`` steps, restored into the one-rank state, whose next
    step's loss must equal the ranks'."""
    from repro_torch.checkpoint import load_checkpoint

    for arch, (key, depth, b, t, grid) in CELL_FAMILY_TRAIN.items():
        cell = _family_train_cell(one, arch, ga=grid[0])
        state = cell.materialize(SEED, "cuda")
        held = {"params": _gib(_local_bytes(state["params"].parameters())),
                "moments": _gib(_local_bytes(list(state["opt"]["mu"].values())
                                             + list(state["opt"]["nu"].values())))}
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(CELL_FAMILY_STEPS):
            m = cell.run(state, step=i)
            steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
        peak = _gib(torch.cuda.max_memory_allocated())
        whole = {k: p.detach() for k, p in state["params"].named_parameters()}
        for me in ranks:
            r = me["rank"]
            check_train_rank(f"15g {arch}", me, key, steps, whole, grid)
            got = me[key]
            print(f"  15g {arch} rank {r}: depth {depth}, {b} x {t} tokens on {grid}; built in "
                  f"{me[f'{key}_built']:.1f} s; holds weights {me[f'{key}_held']['params']:.3f} "
                  f"GiB, moments {me[f'{key}_held']['moments']:.3f} against one rank's "
                  f"{held['params']:.3f} / {held['moments']:.3f}; peak {got['peak_gib']:.2f} GiB "
                  f"(one rank {peak:.2f}); steps "
                  f"{[round(s['wall'], 2) for s in me[f'{key}_steps']]} s; collectives "
                  f"{got['collectives']}")
        del whole
        if arch == "whisper_medium":
            t0 = time.perf_counter()
            # the ranks' state after CELL_CKPT_AT steps, into this state's tensors
            loaded = load_checkpoint(ckpt, _train_state(state))
            with torch.no_grad():
                for k, p in state["params"].named_parameters():
                    p.copy_(loaded["params"][k])
            dev = next(state["params"].parameters()).device
            state["opt"] = {**loaded["opt"],
                            "step": torch.tensor(CELL_CKPT_AT, dtype=torch.int32, device=dev)}
            del loaded
            restored = time.perf_counter() - t0
            m = cell.run(state, step=CELL_CKPT_AT)
            got, ref = float(m["loss"]), ranks[0][f"{key}_steps"][CELL_CKPT_AT]["loss"]
            if not abs(got - ref) <= CELL_TRAIN_RTOL * abs(ref):
                fail(f"15g elastic: step {CELL_CKPT_AT}'s loss {got} after the restore, the "
                     f"ranks' {ref}")
            print(f"  15g elastic: Whisper-medium's (2, 1) checkpoint after {CELL_CKPT_AT} "
                  f"step ({Path(ckpt).stat().st_size / 2**30:.2f} GiB, whole tensors) saved in "
                  f"{ranks[0][f'{key}_ckpt_s']:.1f} s, restored in one process in "
                  f"{restored:.1f} s; step {CELL_CKPT_AT}'s loss {got:.5f} against the ranks' "
                  f"{ref:.5f}")
        del state, cell
        torch.cuda.empty_cache()


def _head_split_attention(torch, cfg, b, s) -> float:
    """The plain attention of one decode step over ``s`` rows of bf16 K/V
    (``models/attention.attention``, float32 inside): all heads in one call,
    as one rank computes it, against each half of them alone, as each of two
    ranks does → the largest difference of their outputs."""
    from repro_torch.models.attention import attention

    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    q, k, v = (torch.randn(b, n, cfg.n_heads, cfg.head_dim, generator=g, device="cuda")
               .bfloat16() for n in (1, s, s))
    whole = attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    h = cfg.n_heads // 2
    halves = torch.cat([attention(q[:, :, i:i + h], k[:, :, i:i + h], v[:, :, i:i + h],
                                  causal=False, chunk=cfg.attn_chunk) for i in (0, h)], 2)
    return float((whole.float() - halves.float()).abs().max())


def family_reference(torch, ranks, one):
    """15d / 15e's one-rank cells: each rank's prefill logits and decode
    steps' logits (the one rank fed the ranks' greedy tokens) within
    ``BF16_TOL`` of one rank's (a decode held at float32: within
    ``F32_TOL`` there, its bf16 difference printed); what a rank holds
    against one rank's."""
    from repro_torch.launch.dryrun import state_bytes

    for arch, (label, _, _, (db, ds, steps), f32) in CELL_FAMILIES.items():
        key = label[2:]
        cell = _family_cell(one, arch, "prefill")
        state = cell.materialize(SEED, "cuda")
        held = state_bytes(state)
        want = cell.run(state)[0].float().cpu()
        del cell, state
        torch.cuda.empty_cache()
        cell = _family_cell(one, arch, "decode")
        state = cell.materialize(SEED, "cuda", filled=ds - steps)
        held_d = state_bytes(state)
        forced = [list(col) for col in zip(*ranks[0][f"{key}d_tokens"])]
        _, want_d = _steps(torch, cell, state, steps, forced=forced)
        del cell, state
        torch.cuda.empty_cache()
        if f32:
            cell = _family_cell(one, arch, "decode", f32=True)
            state = cell.materialize(SEED, "cuda", filled=ds - steps)
            forced = [list(col) for col in zip(*ranks[0][f"{key}f_tokens"])]
            _, want_f = _steps(torch, cell, state, steps, forced=forced)
            diff = _head_split_attention(torch, cell.cfg, db, cell.cfg.encoder_seq or ds)
            print(f"  {label}: one decode step's plain attention over "
                  f"{cell.cfg.encoder_seq or ds} bf16 rows, all {cell.cfg.n_heads} heads at "
                  f"once against each half alone: max difference {diff:.3e} (0: the same "
                  "reduction order); the bf16 decode is held at float32, depth "
                  f"{CELL_F32_DEPTH}")
            del cell, state
            torch.cuda.empty_cache()
        for me in ranks:
            r = me["rank"]
            check_close(f"{label} rank {r} prefill logits vs model 1", me[f"{key}_logits"], want,
                        BF16_TOL)
            for j, (got, ref) in enumerate(zip(me[f"{key}d_logits"], want_d)):
                if not f32:
                    check_close(f"{label} rank {r} decode step {j} logits vs model 1", got, ref,
                                BF16_TOL)
                    continue
                err = float((got - ref).abs().max())
                same = got.argmax(-1).tolist() == ref.argmax(-1).tolist()
                print(f"  {label} rank {r} decode step {j} bf16 logits vs model 1: max_abs_err="
                      f"{err:.3e} (BF16_TOL would allow {BF16_TOL * float(ref.abs().max()):.3e}"
                      f"); greedy tokens {'equal' if same else 'differ'}")
                check_close(f"{label} rank {r} decode step {j} float32 depth {CELL_F32_DEPTH} "
                            "logits vs model 1", me[f"{key}f_logits"][j], want_f[j], F32_TOL)
            if me[f"{key}d_tokens"] != ranks[0][f"{key}d_tokens"]:
                fail(f"{label} rank {r}: greedy tokens differ from rank 0's")
            for what, mine, full in (("prefill", me[f"{key}_bytes"], held),
                                     ("decode", me[f"{key}d_bytes"], held_d)):
                if not mine <= CELL_HELD_SHARE * full:
                    fail(f"{label} rank {r}: the {what} cell holds {_gib(mine):.3f} GiB, more "
                         f"than {CELL_HELD_SHARE} of one rank's {_gib(full):.3f}")
                print(f"  {label} rank {r}: the {what} cell holds {_gib(mine):.3f} GiB against "
                      f"one rank's {_gib(full):.3f} ({mine / full:.3f})")


def family_checks(me):
    """15d / 15e on one rank's records: the kernels' launches, the heads its
    cache holds, its walls and collectives."""
    from repro_torch.configs import get_config

    r = me["rank"]
    for arch, (label, depth, (b, t), (db, ds, steps), _) in CELL_FAMILIES.items():
        key = label[2:]
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        pre, dec = me[key], me[f"{key}d"]
        check_launches(f"{label} rank {r} prefill", pre["launches"],
                       {"nm_prune_matmul": _family_prefill_launches(cfg)})
        check_launches(f"{label} rank {r} decode", dec["launches"], {"nm_prune_matmul": 0})
        heads = me[f"{key}_heads"]
        held = {n: s[1] for n, s in heads.items() if n == "S"} if not cfg.is_encdec else \
            {n: s[2] for n, s in heads.items()}
        if set(held.values()) != {cfg.n_heads // 2}:
            fail(f"{label} rank {r}: its cache holds {held} heads, not {cfg.n_heads // 2} "
                 f"of {cfg.n_heads}")
        if tuple(me[f"{key}_logits"].shape) != (b, cfg.vocab_size) or \
                not bool(me[f"{key}_logits"].isfinite().all()):
            fail(f"{label} rank {r}: prefill logits {tuple(me[f'{key}_logits'].shape)} "
                 "not finite or not (B, V)")
        co, cd = pre["collectives"], dec["collectives"]
        print(f"  {label} rank {r}: {cfg.name} depth {cfg.n_layers}, cache layer 0 "
              f"{heads} (its {'S' if not cfg.is_encdec else 'K/V'} {cfg.n_heads // 2} of "
              f"{cfg.n_heads} heads); built in {me[f'{key}_built']:.1f} s; prefill {b} x {t} in "
              f"{me[f'{key}_wall']:.2f} s eager, peak {pre['peak_gib']:.2f} GiB, "
              f"nm_prune_matmul {pre['launches']['nm_prune_matmul']}; all-gathers "
              f"{co['all_gather'][0]} of {co['all_gather'][1] / 2**20:.1f} MiB, column gathers "
              f"{co['tp_gather'][0]} of {co['tp_gather'][1] / 2**20:.1f} MiB; decode B = {db} "
              f"over {ds} rows, {steps} steps in {me[f'{key}d_wall']:.2f} s, peak "
              f"{dec['peak_gib']:.2f} GiB, all-gathers {cd['all_gather'][0]} of "
              f"{cd['all_gather'][1] / 2**20:.1f} MiB")


def phase_cells(torch, rates):
    """Phase 15 (after 14): the sharded cells on two ranks of this card.
    Returns {"15a": rank 0's launches}."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn

    moe_cfg, dense_cfg = get_config("qwen3_30b_a3b"), get_config("llama31_8b")
    card = nvidia_smi_line()
    b, t = CELL_MOE_BT
    bt, tt, ga, steps = CELL_TRAIN
    print(f"phase 15: sharded cells, two ranks on cuda:0 over gloo ({card}); 15a "
          f"Qwen3-30B-A3B prefill_32k cut to {b} x {t}, full width and depth 48, mesh (data 1, "
          f"model 2), paper_policy(8, 16, (41, 46, 47)) with the kernels; 15b LLaMA-3.1-8B "
          f"train_4k cut to {bt} x {tt}, grad_accum {ga}, {steps} steps, depth "
          f"{CELL_DENSE_DEPTH}, mesh (2, 1); 15f Qwen3-30B-A3B train_4k cut to "
          f"{CELL_MOE_TRAIN[0]} x {CELL_MOE_TRAIN[1]}, {CELL_MOE_TRAIN[2]} steps, depth "
          f"{CELL_DENSE_DEPTH}, mesh (1, 2), full width (each rank half of every expert's "
          f"d_ff); 15c LLaMA-3.1-8B decode_32k cut to B = "
          f"{CELL_DECODE[0]} over a {CELL_DECODE[1]}-deep cache, depth {CELL_DENSE_DEPTH}, "
          f"{CELL_DECODE[2]} greedy steps, "
          "mesh (1, 2); "
          + "; ".join(f"{label} {arch} depth {depth or 'full'} prefill_32k cut to {b} x {t}, "
                      f"decode_32k cut to B = {db} over {ds} rows, {steps} greedy steps, "
                      "mesh (1, 2), paper_policy(8, 16, ()) with the kernels"
                      for arch, (label, depth, (b, t), (db, ds, steps), _)
                      in CELL_FAMILIES.items())
          + "; 15g " + ", ".join(f"{arch} train_4k depth {depth} cut to {b} x {t}, mesh {grid}"
                                 for arch, (_, depth, b, t, grid) in CELL_FAMILY_TRAIN.items())
          + f", {CELL_FAMILY_STEPS} steps each (full width; the cells' default policy: dense)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cells-") as d:
        ckpt = str(Path(d) / "ckpt.npz")
        ranks = spawn(cell_rank, 2, ckpt, device="cuda", store_dir=d)
        t1 = time.perf_counter()
        print(f"  spawned, built, ran and joined in {t1 - t0:.1f} s")
        for me in ranks:
            r, a = me["rank"], me["a"]
            mo, co = a["moe"], a["collectives"]
            shape, finite = me["a_logits"]
            layers = moe_cfg.n_layers
            if shape != (b, moe_cfg.vocab_size) or not finite:
                fail(f"15a rank {r}: logits {shape}, finite {finite}")
            # the expert gate and down inputs a layer; q column-parallel outside the skips
            want = {"nm_prune": 2 * layers, "nm_prune_matmul": layers - 3}
            check_launches(f"15a rank {r}", {k: a["launches"][k] for k in want}, want)
            if mo["calls"] != layers:
                fail(f"15a rank {r}: {mo['calls']} _moe_shard_map calls, expected {layers}")
            print(f"  15a rank {r}: built in {me['a_built']:.1f} s, holds "
                  f"{me['a_held_gib']:.2f} GiB (phase 7's one rank: 57.20 allocated at its "
                  f"peak); prefill {me['a_wall']:.2f} s eager, peak {a['peak_gib']:.2f} GiB "
                  f"allocated; all-reduces {co['all_reduce'][0]} of "
                  f"{co['all_reduce'][1] / 2**20:.1f} MiB, all-gathers {co['all_gather'][0]} of "
                  f"{co['all_gather'][1] / 2**20:.1f} MiB; capacity {mo['capacity']} slots an "
                  f"expert, {mo['dropped']} of {mo['pairs']} (token, expert) pairs dropped "
                  f"({mo['dropped'] / mo['pairs']:.4f}); launches nm_prune "
                  f"{a['launches']['nm_prune']}, nm_prune_matmul "
                  f"{a['launches']['nm_prune_matmul']}")
            c = me["c"]
            print(f"  15c rank {r}: cache holds {me['c_heads']} of {dense_cfg.n_kv_heads} KV "
                  f"heads; {CELL_DECODE[2]} decode steps in {me['c_wall']:.2f} s eager, peak "
                  f"{c['peak_gib']:.2f} GiB; collectives {c['collectives']}")
            if me["c_heads"] != dense_cfg.n_kv_heads // 2:
                fail(f"15c rank {r}: the cache holds {me['c_heads']} KV heads, not half")
            family_checks(me)
        cells_reference(torch, ranks, ckpt)
    print(f"phase 15 seconds: ranks {t1 - t0:.1f}, one-rank references and checks "
          f"{time.perf_counter() - t1:.1f}")
    return {label: {k: v for k, v in ranks[0][key]["launches"].items() if "." not in k}
            for label, key in (("15a", "a"), ("15d", "d"), ("15e", "e"))}, ranks

# ------------------------------------------------------------ launch tooling
DRY_SHARE_LIMIT = 1.05      # 16b: a bound above the measured busy time is a counting fault
DRY_PREFILL = (1, 2048)     # 16b: LLaMA-3.1-8B's prefill cell, B x T
DRY_DECODE = (4, 4096)      # 16b: its decode cell, B over a cache this deep
TOOLING_TIMEOUT = 900       # s: each 16c command
# 16c's commands that count on the host, started niced when the run starts:
# (label, arguments after ``python -m``, lines their output must hold)
HOST_TOOLS = (
    ("dryrun llama31_8b", ["repro_torch.launch.dryrun", "--both", "--arch", "llama31_8b",
                           "--json", "{dir}/llama.json"],
     ["[dryrun] done: 6 ok, 2 skipped, 0 unported, 0 failed"]),
    ("dryrun qwen3_30b_a3b", ["repro_torch.launch.dryrun", "--both", "--arch",
                              "qwen3_30b_a3b", "--json", "{dir}/qwen3.json"],
     ["[dryrun] done: 6 ok, 2 skipped, 0 unported, 0 failed"]),
    ("dryrun rwkv6_7b", ["repro_torch.launch.dryrun", "--both", "--arch", "rwkv6_7b",
                         "--json", "{dir}/rwkv6.json"],
     ["[dryrun] done: 8 ok, 0 skipped, 0 unported, 0 failed"]),
    ("dryrun whisper_medium", ["repro_torch.launch.dryrun", "--both", "--arch",
                               "whisper_medium", "--json", "{dir}/whisper.json"],
     ["[dryrun] done: 6 ok, 2 skipped, 0 unported, 0 failed"]),
    ("perf", ["repro_torch.launch.perf", "--arch", "qwen2_5_32b", "--shape", "prefill_32k"],
     ["dense ", "per_token ", "tile_consensus ", "Δ vs dense"]),
    ("roofline_exact", ["repro_torch.launch.roofline_exact", "--arch", "llama31_8b",
                        "--shape", "prefill_32k"],
     ["[exact] llama31_8b × prefill_32k: c=", "(= the full-depth count)"]),
)
# the examples, on the card: (label, script, arguments, lines); the train
# example's resume is held to the JAX example's on the CPU
# (tests/test_torch_examples.py), and 13d/13e resume training on the card
EXAMPLES = (
    ("train", "torch_train_sparse_lm.py", ["--steps", "6", "--ckpt-dir", "{dir}/train"],
     ["resumed_from=0  loss"]),
    ("quickstart", "torch_quickstart.py", [],
     ["2:4 pruned activation sparsity: 0.50", "Amber 8:16 prefill — output perturbation"]),
    ("serve", "torch_serve_sparse_prefill.py", [],
     ["[amber816] prefill+decode 8×(96→32)", "greedy agreement (dense vs sparse prefill)"]),
    ("deploy", "torch_deploy_outstanding_sparse.py", [],
     ["selected q/gate skip layers", "SQ-W8A8 (α=0.5)", "Outstanding (α=0.1, ŝ=1/s)"]),
)


def _tool_env():
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(root / "src") + (os.pathsep + env["PYTHONPATH"]
                                              if env.get("PYTHONPATH") else "")
    return root, env


def _start(label, argv, workdir, niced: bool):
    """A 16c command as a process of its own, its output to a file."""
    import os

    root, env = _tool_env()
    out = open(Path(workdir) / f"{label.replace(' ', '_')}.log", "w")
    proc = subprocess.Popen([sys.executable, *argv], cwd=root, env=env, stdout=out,
                            stderr=subprocess.STDOUT, text=True,
                            preexec_fn=(lambda: os.nice(19)) if niced else None)
    return {"label": label, "proc": proc, "out": out, "t0": time.perf_counter()}


def start_host_tools(workdir):
    """16c's host-side commands (the dry-run CLIs), started when the run
    starts, niced, on one thread each: they count on the CPU, and finish
    long before phase 16 collects them."""
    return [dict(_start(label, ["-m"] + [a.format(dir=workdir) for a in argv], workdir, True),
                 want=want) for label, argv, want in HOST_TOOLS]


def _finish(job, timeout):
    """Wait for a 16c command and check its exit code and lines; → (its
    output, its seconds)."""
    try:
        rc = job["proc"].wait(timeout=max(1.0, timeout))
    except subprocess.TimeoutExpired:
        job["proc"].kill()
        job["proc"].wait()
        fail(f"16c {job['label']}: no exit within {TOOLING_TIMEOUT} s")
    secs = time.perf_counter() - job["t0"]
    job["out"].close()
    text = Path(job["out"].name).read_text()
    if rc != 0:
        print(text[-4000:])
        fail(f"16c {job['label']}: exit {rc}")
    missing = [w for w in job["want"] if w not in text]
    if missing:
        print(text[-4000:])
        fail(f"16c {job['label']}: its output lacks {missing}")
    return text, secs


def _stop_all(jobs) -> None:
    for job in jobs:
        if job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].wait()


def dry_cells_check(torch, ranks):
    """16a: phase 15's cells counted on dry ranks, against the ranks'
    records (15d / 15e: each prefill and decode cell; 15g: each train
    cell's first step)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.policy import paper_policy
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import abstract_mesh

    b, t = CELL_MOE_BT
    bt, tt, ga, _ = CELL_TRAIN
    db, ds, steps = CELL_DECODE
    moe = dataclasses.replace(get_config("qwen3_30b_a3b"))
    dense = dataclasses.replace(get_config("llama31_8b"), n_layers=CELL_DENSE_DEPTH)
    cases = (
        ("15a", "a", 1, dict(arch="qwen3_30b_a3b", shape_name="prefill_32k", cfg=moe,
                             policy=paper_policy(8, 16, (41, 46, 47), use_kernels=True),
                             shape=ShapeCell("prefill_32k", t, b, "prefill")), (1, 2)),
        ("15b", "b", 1, dict(arch="llama31_8b", shape_name="train_4k", cfg=dense, grad_accum=ga,
                             shape=ShapeCell("train_4k", tt, bt, "train")), (2, 1)),
        ("15f", "f", 1, dict(arch="qwen3_30b_a3b", shape_name="train_4k", grad_accum=1,
                             cfg=dataclasses.replace(moe, n_layers=CELL_DENSE_DEPTH),
                             shape=ShapeCell("train_4k", CELL_MOE_TRAIN[1], CELL_MOE_TRAIN[0],
                                             "train")), (1, 2)),
        ("15c", "c", steps, dict(arch="llama31_8b", shape_name="decode_32k", cfg=dense,
                                 shape=ShapeCell("decode_32k", ds, db, "decode")), (1, 2)),
    )
    mesh = abstract_mesh((1, 2), ("data", "model"))
    for arch, (label, _, _, (_, _, fsteps), _) in CELL_FAMILIES.items():
        for kind, key, times in (("prefill", label[2:], 1), ("decode", label[2:] + "d", fsteps)):
            cell = _family_cell(mesh, arch, kind)
            cases += ((f"{label} {kind}", key, times,
                       dict(arch=arch, shape_name=cell.shape.name, cfg=cell.cfg,
                            policy=cell.policy, shape=cell.shape), (1, 2)),)
    # train cells: the record key → (batch rows, tokens a row) of the step's batch
    train = {"b": (bt, tt), "f": CELL_MOE_TRAIN[:2]}
    for arch, (key, _, b_, t_, grid) in CELL_FAMILY_TRAIN.items():
        cell = _family_train_cell(abstract_mesh(grid, ("data", "model")), arch)
        cases += ((f"15g {arch}", key, 1, dict(arch=arch, shape_name="train_4k", cfg=cell.cfg,
                                                grad_accum=1, shape=cell.shape), grid),)
        train[key] = (b_, t_)
    for label, key, times, kw, grid in cases:
        for me in ranks:
            r = me["rank"]
            mesh = abstract_mesh(grid, ("data", "model"))
            dry = run_cell(mesh=mesh, rank=r, **kw)
            if dry["status"] != "ok":
                fail(f"16a {label} rank {r}: the dry-run says {dry}")
            got = me[f"{key}_first"] if key in train else me[key]
            held = me[f"{key}_bytes"]
            args = dry["bytes_per_device"]["args"]
            batch = 0
            if key in train:    # the rank's shard of the step's tokens (frames are held)
                b_, t_ = train[key]
                batch = b_ // grid[0] * (t_ + 1) * 4
            if dry["held"] != held or args != held + batch:
                fail(f"16a {label} rank {r}: the dry rank holds {dry['held']} B (arguments "
                     f"{args} B from the specs), the rank held {held} B (+ {batch} B of batch)")
            want = {k: [n * times for n in v] for k, v in dry["collectives"].items()}
            if want != got["collectives"]:
                fail(f"16a {label} rank {r}: dry collectives x {times} {want} against the "
                     f"rank's {got['collectives']}")
            peak = dry["bytes_per_device"]["total"] / 2**30
            print(f"  16a {label} rank {r}: held {held} B = the dry rank's (arguments {args} B "
                  f"from the specs{f', {batch} B of them the batch' if batch else ''}); "
                  f"collectives equal the rank's{f' ({times} steps)' if times > 1 else ''}: "
                  + ", ".join(f"{k} {n} of {nb / 2**20:.1f} MiB"
                              for k, (n, nb) in got["collectives"].items() if n)
                  + f"; peak predicted {peak:.2f} GiB, measured {got['peak_gib']:.2f} GiB: "
                  f"ratio {peak / got['peak_gib']:.3f}; counted in {dry['count_s']} s")


def _share(label, rep, busy_ms, rates, card):
    """16b: the dry-run's bound over the busy time of a profiled step."""
    bound = rep.bound_s * 1e3
    share = bound / busy_ms
    mfu = rep.model_flops_total / (busy_ms * 1e-3 * rates[1])
    print(f"  16b {label}: bound {bound:.3f} ms ({rep.dominant}: compute "
          f"{rep.compute_s * 1e3:.3f}, memory {rep.memory_s * 1e3:.3f}, collective "
          f"{rep.collective_s * 1e3:.3f} ms; "
          f"{rep.flops_per_dev / 1e12:.3f} TOP "
          f"({', '.join(f'{c} {n / 1e12:.3f}' for c, n in rep.ops_per_dev.items() if n)}), "
          f"{rep.bytes_per_dev / 1e9:.3f} GB compulsory) against {busy_ms:.3f} ms busy: share "
          f"{share:.3f}; model_flops / (busy x peak) {mfu:.3f} ({card})")
    if not share <= DRY_SHARE_LIMIT:
        fail(f"16b {label}: the bound {bound:.3f} ms exceeds the busy time {busy_ms:.3f} ms "
             f"(share {share:.3f} > {DRY_SHARE_LIMIT}): a counting fault")


def dry_shares(torch, rates, card):
    """16b: the one-rank prefill and decode cells of LLaMA-3.1-8B on the card
    (one step profiled) and counted on ``meta``; phase 13a's train step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.policy import paper_policy
    from repro_torch.launch import roofline
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import args_bytes
    from repro_torch.launch.mesh import make_local_mesh

    cfg = get_config("llama31_8b")
    hw = roofline.HW(*rates)
    pol = paper_policy(8, 16, cfg.qgate_skip_layers, use_kernels=True)
    for label, shape_name, (b, t), kind in (("prefill", "prefill_32k", DRY_PREFILL, "prefill"),
                                            ("decode", "decode_32k", DRY_DECODE, "decode")):
        shape = ShapeCell(shape_name, t, b, kind)
        cell = build_cell("llama31_8b", shape_name, make_local_mesh(), policy=pol, shape=shape)
        t0 = time.perf_counter()
        dry_state = cell.materialize(device="meta")
        _, count = roofline.count_step(cell.run, dry_state, args_bytes=args_bytes(cell))
        rep = roofline.analyze("llama31_8b", shape_name, "1x1", count, cfg, kind,
                               b * (t if kind == "prefill" else 1), hw)
        counted = time.perf_counter() - t0
        state = cell.materialize(SEED, "cuda", filled=t - 3 if kind == "decode" else None)
        cell.run(state)
        torch.cuda.synchronize()
        _, busy, _ = profile_once(torch, f"16b {label} B={b} T={t}", lambda: cell.run(state))
        _share(f"LLaMA-3.1-8B {label} cell, B = {b}, "
               f"{'T' if kind == 'prefill' else 'S'} = {t} (counted in {counted:.1f} s)", rep,
               busy, rates, card)
        del state, dry_state, cell
        free_device(torch, f"16b {label}")
    if "13a" not in DRY_STEPS:
        fail("16b: phase 13a's train step was not counted")
    for label, (rep, busy) in sorted(DRY_STEPS.items()):
        _share(f"phase {label}'s train step (depth {TRAIN_DEPTH}, {TRAIN_BATCH} x "
               f"{TRAIN_SEQ})", rep, busy, rates, card)


def phase_tooling(torch, rates, ranks, host_jobs, workdir):
    """Phase 16 (after 15): the launch tooling (module docstring).  The
    examples start first and run beside 16a (which counts on the host);
    16b profiles the card once every example has exited."""
    card = nvidia_smi_line()
    print(f"phase 16: launch tooling ({card})")
    t0 = time.perf_counter()
    examples = []
    for label, script, argv, want in EXAMPLES:
        path = str(Path(__file__).resolve().parent / "examples" / script)
        examples.append(dict(_start(label, [path, *[a.format(dir=workdir) for a in argv]],
                                    workdir, False), want=want))
    try:
        dry_cells_check(torch, ranks)
        t1 = time.perf_counter()
        for job in host_jobs:
            _, secs = _finish(job, TOOLING_TIMEOUT - (time.perf_counter() - job["t0"]))
            print(f"  16c {job['label']}: exit 0, its lines present ({secs:.1f} s since the run "
                  "started it)")
        merged = Path(workdir) / "dryrun.json"
        merged.write_text(json.dumps(sum((json.loads((Path(workdir) / f"{n}.json").read_text())
                                          for n in ("llama", "qwen3", "rwkv6", "whisper")),
                                         [])))
        report = _start("report", ["-m", "repro_torch.launch.report", str(merged)], workdir,
                        False)
        jobs = examples + [dict(report, want=[
            "| llama31_8b | train_4k | ok |", "| qwen3_30b_a3b | train_4k | ok |",
            "| rwkv6_7b | train_4k | ok |", "| whisper_medium | train_4k | ok |",
            "| whisper_medium | decode_32k | ok |",
            "cells: 26 ok / 6 skipped / 0 unported / 0 failed (of 32)"])]
        for job in jobs:
            text, secs = _finish(job, TOOLING_TIMEOUT)
            print(f"  16c {job['label']}: exit 0 in {secs:.1f} s, its lines present: "
                  + " | ".join(line.strip()[:110] for line in text.splitlines()
                               if any(w in line for w in job["want"]))[:600])
    finally:
        _stop_all(host_jobs + examples)
    t2 = time.perf_counter()
    dry_shares(torch, rates, card)
    t3 = time.perf_counter()
    print(f"phase 16 seconds: 16a {t1 - t0:.1f}, 16c after it {t2 - t1:.1f} (the examples "
          f"from the phase's start: {t2 - t0:.1f}), 16b {t3 - t2:.1f}")


def numerics(torch) -> None:
    """Full-precision float32 and bf16 GEMM reductions, in this process and
    in every rank it starts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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

    numerics(torch)
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

    import tempfile

    tooling = tempfile.TemporaryDirectory(prefix="tooling-")
    host_jobs = start_host_tools(tooling.name)
    try:
        return run_phases(torch, name, rates, card, host_jobs, tooling.name)
    finally:
        _stop_all(host_jobs)
        tooling.cleanup()


def run_phases(torch, name, rates, card, host_jobs, workdir) -> int:
    from repro_torch.kernels import _build

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
    phase_grouped_product(torch, timer, rates)
    phase_variant_kernels(torch, timer, rates, records)
    phase_skipping_kernels(torch, timer, rates, records)
    phase_window_kernels(torch, timer, rates, records)
    phase_recurrent_kernels(torch, timer, rates, records)
    phase_modality_kernels(torch, timer, rates, records)
    phase_family_int8_kernels(torch, timer, rates, records)
    phase_cell_kernels(torch, timer, rates, records)
    del timer
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    launches, model, params, policy, outputs, phase3 = serve_dense(torch, "3", "llama31_8b")
    t3 = time.perf_counter()
    phase_lifecycle(torch, model, params, policy, outputs)
    t3g = time.perf_counter()
    r_launches6g = phase_replicas(torch, model, params, policy, outputs)
    t3b = time.perf_counter()
    q_launches, outputs3b = phase_serve_osparse(torch, model, params, policy)
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
    phase_cli(torch)
    t8 = time.perf_counter()
    m_launches, mq_launches = phase_moe(torch, rates)
    t9 = time.perf_counter()
    phase_variants(torch)
    t10 = time.perf_counter()
    s_launches = phase_skipping(torch, phase3)
    t11 = time.perf_counter()
    x_launches = phase_mixtral(torch, rates)
    t12 = time.perf_counter()
    r_launches = phase_recurrent(torch, rates)
    t13 = time.perf_counter()
    md_launches = phase_modality(torch, rates)
    t14 = time.perf_counter()
    tr_launches = phase_training(torch, rates)
    t15 = time.perf_counter()
    tp_launches = phase_tp(torch)
    t16 = time.perf_counter()
    cell_launches, ranks = phase_cells(torch, rates)
    t17 = time.perf_counter()
    phase_tooling(torch, rates, ranks, host_jobs, workdir)
    t18 = time.perf_counter()
    print(f"phase seconds: build {t1 - t:.1f}, kernels {t2 - t1:.1f}, serve {t3 - t2:.1f}, "
          f"serve osparse {t4 - t3b:.1f}, parity {t5 - t4:.1f}, one-shot serve {t6 - t5:.1f}, "
          f"one-shot parity {t7 - t6:.1f}, serve CLI and serving lifecycle "
          f"{t8 - t7 + t3b - t3:.1f} (6b-6e {t3g - t3:.1f}, 6g and 6h {t3b - t3g:.1f}, "
          f"6a, 6a' and 6f {t8 - t7:.1f}), "
          f"MoE {t9 - t8:.1f}, dense variants {t10 - t9:.1f}, layer skipping {t11 - t10:.1f}, "
          f"Mixtral and the slab {t12 - t11:.1f}, the recurrent families {t13 - t12:.1f}, "
          f"the modality families {t14 - t13:.1f}, training {t15 - t14:.1f}, tensor "
          f"parallelism {t16 - t15:.1f}, sharded cells {t17 - t16:.1f}, launch tooling "
          f"{t18 - t17:.1f}; phases in all {t18 - t:.1f}; of them "
          + ", ".join(f"{k} {v:.1f}" for k, v in SUBPHASE_SECONDS.items()))

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import nm_prune as knp
    from repro_torch.kernels import nm_prune_matmul as knm
    from repro_torch.kernels import nm_spmm as kns
    from repro_torch.kernels import osparse_matmul as kos
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import w8a8_matmul as kw8
    # launches: each kernel's count in the run of the path that first served
    # it (phase 3, 3b, 5 or 7a); launches_by_run: its count in each main-path
    # run, each counted from 0, that launched it (6g over both replicas);
    # phases 6a, 6a', 7d and 10d's CLI
    # runs drive phase 3's and 7a's kernels again and print their own counts;
    # w8a8_matmul is an entry point that no serving path calls
    runs = {"3": launches, "3b": q_launches, "5": o_launches, "6g": r_launches6g,
            "7a": m_launches,
            "7e": mq_launches, **s_launches, **x_launches, **r_launches, **md_launches,
            **tr_launches, **tp_launches, **cell_launches}
    meta = {
        "nm_prune_matmul": (knm.SOURCE, knm.REPLACES, "3"),
        "paged_kv_scatter": (kpa.SOURCE, kpa.SCATTER_REPLACES, "3"),
        "paged_attention": (kpa.SOURCE, kpa.ATTENTION_REPLACES, "3"),
        "osparse_matmul": (kos.SOURCE, kos.REPLACES, "3b"),
        "w8a8_matmul": (kw8.SOURCE, kw8.REPLACES, "3b"),
        "nm_prune": (knp.SOURCE, knp.REPLACES, "7a"),
        "flash_attention": (kfa.SOURCE, kfa.REPLACES, "5"),
        "nm_spmm": (kns.SOURCE, kns.REPLACES, "5"),
    }
    line = {"kernels": [dict(name=k, route="cuda", source=src, replaces=rep,
                             launches=runs[first][k],
                             launches_by_run={r: c[k] for r, c in runs.items() if c[k]},
                             **records[k])
                        for k, (src, rep, first) in meta.items()]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
