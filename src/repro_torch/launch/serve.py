"""Serving CLI of the port (port of ``repro/launch/serve.py``):
Amber-sparse prefill, dense decode, on the GPU.

One-shot batch mode — the dense and the Amber-sparse engine generate for
the same batch, and their greedy agreement is printed::

    python -m repro_torch.launch.serve --arch qwen2_7b --batch 4 \\
        --prompt-len 512 --new-tokens 32

Continuous-batching trace mode — Poisson arrivals through
:class:`repro_torch.serve.api.Engine`, then the per-request latency CSV,
throughput, latency percentiles, terminal states, lifecycle counters,
``trace_counts`` (graph captures per step program), dispatches per
iteration, the paged KV pool and the prefix cache::

    python -m repro_torch.launch.serve --arch llama31_8b --trace \\
        --num-requests 16 --rate 0.5 --len-range 64:700 --slots 4 --chunk 256

The flags, defaults and report lines are the JAX CLI's, with these
differences:

* ``--device`` (default ``cuda``): on the GPU the kernels always run; with
  ``--device cpu`` the plain PyTorch versions run (``--smoke`` configs).
  Asked for ``cuda`` without a GPU, the CLI raises; it never goes on on
  the CPU.
* No ``--pallas-kernels``.
* ``--dp N`` serves ``--trace`` on ``N`` replicas behind the router
  (``serve/router.py``), one after another on the one card, and reports
  each replica's tokens, iterations and dispatches per iteration, as the
  JAX CLI does.
* ``--tp N`` serves ``--trace`` tensor-parallel on ``N`` ranks: the CLI
  starts them (``launch.mesh.spawn``, a file store in the temporary
  directory), every rank builds the same model and engine and serves the
  same stream, each kernel of a step runs sharded (``distributed/tp.py``),
  and rank 0 prints the report.  The ranks live on the CPU with ``--device
  cpu``, else on the cards (all on one card where there is one); the
  backend is gloo either way, so every step runs eagerly (a CUDA graph
  cannot hold a gloo collective), and the CLI prints that choice first.
  One-shot mode takes no ``--tp``.
* ``--no-paged`` serves ``--trace`` on the dense per-slot slab, as the JAX
  CLI does; a sliding-window model (``mixtral_8x7b``) is served there
  without it, since its ring caches are never paged.
* ``--arch`` takes the families the port models: dense (``llama31_8b``,
  ``qwen2_7b``, ``qwen2_5_32b``, ``chatglm3_6b`` with its 2-D RoPE,
  ``stablelm_3b`` with LayerNorm and head_dim 80, and ``granite_34b``,
  whose 88 layers (88 GiB of bf16 weights) do not fit one 80 GB card:
  ``--smoke``) and MoE (``qwen3_30b_a3b``; ``llama4_scout_17b_a16e`` and
  ``mixtral_8x7b``, sliding-window attention with a 4096-row ring, whose
  full widths do not fit one card either: ``--smoke``) and the recurrent
  families (``rwkv6_7b``, attention-free, and ``recurrentgemma_2b``, RG-LRU
  blocks with local attention: both served on the dense slab in exact
  dyadic chunks) and the modality families (``whisper_medium``, the
  encoder-decoder, on the dense slab, and ``qwen2_vl_2b``, M-RoPE and patch
  embeddings, paged); other architectures raise in ``check_supported``.
* The weights are random from seed 0 (``model.init(0)``), and the prompts
  come from a seeded numpy generator, not from ``jax.random``: in trace
  mode the arrival gaps and prompt lengths are drawn from
  ``default_rng(--seed)`` exactly as the JAX CLI draws them, then the
  shared prefix and the prompts from the same generator; in one-shot mode
  the batch comes from ``default_rng(--seed + 1)``.  The modality stubs are
  standard normals, as the JAX CLI makes them, from numpy generators with
  the JAX CLI's seeds: one-shot ``frame_embeds``/``pixel_embeds (batch, S,
  d_model)`` from ``default_rng(2)``/``default_rng(3)``, rounded to bf16 as
  there; in trace mode request ``i``'s ``(1, S, d_model)`` float32 from
  ``default_rng(200 + i)``/``default_rng(300 + i)``, sent with its first
  prefill chunk.

:func:`main` is the command; :func:`run` does its work and also returns
the trace run's :class:`~repro_torch.serve.metrics.MetricsSnapshot`, for a
caller that checks more than the printed report.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    """The CLI: its exit code."""
    return run(argv)[0]


def run(argv=None):
    """Parse ``argv``, serve and print the report: ``(exit code, the
    ``--trace`` run's MetricsSnapshot, or None in one-shot mode)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_7b",
                    help="llama31_8b, qwen2_7b, qwen2_5_32b, chatglm3_6b, stablelm_3b, "
                         "granite_34b (--smoke on one card), qwen3_30b_a3b, "
                         "llama4_scout_17b_a16e, mixtral_8x7b (--smoke on one card), "
                         "rwkv6_7b, recurrentgemma_2b, whisper_medium, qwen2_vl_2b (their "
                         "frame/patch embeddings: standard normals from numpy generators "
                         "seeded 2/3 in one-shot mode, 200+i/300+i for --trace request i)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--sparsity", default="8:16")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--trace", action="store_true",
                    help="continuous batching: Poisson request "
                         "arrivals, mixed prompt lengths, per-request "
                         "latency + throughput + recapture report")
    ap.add_argument("--num-requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per scheduler iteration (Poisson)")
    ap.add_argument("--len-range", default="8:48",
                    help="uniform prompt-length range lo:hi for --trace")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-cache slots (decode batch bucket)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk size (prefill shape bucket)")
    ap.add_argument("--no-paged", action="store_true",
                    help="dense per-slot KV slab instead of the paged pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV rows per block (paged allocator)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="global block-pool size; default covers "
                         "slots*max_seq (no memory pressure) — size it "
                         "lower to exercise admission gating + preemption")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable block-level prefix caching across requests")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend the same N-token system prompt to every "
                         "--trace request (exercises the prefix cache)")
    ap.add_argument("--ttl", type=int, default=None, metavar="ITERS",
                    help="per-request deadline in scheduler iterations "
                         "(--trace): requests exceeding it end TIMED_OUT")
    ap.add_argument("--no-fused-step", action="store_true",
                    help="legacy two-program iterations (separate prefill "
                         "and decode programs) instead of the fused "
                         "one-dispatch step program")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel engine replicas behind the router (--trace), "
                         "one after another on the one device")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks per replica for --trace (started by the "
                         "CLI, gloo, eager steps; rank 0 prints the report)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.tp > 1:
        if not args.trace:
            raise ValueError("--tp serves --trace only (as the JAX CLI's)")
        import torch.distributed as dist

        if not dist.is_initialized():
            import sys

            from repro_torch.launch.mesh import spawn

            return spawn(_serve_rank, args.tp, list(sys.argv[1:] if argv is None else argv),
                         device=args.device)

    import time

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.policy import DENSE, paper_policy
    from repro_torch.core.pruner import precompute_scales
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    kernels = model.device.type == "cuda"

    n, m = (int(x) for x in args.sparsity.split(":"))
    policy = paper_policy(n, m, cfg.qgate_skip_layers).with_(use_kernels=kernels)
    params = precompute_scales(params, policy)  # offline Robust-Norm scales

    if args.trace:
        return _trace_mode(args, cfg, model, params, policy)

    scfg = ServeConfig(max_seq=args.prompt_len + args.new_tokens + 8,
                       temperature=args.temperature)
    engine = ServingEngine(model, policy, scfg)
    dense_engine = ServingEngine(model, DENSE.with_(use_kernels=kernels), scfg)
    rng = np.random.default_rng(args.seed + 1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)))}
    for key, (rows, d) in model.stub_shapes().items():
        batch[key] = torch.from_numpy(np.random.default_rng(STUB_SEEDS[key]).standard_normal(
            (args.batch, rows, d)).astype(np.float32)).to(torch.bfloat16)

    outs = []
    for name, eng in [("dense", dense_engine), (f"amber {n}:{m}", engine)]:
        t0 = time.perf_counter()
        toks = eng.generate(params, batch, max_new_tokens=args.new_tokens)["tokens"]
        if kernels:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        outs.append(toks.cpu())
        print(f"[{name:>10s}] generated {tuple(toks.shape)} in {dt:.2f}s; "
              f"first row: {toks[0, :12].tolist()}")
    agree = (outs[0] == outs[1]).float().mean()
    print(f"greedy-decode agreement dense vs sparse-prefill: {float(agree):.3f}")
    return 0, None


def _serve_rank(argv):
    """One rank of ``--tp``: the same run; only rank 0 prints."""
    import contextlib
    import io

    import torch.distributed as dist

    if dist.get_rank() == 0:
        return run(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        return run(argv)


# each modality stub's seed: the one-shot batch's, and ``100 * seed + i`` for
# request i of a trace
STUB_SEEDS = {"frame_embeds": 2, "pixel_embeds": 3}


def _trace_mode(args, cfg, model, params, policy):
    """Poisson-arrival request stream through the serving facade."""
    import numpy as np

    from repro_torch.serve.api import Engine, EngineConfig
    from repro_torch.serve.continuous import ContinuousConfig
    from repro_torch.serve.router import outputs_digest

    rng = np.random.default_rng(args.seed)
    lo, hi = (int(x) for x in args.len_range.split(":"))
    gaps = rng.exponential(1.0 / max(args.rate, 1e-9), args.num_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    lens = rng.integers(lo, hi + 1, args.num_requests)
    max_seq = hi + args.new_tokens + 8 + args.shared_prefix

    eng = Engine.from_config(model, EngineConfig(
        dp=args.dp, tp=args.tp, serving=ContinuousConfig(
            max_seq=max_seq, num_slots=args.slots, chunk_size=args.chunk,
            temperature=args.temperature, seed=args.seed,
            paged=not args.no_paged, block_size=args.block_size,
            num_blocks=args.num_blocks,
            prefix_cache=not args.no_prefix_cache,
            ttl_default=args.ttl, fused_step=not args.no_fused_step)),
        policy=policy, device=model.device)
    sysp = rng.integers(0, cfg.vocab_size, args.shared_prefix)
    extras = {}
    for i in range(args.num_requests):
        toks = rng.integers(0, cfg.vocab_size, int(lens[i]))
        if args.shared_prefix:
            toks = np.concatenate([sysp, toks])
        rid = eng.submit(toks, max_new_tokens=args.new_tokens, arrival=int(arrivals[i]))
        ex = {key: np.random.default_rng(100 * STUB_SEEDS[key] + i).standard_normal(
            (1, *shape)).astype(np.float32) for key, shape in model.stub_shapes().items()}
        if ex:
            extras[rid] = ex

    outputs = eng.run(params, extras=extras)["outputs"]
    m = eng.metrics          # typed MetricsSnapshot, merged over the replicas
    print(f"# {args.num_requests} requests, λ={args.rate}/iter, "
          f"lens {lo}..{hi}, slots={args.slots}, chunk={args.chunk}, "
          f"dp={args.dp}, tp={args.tp} "
          f"(metrics schema v{m.schema_version})")
    print("rid,prompt_len,arrival,state,first_token_iter,done_iter,"
          "latency_iters,latency_s,n_out,preemptions,retries")
    for r in sorted(m.requests, key=lambda r: r.rid):
        print(f"{r.rid},{r.prompt_len},{r.arrival},{r.state},"
              f"{r.first_token_iter},{r.done_iter},"
              f"{r.latency_iters},{r.latency_s:.3f},{r.n_out},"
              f"{r.preemptions},{r.retries}")
    print(f"# tokens: sha256 {outputs_digest(outputs)[:16]} over {len(outputs)} requests "
          "(the same for any --dp and --tp)")
    lat = [r.latency_iters for r in m.requests]
    print(f"# throughput: {m.generated_tokens} tokens in "
          f"{m.wall_s:.2f}s = {m.tokens_per_s:.1f} tok/s "
          f"over {m.iterations} iterations")
    print(f"# latency iters p50/p95: {int(np.percentile(lat, 50))}/"
          f"{int(np.percentile(lat, 95))}")
    lc = m.lifecycle
    ts = lc.terminal_states
    print(f"# terminal states: done={ts.get('done', 0)} "
          f"rejected={ts.get('rejected', 0)} "
          f"timed_out={ts.get('timed_out', 0)} "
          f"cancelled={ts.get('cancelled', 0)}")
    print(f"# lifecycle: degraded_iterations={m.degraded_iterations} "
          f"admission_retries={lc.admission_retries} "
          f"watchdog_trips={lc.watchdog_trips} "
          f"restores={lc.restores} faults_fired={lc.faults_fired}")
    terminal = ("done", "rejected", "timed_out", "cancelled")
    leaked = [r.rid for r in m.requests if r.state not in terminal]
    if leaked:
        print(f"# ERROR: {len(leaked)} request(s) leaked in a non-terminal "
              f"state at drain: rids {leaked}")
        return 1, m
    tc = ", ".join(f"{k}={v}" for k, v in sorted(m.trace_counts.items()))
    print(f"# traces: {tc} (shape buckets: chunk={args.chunk}, "
          f"decode batch={args.slots})")
    print(f"# dispatches: {m.dispatches} programs / "
          f"{m.iterations} iterations = "
          f"{m.dispatches_per_iteration:.2f} per work iteration "
          f"({'fused one-dispatch step' if not args.no_fused_step else 'legacy two-program split'})")
    per = ", ".join(f"r{i}: {p.generated_tokens} tok / {p.iterations} iters / "
                    f"dpi {p.dispatches_per_iteration:.2f}" for i, p in enumerate(m.replicas))
    print(f"# replicas ({len(m.replicas)}): {per}")
    pg = m.paged
    if not pg.enabled:
        print("# paged KV: disabled (dense per-slot slab)")
        return 0, m
    print(f"# paged KV: block_size={pg.block_size} "
          f"pool={pg.num_blocks} blocks "
          f"({pg.num_blocks * pg.block_size} rows vs "
          f"{args.slots * max_seq * args.dp} dense-slab rows); "
          f"peak_in_use={pg.peak_blocks_in_use} "
          f"preemptions={pg.preemptions} "
          f"rejections={pg.rejections}; "
          f"attention={'paged_attention CUDA kernel' if pg.attention_kernel else 'plain PyTorch gather'} "
          f"(--device cuda runs the kernel)")
    if pg.prefix_cache:
        pct = (100.0 * pg.tokens_skipped / max(pg.prefill_tokens, 1))
        print(f"# prefix cache: hits={pg.prefix_hits} requests, "
              f"blocks_reused={pg.blocks_reused}, "
              f"tokens_skipped={pg.tokens_skipped}/"
              f"{pg.prefill_tokens} ({pct:.0f}% of prefill rows), "
              f"cached_blocks={pg.cached_blocks}, "
              f"evictions={pg.evictions} "
              f"(--shared-prefix N to exercise; --no-prefix-cache "
              f"to disable)")
    else:
        print("# prefix cache: disabled")
    return 0, m


if __name__ == "__main__":
    raise SystemExit(main())
