"""Perf-iteration harness: A/B roofline comparison of cell variants (port of
``repro/launch/perf.py``).

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen2_5_32b \\
        --shape prefill_32k --variants dense,per_token,tile_consensus

Each variant counts the cell anew on a dry rank (``launch/dryrun.py``) and
prints the three roofline terms on the H100, so a hypothesis → change →
measure cycle is one command.  Variants:
  dense           no sparsity (pure baseline)
  per_token       paper-faithful Amber 8:16 (per-token masks, ``nm_prune_matmul``)
  tile_consensus  compacted matmul 8:16 (``nm_spmm``: the (M/N)× GEMM cut)
  per_token_24 / tile_consensus_24   same at 2:4
The reference's docstring also names ``w8a8`` (an estimate of int8 weights'
memory term), which its ``variant_policy`` does not implement: it raises
``ValueError`` there, and here too.
"""
import argparse
import json


def variant_policy(name: str, cfg):
    from repro_torch.core.policy import DENSE, paper_policy

    if name == "dense":
        return DENSE
    if name == "per_token":
        return paper_policy(8, 16, cfg.qgate_skip_layers)
    if name == "tile_consensus":
        return paper_policy(8, 16, cfg.qgate_skip_layers,
                            tile_consensus=True)
    if name == "per_token_24":
        return paper_policy(2, 4, cfg.qgate_skip_layers)
    if name == "tile_consensus_24":
        return paper_policy(2, 4, cfg.qgate_skip_layers, tile_consensus=True)
    raise ValueError(name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="dense,per_token,tile_consensus")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import run_cell

    results = []
    base = None
    for v in args.variants.split(","):
        pol = variant_policy(v, get_config(args.arch))
        r = run_cell(args.arch, args.shape, args.multi_pod, policy=pol)
        r["variant"] = v
        results.append(r)
        if r["status"] != "ok":
            print(f"{v:18s} {r['status']} {r.get('why', '')}", flush=True)
            continue
        rf = r["roofline_s"]
        line = (f"{v:18s} compute={rf['compute']:.3e} "
                f"memory={rf['memory']:.3e} coll={rf['collective']:.3e} "
                f"dom={r['dominant']}")
        if base is not None:
            brf = base["roofline_s"]
            line += ("   Δ vs dense: "
                     f"compute×{rf['compute']/max(brf['compute'],1e-30):.2f} "
                     f"memory×{rf['memory']/max(brf['memory'],1e-30):.2f} "
                     f"coll×{rf['collective']/max(brf['collective'],1e-30):.2f}")
        else:
            base = r
        print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
