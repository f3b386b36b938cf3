"""Render a dry-run's JSON (``launch/dryrun.py --json``) into roofline
tables (port of ``repro/launch/report.py``).

    PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json

The reference's table, with its memory column the port's ``total`` (the
arguments plus the step's peak, GiB) and, in parentheses, the arguments
alone (the reference's TPU-only estimate has no counterpart).  A cell the
port refuses reads ``UNPORTED`` with its reason.
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def render(results, mesh="16x16"):
    rows = [r for r in results if r.get("mesh") == mesh]
    out = []
    out.append(
        "| arch | shape | status | mem/dev GiB (args) | compute s | "
        "memory s | collective s | dominant | MODEL_FLOPS | useful ratio |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP ({r['why']}) "
                       f"| — | — | — | — | — | — | — |")
            continue
        if r["status"] == "unported":
            out.append(f"| {r['arch']} | {r['shape']} | UNPORTED ({r['why']}) "
                       f"| — | — | — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | FAIL | — | — | — "
                       f"| — | — | — | — |")
            continue
        b = r["bytes_per_device"]
        rf = r["roofline_s"]
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | "
            f"{fmt_bytes(b['total'])} ({fmt_bytes(b['args'])}) | "
            f"{rf['compute']:.3e} | {rf['memory']:.3e} | "
            f"{rf['collective']:.3e} | **{r['dominant']}** | "
            f"{r['model_flops']:.2e} | {r['useful_flops_ratio']:.3f} |")
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "dryrun_results.json"
    with open(path) as f:
        results = json.load(f)
    for mesh in ("16x16", "2x16x16"):
        print(f"\n### Mesh {mesh}\n")
        print(render(results, mesh))
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skipped" for r in results)
    unported = sum(r["status"] == "unported" for r in results)
    fail = len(results) - ok - skip - unported
    print(f"\ncells: {ok} ok / {skip} skipped / {unported} unported / {fail} failed "
          f"(of {len(results)})")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
