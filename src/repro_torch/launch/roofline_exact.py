"""Roofline by layer extrapolation, checked against the full count (port of
``repro/launch/roofline_exact.py``).

XLA's cost analysis counts a ``while`` body once whatever its trip count,
so the reference rebuilds each cell in an ANALYSIS configuration with every
loop that matters removed:

  * the layers at 1 and 2 periods of the block pattern,
  * attention in a single chunk (``attn_chunk ≥ seq``),
  * ``grad_accum = 1``;

then two-point-extrapolates every term over the layer axis:

  slope = cost(2p) − cost(1p);  total = cost(1p) − slope + slope·P_full
  (+ tail_layers/period_len · slope for non-multiple hybrids)

The port counts every op it executes (``launch/dryrun.py``), so in the same
analysis configuration the extrapolation must equal the full-depth count
exactly: here it is a check, not a correction.  A cell whose extrapolation
parts from its full count is a ``FAIL``.  Where the policy's q/gate skip
list reaches the full depth, the skipped layers' slope is a second pair of
points (1 and 2 periods, every layer skipped), so the check holds there too
(the reference extrapolates from unskipped layers alone).

    PYTHONPATH=src python -m repro_torch.launch.roofline_exact \\
        [--arch X] [--shape Y] [--json out.json] [--variant per_token|...]
"""
import argparse
import dataclasses
import json
import sys
import traceback


def _analysis_cfg(cfg, n_periods: int, seq: int):
    plen = len(cfg.block_pattern)
    kw = dict(
        n_layers=n_periods * plen,
        scan_layers=False,
        attn_chunk=max(seq, cfg.window + 8),
    )
    if cfg.is_encdec:
        kw["n_encoder_layers"] = n_periods
    return dataclasses.replace(cfg, **kw)


_TERMS = ("flops", "bytes", "coll", "compute_s", "memory_s", "collective_s")


def _cell_costs(arch, cfg, shape_name, mesh, policy):
    """The six linear terms of one counted cell (``_TERMS``: per device),
    or the run's result dict where it is not ``ok``."""
    from repro_torch.launch.dryrun import run_cell

    r = run_cell(arch, shape_name, policy=policy, cfg=cfg, mesh=mesh, grad_accum=1)
    if r["status"] != "ok":
        return r
    rf = r["roofline_s"]
    return (float(r["flops_per_device"]), float(r["hbm_bytes_per_device"]),
            float(r["collective_bytes_per_device"]), rf["compute"], rf["memory"],
            rf["collective"])


def _signatures(policy, n_layers: int):
    """{frozenset of modules the skip list exempts at a layer: layers},
    for every layer the list reaches."""
    out = {}
    for i in range(n_layers):
        sig = frozenset(mod for mod, idxs in policy.skip_layers if i in idxs)
        if sig:
            out[sig] = out.get(sig, 0) + 1
    return out


def _equal(got, want) -> bool:
    """The counts (flops, bytes, collective bytes) exactly; the seconds,
    sums of float quotients, to 1e-9."""
    return tuple(got[:3]) == tuple(want[:3]) and all(
        abs(g - w) <= 1e-9 * max(abs(w), 1e-30) for g, w in zip(got[3:], want[3:]))


def run_cell_exact(arch: str, shape_name: str, policy=None, multi_pod: bool = False):
    """One cell's extrapolated terms, checked against its full-depth count."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import paper_policy
    from repro_torch.launch import roofline
    from repro_torch.launch.cells import cell_by_name, is_runnable
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = cell_by_name(shape_name)
    ok, why = is_runnable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "why": why}
    if policy is None:
        policy = paper_policy(8, 16, qgate_skip_layers=())

    mesh = make_production_mesh(multi_pod=multi_pod)
    plen = len(cfg.block_pattern)
    p_full, tail = divmod(cfg.n_layers, plen)

    def costs(n_periods, pol):
        return _cell_costs(arch, _analysis_cfg(cfg, n_periods, shape.seq_len), shape_name,
                           mesh, pol)

    plain = policy.with_(skip_layers={})
    c1, c2 = costs(1, plain), costs(2, plain)
    for c in (c1, c2):
        if isinstance(c, dict):
            return {**c, "mesh": mesh_name}
    slope = tuple(b - a for a, b in zip(c1, c2))
    total = [max(a - s, 0.0) + s * (p_full + tail / plen) for a, s in zip(c1, slope)]
    for sig, n in _signatures(policy, cfg.n_layers).items():
        every = policy.with_(skip_layers={mod: range(2 * plen) for mod in sig})
        k1, k2 = costs(1, every), costs(2, every)
        total = [t + n / plen * ((b - a) - s) for t, a, b, s in zip(total, k1, k2, slope)]

    full = _cell_costs(arch, dataclasses.replace(
        _analysis_cfg(cfg, 1, shape.seq_len), n_layers=cfg.n_layers,
        n_encoder_layers=cfg.n_encoder_layers), shape_name, mesh, policy)
    if isinstance(full, dict):
        return {**full, "mesh": mesh_name}
    if not _equal(total, full):
        raise AssertionError(f"{arch} × {shape_name}: the extrapolation "
                             f"{dict(zip(_TERMS, total))} parts from the full-depth count "
                             f"{dict(zip(_TERMS, full))}")
    flops, bytes_acc, coll, compute_s, memory_s, coll_s = total

    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    n_dev = mesh.size
    mf = roofline.model_flops(cfg, tokens, shape.kind)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "flops_per_device": flops,
        "hbm_bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll,
        "roofline_s": terms,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(flops * n_dev, 1.0),
        "dominant": max(terms.items(), key=lambda kv: kv[1])[0],
        "full_depth_equal": True,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--variant", default="per_token",
                    choices=["dense", "per_token", "tile_consensus"])
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ARCH_IDS, PAPER_ARCH_IDS, SHAPE_CELLS, get_config
    from repro_torch.core.policy import DENSE, paper_policy

    archs = [args.arch] if args.arch else list(ARCH_IDS) + list(PAPER_ARCH_IDS)
    shapes = [args.shape] if args.shape else [c.name for c in SHAPE_CELLS]

    results = []
    fails = 0
    for arch in archs:
        for shape in shapes:
            cfgq = get_config(arch)
            pol = {
                "dense": DENSE,
                "per_token": paper_policy(8, 16, cfgq.qgate_skip_layers),
                "tile_consensus": paper_policy(
                    8, 16, cfgq.qgate_skip_layers, tile_consensus=True),
            }[args.variant]
            tag = f"{arch} × {shape}"
            try:
                r = run_cell_exact(arch, shape, policy=pol,
                                   multi_pod=args.multi_pod)
            except Exception as e:
                traceback.print_exc()
                r = {"arch": arch, "shape": shape, "status": "FAIL",
                     "error": str(e)[:200]}
                fails += 1
            r["variant"] = args.variant
            results.append(r)
            if r["status"] == "ok":
                rf = r["roofline_s"]
                print(f"[exact] {tag}: c={rf['compute']:.3e} "
                      f"m={rf['memory']:.3e} x={rf['collective']:.3e} "
                      f"dom={r['dominant']} useful={r['useful_flops_ratio']:.3f} "
                      f"(= the full-depth count)",
                      flush=True)
            else:
                print(f"[exact] {tag}: {r['status']} {r.get('why', r.get('error',''))}",
                      flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
