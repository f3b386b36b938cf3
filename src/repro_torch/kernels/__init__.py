"""Hand-written Hopper kernels, each beside its plain PyTorch version and a
launch counter.

| kernel              | source                        | replaces (TPU kernel)                          |
| ------------------- | ----------------------------- | ---------------------------------------------- |
| ``nm_prune_matmul`` | ``csrc/nm_prune_matmul.cu``   | ``repro/kernels/nm_prune_matmul.py:67``        |
| ``nm_prune``        | ``csrc/nm_prune_matmul.cu``   | ``repro/kernels/nm_prune.py:58``               |
| ``nm_spmm``         | ``csrc/nm_spmm.cu``           | ``repro/kernels/nm_spmm.py:86``                |
| ``osparse_matmul``  | ``csrc/osparse_matmul.cu``    | ``repro/kernels/osparse_matmul.py:142``        |
| ``w8a8_matmul``     | ``csrc/osparse_matmul.cu``    | ``repro/kernels/w8a8_matmul.py:49``            |
| ``paged_kv_scatter``| ``csrc/paged_attention.cu``   | ``repro/kernels/paged_attention.py:263``       |
| ``paged_attention`` | ``csrc/paged_attention.cu``   | ``repro/kernels/paged_attention.py:130``       |
| ``flash_attention`` | ``csrc/flash_attention.cu``   | ``repro/kernels/flash_attention.py:116``       |

Libraries are built with ``nvcc`` at first use (``_build.py``).  On
``meta`` tensors (the dry-run) each wrapper is one unit (``_meta.py``): a
``meta`` result of its shape, and its reads, writes and products reported
to the step counter; nothing launches and no plain version runs.  Each
wrapper counts its launches; :func:`counters` reads every count (by kernel,
``osparse_matmul``'s pruned calls, the int8 GEMMs' and the attention
kernels' calls by route) as one
flat dict, which ``_capture.Graph`` adds to at every replay of a captured
step.
"""
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import nm_prune as _np
from repro_torch.kernels import nm_prune_matmul as _npm
from repro_torch.kernels import nm_spmm as _nms
from repro_torch.kernels import osparse_matmul as _osp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import w8a8_matmul as _w8

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts", "counters",
           "set_counters", "add_counters"]

# name → wrapper; each wrapper carries its ``launches`` count
KERNELS = {
    "nm_prune_matmul": _npm.nm_prune_matmul,
    "nm_prune": _np.nm_prune,
    "osparse_matmul": _osp.osparse_matmul,
    "w8a8_matmul": _w8.w8a8_matmul,
    "paged_kv_scatter": _pa.paged_kv_scatter,
    "paged_attention": _pa.paged_attention,
    "flash_attention": _fa.flash_attention,
    "nm_spmm": _nms.nm_spmm,
}


_ROUTED = {"osparse_matmul": _osp.osparse_matmul, "w8a8_matmul": _w8.w8a8_matmul,
           "paged_attention": _pa.paged_attention, "flash_attention": _fa.flash_attention}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def counters() -> dict:
    """Every launch counter: ``{kernel: launches, "osparse_matmul.pruned":
    n, "<routed kernel>.<route>": n}`` (the int8 GEMMs' and the attention
    kernels' routes)."""
    out = launch_counts()
    out["osparse_matmul.pruned"] = _osp.osparse_matmul.pruned_launches
    for name, fn in _ROUTED.items():
        out.update({f"{name}.{r}": c for r, c in fn.route_launches.items()})
    return out


def set_counters(values: dict) -> None:
    """Set the counters named in ``values`` (keys as :func:`counters` gives)."""
    for key, n in values.items():
        if key in KERNELS:
            KERNELS[key].launches = n
        elif key == "osparse_matmul.pruned":
            _osp.osparse_matmul.pruned_launches = n
        else:
            name, route = key.split(".")
            _ROUTED[name].route_launches[route] = n


def add_counters(delta: dict) -> None:
    now = counters()
    set_counters({key: now[key] + n for key, n in delta.items()})


def reset_launch_counts() -> None:
    set_counters(dict.fromkeys(counters(), 0))
