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

Libraries are built with ``nvcc`` at first use (``_build.py``).
"""
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import nm_prune as _np
from repro_torch.kernels import nm_prune_matmul as _npm
from repro_torch.kernels import nm_spmm as _nms
from repro_torch.kernels import osparse_matmul as _osp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import w8a8_matmul as _w8

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]

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


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _osp.osparse_matmul.pruned_launches = 0
    for fn in (_osp.osparse_matmul, _w8.w8a8_matmul):      # counts by route
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
