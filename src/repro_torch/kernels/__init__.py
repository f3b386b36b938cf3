"""Hand-written Hopper kernels of the serving path, each beside its plain
PyTorch version and a launch counter.

| kernel              | source                        | replaces (TPU kernel)                          |
| ------------------- | ----------------------------- | ---------------------------------------------- |
| ``nm_prune_matmul`` | ``csrc/nm_prune_matmul.cu``   | ``repro/kernels/nm_prune_matmul.py:67``        |
| ``paged_kv_scatter``| ``csrc/paged_attention.cu``   | ``repro/kernels/paged_attention.py:263``       |
| ``paged_attention`` | ``csrc/paged_attention.cu``   | ``repro/kernels/paged_attention.py:130``       |

Libraries are built with ``nvcc`` at first use (``_build.py``).
"""
from repro_torch.kernels import nm_prune_matmul as _npm
from repro_torch.kernels import paged_attention as _pa

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]

# name → wrapper; each wrapper carries its ``launches`` count
KERNELS = {
    "nm_prune_matmul": _npm.nm_prune_matmul,
    "paged_kv_scatter": _pa.paged_kv_scatter,
    "paged_attention": _pa.paged_attention,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
