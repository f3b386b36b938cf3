from repro_torch.core.policy import DENSE, SparsityPolicy, paper_policy
from repro_torch.core.sensitivity import (coverage, linear_flops, relative_perturbation,
                                          select_qgate_skips, sensitivity_scan,
                                          targeted_policy)

__all__ = ["DENSE", "SparsityPolicy", "paper_policy", "relative_perturbation",
           "targeted_policy", "sensitivity_scan", "select_qgate_skips", "linear_flops",
           "coverage"]
