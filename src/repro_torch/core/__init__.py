from repro_torch.core.policy import DENSE, SparsityPolicy, paper_policy

__all__ = ["DENSE", "SparsityPolicy", "paper_policy"]
