from repro_torch.layers.linear import Linear, dense_linear, init_linear, sparse_linear

__all__ = ["Linear", "dense_linear", "init_linear", "sparse_linear"]
