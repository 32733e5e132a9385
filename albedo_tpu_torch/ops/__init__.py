"""Device operations: the ALS solves (K1-K3) and the top-k (K5), each a CUDA kernel wrapper with its plain PyTorch version."""
