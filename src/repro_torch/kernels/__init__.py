"""Hand-written Hopper kernels of the port, one package per TPU kernel of
the JAX package, each with its plain PyTorch version beside it."""
