"""Plain PyTorch references of the benchmark's configurations: float32, TF32
off, no kernels, no cache, no batching.  Nothing here imports the program
(``calfkit_tpu_torch``), the JAX package or JAX."""
