"""The serving engine, model math, sampler, attention kernels and weight
conversion of the PyTorch backend."""
