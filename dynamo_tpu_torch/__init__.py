"""dynamo-tpu on PyTorch and CUDA: the serving engine ported to an NVIDIA
H100. Plain tensor code is PyTorch; the attention kernel of the main path
is CUDA C++ written for Hopper (``csrc/``), built at first use.

The package imports torch, numpy and the standard library only. Module
names follow the JAX package so each part has an obvious counterpart.
"""
