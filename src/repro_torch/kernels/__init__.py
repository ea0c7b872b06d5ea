"""Hand-written CUDA kernels for the port's hot path (``csrc/*.cu``, built
with nvcc at first use and bound with ctypes), their plain PyTorch
versions (``ref``) and the device dispatch (``ops``)."""
