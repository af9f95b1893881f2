"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``*_plain``), plus ``ops`` (padding and dispatch) and ``build``
(nvcc + ctypes)."""
