"""PyTorch/CUDA port of the Model Asset eXchange (``repro``).

A sibling of the JAX package, not a part of it: nothing here imports
``jax`` or ``repro``. Module names follow the JAX package so each
counterpart is easy to find. Entry points run on the GPU (``device="cuda"``)
unless the caller asks for the CPU, as the tests do.
"""
