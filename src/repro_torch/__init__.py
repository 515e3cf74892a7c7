"""PyTorch/CUDA port of the CHASE engine (``src/repro`` is the JAX
reference).  Entry points place tables and run kernels on ``cuda`` unless
the caller asks for the CPU."""
