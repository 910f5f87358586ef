"""runtime of the PyTorch/CUDA port: metrics and tracing (see the package docstring)."""
