"""The plain PyTorch and NumPy reference the benchmark holds the port against.

It imports nothing of the port (``nextou_tpu_torch``) nor of the JAX package.
"""
