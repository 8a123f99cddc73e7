"""Plain references of the benchmark's configurations, one module each
(``<config>.py``), on shared frozen copies (``plain.py``).  Plain PyTorch
and NumPy only: nothing here imports JAX, the JAX package or the port."""
