"""Plain PyTorch references of the two models and their training steps.

They import nothing of the program, of the JAX package or of JAX: only
``torch``, ``numpy`` and the benchmark's own ``cost`` shapes. Each takes the
benchmark's weights and inputs by name and computes in the precision it is
asked for (``precision.py``).
"""
