"""PyTorch / CUDA port of the single-video INN super-resolution framework.

Runs on an NVIDIA Hopper card (``sm_90a``). The JAX package ``sin_inn_tpu``
is the reference this package is tested against; nothing here imports it or
JAX. Public functions keep the reference's NHWC layout and names.

Ported so far: the SRF ``sr train`` and ``sr test`` entry points and the
validation step, with the fused 1x1 GLOW coupling forward and inverse and
their backward passes as hand-written CUDA kernels
(``ops/cuda/coupling.py``, ``csrc/coupling_1x1.cu``,
``csrc/coupling_1x1_bwd.cu``).
"""
