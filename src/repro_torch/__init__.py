"""PyTorch / CUDA port of the EAT serving stack (``repro`` is the JAX
reference it is tested against; this package imports nothing of it).

Layout mirrors the JAX package: ``configs/``, ``models/``, ``kernels/``
(one hand-written CUDA C++ kernel per TPU kernel on the serving path, with
its plain PyTorch version beside it; sources under ``csrc/``), ``core/``,
``serving/``, ``launch/``, ``data/``.
"""
