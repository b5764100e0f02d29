"""spark-rapids-tpu on PyTorch and CUDA: the port of the JAX package
``spark_rapids_tpu`` to NVIDIA Hopper GPUs.

Module paths mirror the JAX package. Device columns are torch tensors; the
JAX package's Pallas kernels become hand-written CUDA kernels
(``csrc/``, built at first use by ``ops/cudalib.py``), each with a plain
PyTorch version that runs for CPU tensors. This package imports torch,
numpy, pandas and pyarrow, and never JAX or ``spark_rapids_tpu``.
"""
