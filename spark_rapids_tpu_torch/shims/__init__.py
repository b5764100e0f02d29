from spark_rapids_tpu_torch.shims.loader import ShimLoader, TpuShims  # noqa: F401
