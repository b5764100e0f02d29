from spark_rapids_tpu_torch.ml.columnar_rdd import ColumnarRdd  # noqa: F401
