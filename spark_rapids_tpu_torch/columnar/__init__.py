from spark_rapids_tpu_torch.columnar import dtype as dtypes  # noqa: F401
from spark_rapids_tpu_torch.columnar.batch import (  # noqa: F401
    DeviceBatch,
    Schema,
    bucket_capacity,
)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn  # noqa: F401
