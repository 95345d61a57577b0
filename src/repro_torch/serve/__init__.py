from repro_torch.serve.decode import (  # noqa: F401
    BatchedServer, FixedBatchServer, Request, generate,
)
from repro_torch.serve.autotune import (  # noqa: F401
    AutotuneConfig, AutotuneReport, ServeAutotuner, bucket_key, snap_scale,
    split_bucket_key,
)
