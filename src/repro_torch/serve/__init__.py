from repro_torch.serve.decode import (  # noqa: F401
    BatchedServer, Request, generate,
)
