from repro_torch.runtime.ft import (FaultTolerantLoop, StragglerWatchdog,
                                    FailureInjector)
from repro_torch.runtime.compress import (compress_ef_int8, decompress_int8,
                                          init_residuals,
                                          make_compression_hook)
