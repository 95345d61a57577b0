"""Campaign worker process entry point (spawned by ``SubprocessExecutor`` /
``LocalClusterExecutor``): the port's twin of the JAX package's
``scripts/worker_main.py``.

Protocol: line-JSON over stdio.  Each stdin line is one serialized eval
spec (``repro_torch.core.workers.job_to_spec``); each stdout line is the
full ``OptResult`` wire dict (or an error record).  The protocol channel
is taken before anything else is imported, so whatever torch, nvcc,
Triton or ctypes print goes to stderr.

Runnable by hand for debugging:

    echo '{"ping": true}' | PYTHONPATH=src python -m repro_torch.core.worker_main
"""
import os
import sys


def protocol_channel():
    """Take fd 1 (the pipe to the scheduler) as the protocol channel and
    point stdout at stderr, so nothing else the worker prints can reach a
    protocol line."""
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = os.fdopen(1, "w", buffering=1)
    return proto


def main() -> int:
    proto = protocol_channel()
    from repro_torch.core.workers import serve_stdio
    return serve_stdio(proto)


if __name__ == "__main__":
    sys.exit(main())
