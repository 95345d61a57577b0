"""Fleet worker server: the campaign eval-spec protocol over TCP.

The port's twin of the JAX package's ``scripts/remote_worker.py``.  It
serves the exact line-JSON protocol ``repro_torch.core.worker_main``
speaks over stdio — one spec in, one ``OptResult`` wire dict out — on a
TCP socket instead, so a ``RemoteExecutor`` on another machine can stream
jobs to this host.  Each accepted connection is one worker *slot*,
served in its own thread against a process-shared ``_SpecServer`` (warm
platform/cache handles are reused across slots and campaigns).  Slots on
one card share its device lease with every other worker there.

Startup prints ``READY <port>`` on stdout (port 0 binds an ephemeral
port — how the spawn transport's simulated fleet finds it); after that,
stdout points at stderr, so nothing printed later can fill a pipe no one
reads.  ``--alias`` sets ``REPRO_HOST_ALIAS``, giving the server a
fleet-wide host identity: the measured-cache namespace, the timing-lease
scope, and all journal ``host`` provenance key on it, so N loopback
servers on one machine behave exactly like N distinct hosts.

Run on a fleet machine (then point a ``FleetHost(transport="socket",
address="thathost:7077")`` at it):

    PYTHONPATH=src python -m repro_torch.core.remote_worker \\
        --bind 0.0.0.0 --port 7077

Security note: the protocol is unauthenticated — bind to loopback (the
default) or a trusted network only, or use the ssh transport instead.
"""
import argparse
import json
import os
import socket
import sys
import threading


def serve_connection(conn: socket.socket, state) -> None:
    """One slot: read spec lines, answer reply lines, until the peer
    hangs up.  The byte buffer decodes only complete lines, so UTF-8
    sequences split across TCP segments are never torn."""
    from repro_torch.core.evalcache import json_safe
    buf = b""
    try:
        while True:
            chunk = conn.recv(65536)
            if not chunk:
                return
            buf += chunk
            while True:
                nl = buf.find(b"\n")
                if nl < 0:
                    break
                line, buf = buf[:nl], buf[nl + 1:]
                if not line.strip():
                    continue
                drops = []
                try:
                    spec = json.loads(line.decode("utf-8",
                                                  errors="replace"))
                except ValueError as e:
                    reply = {"ok": False, "type": "ProtocolError",
                             "error": f"{e}"[:500]}
                else:
                    reply, drops = state.handle_with_faults(spec)
                data = (json.dumps(json_safe(reply), default=str)
                        + "\n").encode()
                if drops:
                    # scripted drop_connection: tear the reply mid-line
                    # and hang up — the scheduler must survive a torn
                    # line as EOF (crash fault → retry), never parse it
                    conn.sendall(data[:max(1, len(data) // 2)])
                    return
                conn.sendall(data)
    except OSError:
        pass                      # peer reset: the slot is simply gone
    finally:
        try:
            conn.close()
        except OSError:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="campaign fleet worker server (eval-spec protocol "
                    "over TCP)")
    ap.add_argument("--bind", default="127.0.0.1",
                    help="address to listen on (default loopback; the "
                         "protocol is unauthenticated)")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed as READY)")
    ap.add_argument("--alias", default="",
                    help="fleet host identity (sets REPRO_HOST_ALIAS: "
                         "namespaces, lease scope, journal provenance)")
    args = ap.parse_args(argv)
    if args.alias:
        os.environ["REPRO_HOST_ALIAS"] = args.alias

    # import AFTER the alias is set: module state derived from host
    # identity (default namespaces) must see it
    from repro_torch.core.evalcache import this_host
    from repro_torch.core.workers import _SpecServer

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.bind, args.port))
    srv.listen(64)
    port = srv.getsockname()[1]
    print(f"READY {port}", flush=True)
    os.dup2(2, 1)
    print(f"# fleet worker {this_host()} serving on {args.bind}:{port}",
          file=sys.stderr, flush=True)

    state = _SpecServer()
    while True:
        try:
            conn, peer = srv.accept()
        except OSError:
            return 0              # listening socket closed: shut down
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        threading.Thread(target=serve_connection, args=(conn, state),
                         name=f"slot-{peer[0]}:{peer[1]}",
                         daemon=True).start()


if __name__ == "__main__":
    sys.exit(main())
