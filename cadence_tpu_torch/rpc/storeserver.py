"""Store server: the persistence role as its own process.

The reference's history hosts share a database (Cassandra/MySQL) that is
the single authority for fenced writes (range-ID CAS) — so shard fencing
works ACROSS hosts because the CAS evaluates at the store, not in any
host's memory. This process plays that role: it owns the authoritative
`Stores` bundle (optionally durable via the WAL) and serves

  ("store", sub, method, args, kwargs)  → getattr(stores.<sub>, method)(...)
  ("hb", name, port, advertised_host)   → membership heartbeat upsert
  ("peers", ttl_seconds)                → [(host, port)] with fresh beats
  ("ping",)                             → "pong"

Membership is the ringpop analog reduced to its observable contract
(SURVEY §2.6): hosts that heartbeat are in the ring; hosts that stop are
dropped after a TTL and their shards get stolen — the steal is safe
because every store write from the deposed owner still fails the range
CAS HERE, whatever that host believes about its liveness.

The store's own device work is the visibility store's columnar twin
(engine/visibility_device.py, off unless CADENCE_TPU_VISIBILITY enables
it); it runs on the device `--device` names, the card by default. Boot
recovery from the WAL is the host-only oracle path and names no device.

Run: python -m cadence_tpu_torch.rpc.storeserver --port P [--wal PATH]
         [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import socketserver
import threading
import time
from contextlib import nullcontext
from typing import Dict, Tuple

from ..engine.persistence import Stores
from ..utils import deadline as deadline_mod
from ..utils import tracing
from ..utils.deadline import DeadlineExceeded
from .wire import recv_frame, send_frame, verify_hello


class StoreServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address: Tuple[str, int], stores: Stores) -> None:
        super().__init__(address, _Handler)
        self.stores = stores
        self._beats: Dict[Tuple[str, int], float] = {}
        self._beats_lock = threading.Lock()

    def heartbeat(self, name: str, port: int,
                  address: str = "127.0.0.1") -> None:
        """`address` is the beater's ADVERTISED host — what peers and
        remote clusters must dial (loopback only works single-machine;
        containers advertise their service name)."""
        with self._beats_lock:
            self._beats[(name, port)] = (time.monotonic(), address)

    def peers(self, ttl: float):
        """[(name, port, address)] of live beaters."""
        now = time.monotonic()
        with self._beats_lock:
            return sorted((n, p, addr)
                          for (n, p), (t, addr) in self._beats.items()
                          if now - t <= ttl)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        """One connection, many frames; op errors report to the caller,
        only THIS socket's failures end the connection (see server.py)."""
        server: StoreServer = self.server  # type: ignore[assignment]
        try:
            verify_hello(self.request)  # before the first pickle load
        except (OSError, ConnectionError):
            return
        while True:
            try:
                req = recv_frame(self.request)
            except (OSError, ConnectionError):
                return
            # engine transactions traced at a service host propagate here
            # too, so store round-trips appear inside the same trace; the
            # caller's deadline budget rides the same carrier
            remote_deadline = deadline_mod.peek(req)
            remote_ctx, req = tracing.extract(req)
            try:
                op = req[0]
                if remote_deadline is not None and remote_deadline.expired():
                    from ..utils.metrics import DEFAULT_REGISTRY
                    DEFAULT_REGISTRY.inc("rpc.server",
                                         "deadline-expired-rejections")
                    raise DeadlineExceeded(
                        f"store rpc.{op} arrived with its deadline expired")
                span_cm = (tracing.DEFAULT_TRACER.start_span(
                               f"rpc.{op}", child_of=remote_ctx)
                           if remote_ctx is not None else nullcontext())
                with span_cm, deadline_mod.bind(remote_deadline):
                    result = self._dispatch(server, req)
                response = ("ok", result)
            except BaseException as exc:  # service errors cross the wire
                response = ("err", exc)
            try:
                send_frame(self.request, response)
            except (OSError, ConnectionError):
                return
            except Exception:
                try:
                    send_frame(self.request,
                               ("err", RuntimeError(repr(response[1]))))
                except Exception:
                    return

    @staticmethod
    def _dispatch(server: "StoreServer", req):
        op = req[0]
        if op == "store":
            _, sub, method, args, kwargs = req
            target = getattr(server.stores, sub)
            return getattr(target, method)(*args, **kwargs)
        if op == "hb":
            server.heartbeat(req[1], req[2],
                             req[3] if len(req) > 3 else "127.0.0.1")
            return None
        if op == "peers":
            return server.peers(req[1])
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown op {op!r}")


#: env spec for seeded store-fault injection in a store-server PROCESS
#: (the subprocess analog of calling engine/faults.inject_faults in-proc):
#:   CADENCE_TPU_STORE_FAULTS="rate=0.05,seed=7"
STORE_FAULTS_ENV = "CADENCE_TPU_STORE_FAULTS"


def _parse_fault_spec(spec: str):
    """"rate=0.05,seed=7[,writes_only=0]" → FaultInjector. Injected
    errors raise BEFORE the store method runs (engine/faults.py), so a
    caller retry is always safe — the property the chaos soak leans on."""
    from ..engine.faults import FaultInjector
    from .chaos import parse_kv_spec

    def to_bool(value: str) -> bool:
        return value.lower() not in ("0", "false", "no", "off", "")

    kwargs = parse_kv_spec(
        spec, {"rate": float, "seed": int, "writes_only": to_bool})
    return FaultInjector(**kwargs)


def serve(port: int, wal: str = "", host: str = "127.0.0.1",
          fault_spec: str = "", device=None) -> None:
    import os

    if wal:
        from ..engine.durability import open_durable_stores, recover_stores
        if os.path.exists(wal):
            stores, _report = recover_stores(wal, verify_on_device=False,
                                             rebuild_on_device=False)
        else:
            stores = open_durable_stores(wal)
    else:
        stores = Stores()
    if device is not None:
        import torch

        stores.visibility.device = torch.device(device)
    fault_spec = fault_spec or os.environ.get(STORE_FAULTS_ENV, "")
    if fault_spec:
        from ..engine.faults import inject_faults
        inject_faults(stores, _parse_fault_spec(fault_spec))
    server = StoreServer((host, port), stores)
    server.serve_forever()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cadence-tpu-store")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--wal", default="")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (0.0.0.0 in containers; the HMAC "
                        "connection preamble still gates every peer)")
    p.add_argument("--fault-spec", default="",
                   help="seeded store-fault injection, e.g. "
                        "'rate=0.05,seed=7' (CADENCE_TPU_STORE_FAULTS "
                        "env equivalent; chaos soak harness)")
    p.add_argument("--device", default=None,
                   help="device of the visibility store's columnar twin "
                        "(cuda, cpu); default the card")
    args = p.parse_args(argv)
    serve(args.port, args.wal, host=args.host, fault_spec=args.fault_spec,
          device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
