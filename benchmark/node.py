"""The system under test: one singleton cnosdb_tpu_torch node in this
process, wired as `cnosdb_tpu_torch.server.http.run_server` wires one
from the default Config, with its HTTP listener on a local port.

Left out of run_server's start-up, because no request of the benchmark
reaches them: the OpenTSDB telnet listener and the Flight SQL server
(both on fixed ports) and the hourly TTL sweep. The default Config has
no scrubber, tiering, WAL archive, OTLP exporter or TLS.
"""
from __future__ import annotations

import asyncio
import os
import socket
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LOAD_WORKERS = 8           # preload threads into Coordinator.write_points
LOAD_HOSTS = 25            # hosts in one preload write


class Node:
    def __init__(self, data_dir: str):
        from cnosdb_tpu_torch.config import Config
        from cnosdb_tpu_torch.server import http
        from cnosdb_tpu_torch.utils import executor

        # Config.load with no path applies CNOSDB_* overrides from the
        # environment; the benchmark sets none
        self.cfg = Config.load(None)
        executor.configure(self.cfg.query)
        self.server = http.build_server(
            data_dir, auth_enabled=self.cfg.query.auth_enabled,
            wal_sync=self.cfg.wal.sync, query_cfg=self.cfg.query)
        self.coord = self.server.coord
        self.port = None
        self._loop = None
        self._thread = None
        self._runner = None

    # ---------------------------------------------------------- set-up
    def sql(self, text: str, db: str = "public"):
        from cnosdb_tpu_torch.sql.executor import Session

        return self.server.executor.execute_one(text, Session(database=db))

    def create_database(self, cfg: dict) -> None:
        self.sql(f"CREATE DATABASE {cfg['database']} WITH SHARD "
                 f"{cfg['shard']} REPLICA {cfg['replica']}")

    def preload(self, cfg: dict, tags: list, ts: np.ndarray,
                hist: np.ndarray) -> None:
        """Write the history through Coordinator.write_points, columnar,
        LOAD_HOSTS series a write on LOAD_WORKERS threads."""
        from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
        from cnosdb_tpu_torch.models.schema import ValueType
        from cnosdb_tpu_torch.models.series import SeriesKey
        from cnosdb_tpu_torch.parallel.meta import DEFAULT_TENANT

        fl = int(ValueType.FLOAT)
        fields = cfg["fields"]

        def load(h0):
            wb = WriteBatch()
            for h in range(h0, min(h0 + LOAD_HOSTS, cfg["scale"])):
                wb.add_series(cfg["measurement"], SeriesRows(
                    SeriesKey(cfg["measurement"], tags[h]), ts,
                    {f: (fl, hist[i, h]) for i, f in enumerate(fields)}))
            self.coord.write_points(DEFAULT_TENANT, cfg["database"], wb)

        with ThreadPoolExecutor(max_workers=LOAD_WORKERS) as pool:
            list(pool.map(load, range(0, cfg["scale"], LOAD_HOSTS)))

    def flush(self) -> None:
        self.coord.engine.flush_all()

    def compact(self) -> None:
        self.coord.engine.compact_all()

    def layout(self) -> dict:
        """The on-disk state a window starts from: TSM files per level of
        each vnode, and the compactions still queued or running."""
        e = self.coord.engine
        return {"files": {str(k[1]): [len(v.summary.version.levels[lv])
                                      for lv in range(5)]
                          for k, v in sorted(e.vnodes.items())},
                "compactions_pending": len(e._compact_pending)}

    # ---------------------------------------------------------- HTTP
    def listen(self) -> int:
        """Start the HTTP listener on a free local port, in a thread of
        its own running the server's event loop."""
        ready = threading.Event()
        err = []

        def serve():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._runner = self._loop.run_until_complete(
                    self.server.start(host="127.0.0.1", port=self.port))
            except BaseException as e:   # handed to the caller below
                err.append(e)
                ready.set()
                raise
            ready.set()
            self._loop.run_forever()

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self._thread = threading.Thread(target=serve, name="bench-http",
                                        daemon=True)
        self._thread.start()
        if not ready.wait(60) or err:
            raise RuntimeError(f"HTTP listener did not start: {err}")
        return self.port

    def close(self) -> None:
        if self._loop is not None:
            if self._runner is not None:
                asyncio.run_coroutine_threadsafe(
                    self._runner.cleanup(), self._loop).result(30)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(30)
        self.coord.close()


def data_dir() -> str:
    """A fresh directory for the node's data under TMPDIR."""
    import tempfile

    return tempfile.mkdtemp(prefix="cnosdb-bench-",
                            dir=os.environ.get("TMPDIR") or None)
