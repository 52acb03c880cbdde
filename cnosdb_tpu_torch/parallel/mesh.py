"""Device mesh management + the mesh-lane accounting plane.

The port of cnosdb_tpu/parallel/mesh.py. A mesh is an ordered list of
`torch.device`s along one axis ("shard"): shard i's rows live on
`mesh.devices[i]`, and the collective merge (parallel/distributed_agg)
gathers every shard's partials onto `mesh.devices[0]`. Devices may
repeat, so that n logical shards can share one card (or the CPU) — the
counterpart of the JAX tests' virtual host devices. The lane is
single-controller, as in the JAX package: the executor that holds the
scan batches drives every shard from one process, so there is no
`torch.distributed` process group.

The process-wide mesh is built once (`get_mesh`) from the placement
plane's device pool (ops/placement.py `mesh_devices`). `CNOSDB_MESH=0`
disables the lane entirely — every query takes the byte-identical
legacy merge path.

Accounting: every mesh-lane engage/decline books here via
`count_outcome(lane, reason)` and is exported as
`cnosdb_mesh_total{lane,reason}` by the HTTP /metrics scrape.
"""
from __future__ import annotations

import os
import threading

import torch

SHARD_AXIS = "shard"
# reserved second axis name, as in the JAX package: replicated operands
# would be placed with P(), which spans every named axis
REPLICA_AXIS = "replica"

_lock = threading.Lock()
_counters: dict[tuple[str, str], int] = {}
_cached_mesh: "Mesh | None" = None
_cached_key: tuple | None = None


def enabled() -> bool:
    """Master switch: CNOSDB_MESH=0 keeps every query on the legacy
    (byte-identical) host merge path."""
    return os.environ.get("CNOSDB_MESH", "1") != "0"


def count_outcome(lane: str, reason: str, n: int = 1) -> None:
    """Book one mesh-lane outcome (engage or decline) — the counter
    behind `cnosdb_mesh_total{lane,reason}`."""
    with _lock:
        _counters[(lane, reason)] = _counters.get((lane, reason), 0) + n


def outcomes_snapshot() -> dict[tuple[str, str], int]:
    with _lock:
        return dict(sorted(_counters.items()))


def reset_counters() -> None:
    """Test isolation only."""
    with _lock:
        _counters.clear()


class Mesh:
    """The devices of the execution mesh, one per shard, in shard order."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {SHARD_AXIS: len(self.devices)}


class PartitionSpec(tuple):
    """Operand layout over the mesh: the axis names of each dimension
    (None = replicated). `P("shard")` splits rows over the shard axis;
    `P()` is fully replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def make_mesh(n_devices: int | None = None, device: str = "cuda") -> Mesh:
    """A mesh over the first `n_devices` CUDA devices (all of them when
    None). Raises when there are fewer: a run meant for the card never
    widens onto the host. `device="cpu"` builds a mesh of `n_devices`
    logical shards on the CPU — only when the caller asks for it."""
    if device == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    if device != "cuda":
        raise ValueError(f"device={device!r}: expected cuda or cpu")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n > have or n < 1:
        raise ValueError(f"requested {n} CUDA devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def get_mesh() -> Mesh | None:
    """The process-wide execution mesh over the placement plane's device
    pool. CNOSDB_MESH_DEVICES caps the width (the bench sweep uses it to
    scale 1→2→4→8 on a fixed pool); None when the pool is empty. The
    cache is keyed on the cap and the pool, so a changed pool rebuilds."""
    global _cached_mesh, _cached_key
    from ..ops.placement import mesh_devices

    want = os.environ.get("CNOSDB_MESH_DEVICES")
    devs = list(mesh_devices())
    key = (want, tuple(str(d) for d in devs))
    with _lock:
        if _cached_mesh is not None and _cached_key == key:
            return _cached_mesh
    if not devs:
        return None
    if want:
        devs = devs[:max(1, int(want))]
    mesh = Mesh(devs)
    with _lock:
        _cached_mesh = mesh
        _cached_key = key
    return mesh


def mesh_size(mesh: Mesh) -> int:
    return mesh.shape[SHARD_AXIS]
