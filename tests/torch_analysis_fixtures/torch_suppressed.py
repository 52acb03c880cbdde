"""Fixture: the torch rules' violations, each silenced inline."""
import threading

import torch

_LOCK = threading.Lock()


def pull(vals, dev):
    t = torch.as_tensor(vals, device=dev)
    if t.any():  # lint: disable=torch-sync (fixture: a silenced branch)
        t = t + 1
    n = int(t.sum())  # lint: disable=host-sync (fixture: an audited pull)
    with _LOCK:
        u = torch.cumsum(t, 0)  # lint: disable=lock-held-dispatch (fixture)
    return n, u
