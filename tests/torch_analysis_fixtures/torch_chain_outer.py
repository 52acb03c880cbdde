"""Outer layer: the taint crosses two call edges before the host pull."""
from torch_chain_inner import to_device


def upload(a, dev):
    return to_device(a, dev) * 2


def consume(a, dev):
    rows = upload(a, dev)
    return int(rows.sum())
