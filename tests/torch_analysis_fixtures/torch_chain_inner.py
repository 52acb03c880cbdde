"""Inner layer of the cross-file torch chain (torch_chain_outer.py)."""
import torch


def to_device(a, dev):
    return torch.from_numpy(a).to(dev)
