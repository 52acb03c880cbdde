"""torch-sync fixture: Python truth tests on tensors and .item()."""
import torch


def clip_rows(vals, n: int):
    dev = torch.device("cuda")
    t = torch.as_tensor(vals, device=dev)
    if t.sum() > 0:
        t = t - 1
    while (t > 5).any():
        t = t // 2
    flag = t.any() or n > 3
    assert not torch.isnan(t).any()
    peak = t.max().item()
    m = t if t.min() < 0 else -t
    evens = [i for i in range(n) if t[i] % 2 == 0]
    done = not t.all()
    hit = 3 in t
    # metadata, identity and host values never sync
    if t.shape[0] > 2 and t.numel() and t.dim() == 1:
        pass
    if t.dtype == torch.float64 or t.device.type == "cpu" or t.is_cuda:
        pass
    if len(t) > n or t is None or n in (1, 2):
        pass
    host = t.cpu()
    if host.sum() > 0:
        pass
    k = int(t.sum())   # an explicit crossing: host-sync's, not this rule's
    return flag, peak, m, evens, done, hit, k


def annotated(x: torch.Tensor, k: int):
    if x[k]:
        return k
    if k > 2 and x.numel():
        return 0
    return -1


def rebound(vals, dev):
    t = torch.as_tensor(vals, device=dev)
    if t.any():
        pass
    t = t.cpu().numpy()
    if t.any():
        return 1
    return 0
