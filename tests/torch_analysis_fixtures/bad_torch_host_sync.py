"""host-sync fixture: torch values pulled to the host mid-pipeline."""
import numpy as np
import torch


def scan_chunk(vals, dev):
    d = torch.from_numpy(vals).to(dev)
    c = torch.cumsum(d, 0)
    total = float(c[-1])
    n = int(c.sum())
    peak = c.max().item()
    rows = c.tolist()
    host = c.cpu().numpy()
    back = c.to("cpu")
    arr = np.asarray(c)
    for v in c:
        total += 1
    torch.cuda.synchronize()
    return total, n, peak, rows, host, back, arr


class Pending:
    def __init__(self, dev_out):
        self.dev_out = dev_out

    def fetch(self):
        return self.dev_out.cpu()


def host_only(vals):
    t = torch.from_numpy(vals)
    z = torch.zeros(4)
    p = torch.empty(8, dtype=torch.uint8, pin_memory=True)
    w = torch.zeros(4, device="cpu").to(torch.int64)
    ok = torch.cuda.is_available() and torch.cuda.device_count() > 0
    info = torch.iinfo(torch.int64)
    return (float(t.sum()), int(z[0]), p.numpy(), bool(w.any()), int(ok),
            int(info.max))


def metadata_only(vals, dev):
    d = torch.as_tensor(vals, device=dev)
    return int(d.shape[0]), int(d.numel()), len(d), bool(d.is_cuda)
