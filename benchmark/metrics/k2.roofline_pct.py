"""K2 (ops/csrc/xor_scan.cu) against the HBM roofline: the bytes its
launches in the traced slice must move (yardstick.k2_bytes over the
launch shapes) at 3.35 TB/s, over K2's device time there."""
from benchmark import yardstick


def read(run):
    t = run.trace
    k = t and t["k2"]
    if not k or not k["events"] or not k["launches"] or k["seconds"] <= 0:
        return None
    moved = sum(yardstick.k2_bytes(*shape) * n
                for shape, n in k["shapes"].items())
    # the launches' mean bytes for each kernel event the trace kept
    moved *= k["events"] / k["launches"]
    return 100.0 * moved / yardstick.HBM_BYTES_PER_S / k["seconds"]
