"""Share of vnode scans that missed the scan cache (scan_miss over
scan_hit + scan_miss), over the window's profiled queries."""


def read(run):
    hit = run.stage_per_query("scan_hit")
    miss = run.stage_per_query("scan_miss")
    if hit is None or hit + miss == 0:
        return None
    return 100.0 * miss / (hit + miss)
