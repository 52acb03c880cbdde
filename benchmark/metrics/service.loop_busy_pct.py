"""Share of the window in which the HTTP event loop's thread was held: the
union of the spans recorded on the thread of the window's `http:` root
spans (the write's parse, the query's rendering, and any other work done
there, a lock wait included), but the roots and the spans that await and
leave the loop to others (timeline.AWAITS), over the window less its
recorded slices. Beside it, the same share of each span name that holds
the loop outermost (`held.<name>`), and the spans recorded a second in
the window."""
from benchmark import timeline


def read(run):
    spans = timeline.quiet(run)
    if spans is None:
        return None
    loop = {s["thread"] for s in spans if s["name"].startswith("http:")}
    if not loop:
        return None
    held = [s for s in spans if s["thread"] in loop
            and not timeline.is_root(s)
            and not s["name"].endswith(timeline.AWAITS)]
    sliced = timeline.union_s([(max(b, run.t0), min(e, run.t1))
                               for b, e in run.profiled
                               if e > run.t0 and b < run.t1])
    open_s = run.t1 - run.t0 - sliced
    out = {"value": 100.0 * timeline.union_s(
        [(max(s["start"], run.t0), s["end"]) for s in held]) / open_s}
    for name in sorted({s["name"] for s in held}):
        out[f"held.{name}"] = 100.0 * timeline.union_s(
            [(max(s["start"], run.t0), s["end"])
             for s in timeline.outermost(held, name)]) / open_s
    out["spans_per_s"] = len(spans) / open_s
    return out
