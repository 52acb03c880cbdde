"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Everything a cell is made of is found by name: the cell in
BENCHMARK.json, its configuration in configs/<config>.json, its traffic
mix in traffic/<traffic>.json, the mix's driver in traffic/<kind>.py and
each metric's reader in metrics/<metric>.py.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
FOREIGN = ("jax", "jaxlib", "flax", "cnosdb_tpu")
CLOSE_WAIT_S = 60.0          # answers due in the window may come this late
WINDOW_LEAD_S = 0.2          # from opening the window to its start


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(items: list, name: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(name)


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def foreign_modules() -> list:
    """Loaded modules of the JAX stack or the JAX package, by whole
    top-level name (cnosdb_tpu_torch is not cnosdb_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FOREIGN)


def process_start() -> float:
    """The epoch time at which this process started (/proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def io_bytes() -> dict:
    with open("/proc/self/io") as f:
        return {k: int(v) for k, v in (ln.split(": ") for ln in f)}


class Run:
    """What a metric reader sees of one run."""

    def __init__(self, cell, cfg, mix, seconds, t0, t1, results, setup_s,
                 trace, profiled=()):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seconds, self.t0, self.t1 = seconds, t0, t1
        self.queries = [r for res in results for r in res.get("queries", [])]
        self.writes = [r for res in results for r in res.get("writes", [])]
        self.setup_s = setup_s
        self.trace = trace
        self.profiled = list(profiled)

    def window(self, recs: list) -> list:
        """Records answered within the window."""
        return [r for r in recs if r["ok"] and self.t0 <= r["done"] <= self.t1]

    def quiet(self, recs: list) -> list:
        """Records answered within the window that overlapped no slice
        the profiler recorded: what host-clock metrics read, so that the
        profiler's load on the node's process does not move them."""
        return [r for r in self.window(recs)
                if not any(r["start"] < e and r["done"] > s
                           for s, e in self.profiled)]

    def in_window(self, r: dict) -> float:
        """The share of an answered record's service time (send to
        answer) that fell inside the window: a rate counts every
        operation by the part of its work done in the window, so that
        operations in flight at either edge count for what they did
        there and not as one or none."""
        if not r["ok"]:
            return 0.0
        inside = min(r["done"], self.t1) - max(r["start"], self.t0)
        return max(0.0, inside) / max(r["done"] - r["start"], 1e-9)

    def stage_per_query(self, key: str):
        """A profile stage summed over the window's profiled queries,
        per query; None where no query carried a profile."""
        prof = [r["profile"]["stages"] for r in self.quiet(self.queries)
                if r.get("profile")]
        if not prof:
            return None
        return sum(p.get(key, 0.0) for p in prof) / len(prof)


def rehearsal(cfg: dict, mix: dict) -> tuple[dict, dict]:
    """The mix's tiny CPU sizes: its "rehearsal" block overrides keys of
    the configuration and of the mix's blocks."""
    r = mix.get("rehearsal", {})
    cfg = {**cfg, **r.get("config", {})}
    mix = {k: ({**v, **r.get(k, {})} if isinstance(v, dict) else v)
           for k, v in mix.items()}
    return cfg, mix


def host_probe() -> float:
    """Seconds the host takes for a fixed piece of work (numpy's sort of
    2**21 floats, best of 3): set beside a run's rates, it shows how fast
    the shared host ran in that run."""
    import numpy as np

    x = np.random.default_rng(0).random(1 << 21)
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        np.sort(x)
        best = min(best, time.perf_counter() - t)
    return best


def device(chips: int, rehearse: bool) -> dict:
    if rehearse:
        return {"platform": "cpu", "kind": "cpu rehearsal", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def run(args, root: str, t_start: float) -> int:
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = by_name(manifest["workloads"], args.workload)
    cfg = load_json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    mix = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    kind = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    if args.rehearse:
        if os.environ.get("CNOSDB_TORCH_PLACEMENT") != "cpu":
            log("a rehearsal runs on the CPU: set CNOSDB_TORCH_PLACEMENT=cpu")
            return 2
        cfg, mix = rehearsal(cfg, mix)
    import torch

    if not args.rehearse and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < cell["chips"]):
        log(f"no result: the cell needs {cell['chips']} CUDA card(s), this "
            f"machine has {torch.cuda.device_count()}")
        return 3
    import cnosdb_tpu_torch

    if not os.path.abspath(cnosdb_tpu_torch.__file__).startswith(root + os.sep):
        log(f"no result: the program under test, {cnosdb_tpu_torch.__file__}, "
            f"is not in this checkout ({root})")
        return 5
    if not args.rehearse:
        # a CUDA context current on this thread before any trace starts:
        # the node's device work runs on its own threads
        torch.cuda.set_device(0)
        torch.empty(1, device="cuda")
        torch.cuda.synchronize()
    from benchmark import devtrace, node, tsbs

    steps: dict = {}
    mark = time.perf_counter()

    def step(name):
        nonlocal mark
        now = time.perf_counter()
        steps[name] = now - mark
        mark = now

    step("start")
    if not args.rehearse:
        from cnosdb_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    step("build")
    work = node.data_dir()
    job = {"cfg": cfg, "mix": mix, "seed": args.seed, "trace": bool(args.trace),
           "workdir": os.path.join(work, "answers")}
    os.makedirs(job["workdir"])
    from benchmark.clients import Clients

    clients = Clients(kind.specs(job), job)
    n = None
    try:
        step("spawn")
        tags = tsbs.host_tags(cfg, args.seed)
        ts = tsbs.timestamps(cfg)
        hist = tsbs.history(cfg, args.seed)
        step("generate")
        n = node.Node(os.path.join(work, "node"))
        n.create_database(cfg)
        step("open")
        n.preload(cfg, tags, ts, hist)
        step("preload")
        n.flush()
        step("flush")
        n.compact()
        step("compact")
        port = n.listen()
        step("listen")
        warm_recs = kind.warm(job, port, clients.shared)
        if args.trace and not args.rehearse:
            devtrace.warm()
        step("warm")
        layout = n.layout()
        t0, t1 = clients.open_window(port, args.seconds, WINDOW_LEAD_S)
        setup_s = time.time() + (t0 - time.monotonic()) - t_start
        trace, tries, slices = None, [], []
        if args.trace and not args.rehearse:
            # slices are recorded until one finds the card at work; each
            # is read only after the window
            lead, length = mix["trace"]["lead_s"], mix["trace"]["slice_s"]
            time.sleep(max(0.0, t0 + lead - time.monotonic()))
            while time.monotonic() + length <= t1:
                sl = devtrace.record(length)
                slices.append(sl)
                tries.append(f"{'active' if sl.active else 'no device work'}"
                             f" ({sl.end - sl.start:.1f} s)")
                if sl.active:
                    break
                sl.prof = None
        time.sleep(max(0.0, t1 - time.monotonic()))
        results = clients.collect(t1 + CLOSE_WAIT_S)
        dev = device(cell["chips"], args.rehearse)
        probe_s = host_probe()
        post = kind.after(job, results + [warm_recs], port)
    finally:
        clients.stop()
        if n is not None:
            n.close()
    if slices and slices[-1].active:
        t_read = time.perf_counter()
        trace, why = devtrace.summarise(slices[-1],
                                        os.path.join(work, "trace.json"))
        tries.append(f"{why} (read in {time.perf_counter() - t_read:.1f} s "
                     f"after the window)")
    t_check = time.perf_counter()
    everything = results + [warm_recs]
    numbers = kind.judge(job, everything, post, hist)
    r = Run(cell["name"], cfg, mix, args.seconds, t0, t1, results, setup_s,
            trace, [(sl.start, sl.end) for sl in slices])
    attempted = [x for x in r.queries + r.writes if x["start"] >= t0]
    failed = sum(1 for x in attempted if not x["ok"])
    numbers = {"failed": failed, **numbers}
    from benchmark import check

    limits = mix["limits"]
    program_lines = []
    if args.control:
        # the float32 reference in the program's place, through the
        # same rendering, parsing and verdict; the program's own numbers
        # go to standard error beside it
        _ok, program_lines = check.verdict(numbers, limits)
        numbers = {"failed": failed,
                   **kind.judge(job, *kind.control(job, everything, post,
                                                   hist), hist)}
    correct, lines = check.verdict(numbers, limits)
    check_s = time.perf_counter() - t_check
    io = io_bytes()
    children_written = sum(res.get("io", {}).get("wchar", 0)
                           for res in results)
    shutil.rmtree(work, ignore_errors=True)

    kind_of = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in manifest[kind_of]:
        if not applies(m, cell["name"]):
            continue
        if args.rehearse and m["source"] == "device_trace":
            continue
        v = metric_reader(m["name"])(r)
        if v is None:
            continue
        entry = v if isinstance(v, dict) else {"value": v}
        metrics[m["name"]] = {**entry, "unit": m["unit"]}
    if args.trace and not args.rehearse:
        dev["busy_s"] = trace["busy_s"] if trace else None
        dev["window_s"] = trace["window_s"] if trace else None
    bad = foreign_modules()
    if bad:
        log(f"no result: the run loaded {', '.join(bad)}")
        return 4
    log(f"# setup {json.dumps({k: v for k, v in steps.items()})}")
    log(f"# host probe {probe_s!r} s (np.sort of 2**21 floats, best of 3)")
    inside = sorted(x for res in results for x in res.get("probe", []))
    if inside:
        log(f"# host probe in the window (np.sort of 2**18 floats once a "
            f"second, readers' process): median {inside[len(inside) // 2]!r}"
            f" s, min {inside[0]!r}, max {inside[-1]!r}, {len(inside)} reads")
    log(f"# layout at the window's start {json.dumps(layout)}")
    log("# query seconds by start " + json.dumps(
        [round(q["done"] - q["start"], 3) for q in sorted(
            r.window(r.queries), key=lambda q: q["start"])]))
    if not args.trace:
        # the tails an untraced run reads, to set beside a traced run's
        untraced = {m: metric_reader(m)(r) for m in ("tail.query_p95_ms",
                                                     "tail.write_p95_ms")}
        log(f"# untraced tails {json.dumps(untraced)}")
    log(f"# window {len(r.window(r.queries))} queries, "
        f"{len(r.window(r.writes))} batches; check {check_s:.3f} s; traced "
        f"slices {tries}")
    log(f"# io written: node {io.get('write_bytes', 0)} B to storage, "
        f"{io.get('wchar', 0)} B through write(); clients "
        f"{children_written} B through write()")
    conns = sum(res.get("connections", 0) for res in results)
    if conns:
        waited = sum(w["wait_s"] for w in r.writes)
        span = max((w["done"] for w in r.writes), default=t0) - t0
        log(f"# writers: {conns} connections waited on acks "
            f"{waited:.3f} s of {conns * span:.3f} s (each from the "
            f"window's start to the last ack)")
    for ln in program_lines:
        log(f"# program {ln}")
    if args.control:
        log("# control: the float32 reference in the program's place")
    for ln in lines:
        log(ln)
    out = {"correct": bool(correct), "attempted": len(attempted),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in numbers.items()}
    print(json.dumps(out), flush=True)
    return 0


def main(args, root: str, t_start: float) -> int:
    try:
        return run(args, root, t_start)
    except Exception:
        traceback.print_exc()
        return 1
