"""Drift guard: the port's copied host modules are cnosdb_tpu's, verbatim.

cnosdb_tpu_torch carries copies of cnosdb_tpu's jax-free modules so that
their relative `from ..ops import …` lines bind to the port's own ops.
Each copy must equal its original except for the substitutions listed
here (module-name strings, placement tests, the jax probes) and the few
functions that were rewritten for the port, which are compared with the
rest of the module masked out. A deliberate divergence updates this list.
"""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "cnosdb_tpu")
DST = os.path.join(REPO, "cnosdb_tpu_torch")

COPIED_TREES = ("models", "storage", "sql", "utils", "protocol", "server",
                "chaos", "client")
COPIED_FILES = (
    "errors.py", "faults.py", "config.py",
    "ops/group_agg.py", "ops/zonemap.py", "ops/strkernels.py",
    "ops/mesh_exec.py", "ops/tpu_exec.py",
    # the analysis engine: core, CLI, per-file rules and the
    # interprocedural substrate (its torch taint is held by
    # tests/test_torch_analysis.py)
    "analysis/__init__.py", "analysis/__main__.py", "analysis/rules.py",
    "analysis/interproc.py",
)
# parallel/ minus the two jax modules, which the port rewrites in torch
NOT_COPIED_PARALLEL = {"mesh.py", "distributed_agg.py"}
# modules of the copied trees that the port leaves out: the degraded-TPU
# relay guard (it probes `import jax` in a subprocess)
NOT_COPIED = {"utils/relay.py"}

# every copy: string module names point at the port
GLOBAL_SUBS = [('"cnosdb_tpu.', '"cnosdb_tpu_torch.')]
# interproc.py: the module docstring and the taint's constants describe
# torch, the jit aliases and their bookkeeping go (nothing in the port
# compiles a program), and the hot scope and module naming name the port
_INTERPROC_SUBS = [
    ("""The per-file rules in :mod:`.rules` cannot see that ``np.asarray(x)``
is a device→host sync when ``x`` came out of a jitted kernel two call
edges away. This module builds what they are missing:""",
     """The port of cnosdb_tpu/analysis/interproc.py, with the device taint
redesigned for eager torch on a CUDA card. The per-file rules in
:mod:`.rules` cannot see that ``int(x)`` is a device→host sync when
``x`` came out of a torch op two call edges away. This module builds
what they are missing:"""),
    ("""  each file's imports, module-level ``X = jax.jit(f)`` aliases, and the
  named locks (``lockwatch.Lock(...)`` / ``threading.Lock()`` targets);""",
     """  each file's imports, and the named locks (``lockwatch.Lock(...)`` /
  ``threading.Lock()`` targets);"""),
    ("""  host/device, seeded by ``jnp.*``/``jax.*``/``lax.*`` calls,
  ``device_put``/``pallas_call``, jit aliases, and device-returning
  callees; ``np.asarray``/``float()``/``int()``/``bool()``/``len()``/
  ``.item()``/``.tolist()`` are the *crossings* — their results are
  host (and, in a hot path, the crossing itself is a finding).
""",
     """  host/device. Device values enter through ``torch.*`` tensor ops,
  ``.to(<a device that is not the CPU>)``, ``.cuda()``,
  ``put_sharded`` and device-returning callees (``device_cache._put``,
  ``kernels.to_device``). These stay host: torch metadata
  (``torch.cuda.is_available``, ``device_count``, ``torch.device``,
  ``torch.iinfo``, dtypes), ``torch.from_numpy``, factories whose
  ``device=`` is absent or the CPU (and that pass no ``**kw``),
  page-locked factories (``pin_memory=True``), and tensor metadata
  (``.shape``, ``.dtype``, ``.device``, ``.numel()``, ...).
  ``np.asarray``/``float()``/``int()``/``bool()``/``len()``/
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``.to("cpu")`` are
  the *crossings* — their results are host (and, in a hot path, the
  crossing itself is a finding).

Dispatch — what lock-held-dispatch looks for — is any torch op but the
metadata ones, ``.to()``/``.cuda()``/``.cpu()``, and the entry points
of a hand-written kernel's library (a name bound to
``cuda_build.library(...)``, called directly, through ``getattr`` or
through a local alias).
"""),
    ("would re-flag every one through every accessor.\n",
     """would re-flag every one through every accessor. ``.cpu()`` and
``.to("cpu")`` exist only on tensors, so they are crossings whatever
their receiver, attributes included.
"""),
    ("""Rules shipped on this substrate: host-sync, recompile-hazard,
lock-held-dispatch, deadline-propagation""",
     """Rules shipped on this substrate: host-sync, lock-held-dispatch,
deadline-propagation"""),
    ("""# modules whose attribute calls produce device values / dispatch work
_DEVICE_MODULES = {"jnp", "lax", "pl", "pltpu"}
_DEVICE_ENTRY_NAMES = {"device_put", "pallas_call"}
# under the bare `jax` namespace only these attrs touch arrays —
# jax.devices() / jax.local_device_count() return host metadata handles
_JAX_ARRAY_ATTRS = {"numpy", "lax", "ops", "device_put", "jit", "pmap",
                    "vmap", "block_until_ready", "pure_callback"}
""",
     """# torch.* calls that read host metadata: no tensor, no dispatch
_TORCH_METADATA = {
    "device", "dtype", "iinfo", "finfo", "is_tensor", "is_floating_point",
    "get_default_dtype", "is_available", "device_count", "current_device",
    "get_device_name", "get_device_properties", "get_device_capability",
    "is_initialized",
}
# torch.* factories: their result lives where device= says (the CPU when
# it is absent)
_TORCH_FACTORIES = {
    "empty", "zeros", "ones", "full", "arange", "linspace", "logspace",
    "eye", "tensor", "as_tensor", "empty_strided", "rand", "randn",
    "randint", "randperm", "frombuffer",
}
# calls by these names return device values the summaries cannot see
# through: put_sharded wraps its device shards in a ShardedTensor
_DEVICE_ENTRY_NAMES = {"put_sharded"}
# tensor attributes / methods that read metadata, not data: no sync
_TENSOR_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                      "layout", "itemsize", "nbytes", "requires_grad"}
_TENSOR_META_METHODS = {"numel", "dim", "size", "stride", "data_ptr",
                        "element_size", "nelement", "is_contiguous",
                        "is_pinned", "is_floating_point", "get_device",
                        "storage_offset"}
"""),
    ('_HOST_CAST_METHODS = {"item", "tolist"}\n',
     """_HOST_CAST_METHODS = {"item", "tolist", "cpu", "numpy"}
# methods that move or convert a tensor: dispatch whatever the receiver
_DISPATCH_METHODS = {"to", "cuda", "cpu"}
"""),
    ("``jnp.linalg.norm`` → ``jnp``",
     "``torch.cuda.is_available`` → ``torch``"),
    # FuncInfo: no jit flags and no synthetic (jit alias) entries
    ('                 "jitted", "static_argnames", "synthetic", '
     '"call_sites",\n',
     '                 "call_sites",\n'),
    ("""    def __init__(self, qualname: str, relpath: str, node,
                 synthetic: bool = False):
""", "    def __init__(self, qualname: str, relpath: str, node):\n"),
    ("        self.synthetic = synthetic\n", ""),
    ("        self.jitted = False\n"
     "        self.static_argnames: set = set()\n", ""),
    ("            if info.synthetic:\n                continue\n", ""),
    ("        if info.synthetic:\n            return set()\n", ""),
    ("if info.synthetic or not info.accepts_deadline:",
     "if not info.accepts_deadline:"),
    ("""        pending = collections.deque(
            i for i in self.functions if not i.synthetic)
""", "        pending = collections.deque(self.functions)\n"),
    ('                ("jit", info.jitted),\n', ""),
    ("""            if node.name.endswith("_kernel"):
                info.jitted = True
            for dec in node.decorator_list:
                if _contains_jit(dec):
                    info.jitted = True
                    if isinstance(dec, ast.Call):
                        info.static_argnames |= _static_argnames(dec)
            if info.jitted:
                # calling a jitted function yields device arrays no
                # matter what its body looks like textually
                info.returns_device = True
""", ""),
    ("""                elif _contains_jit(call.func):
                    self._add_jit_alias(fi, node, call)
""", ""),
    ("        self.jit_aliases: dict = {}      "
     "# name → synthetic FuncInfo\n", ""),
    ("            if n in fi.jit_aliases:\n"
     "                return fi.jit_aliases[n]\n", ""),
    ("""                    return tfi.jit_aliases.get(tgt[1]) \\
                        or tfi.toplevel.get(tgt[1])
""", "                    return tfi.toplevel.get(tgt[1])\n"),
    ("""                        return tfi.jit_aliases.get(a) \\
                            or tfi.toplevel.get(a)
""", "                        return tfi.toplevel.get(a)\n"),
    # the module name binds the port's relative imports
    ("""        # dotted module name: cnosdb_tpu/ops/kernels.py →
        # cnosdb_tpu.ops.kernels; files""",
     """        # dotted module name: cnosdb_tpu_torch/ops/kernels.py →
        # cnosdb_tpu_torch.ops.kernels; files"""),
    ('if parts and parts[0] == "cnosdb_tpu":',
     'if parts and parts[0] == "cnosdb_tpu_torch":'),
    # the entry points of the hand-written kernels' libraries dispatch
    ("        self.lock_names: set = set()\n        for ctx in contexts:\n",
     """        self.lock_names: set = set()
        self._kernel_calls: set = set()  # id(ast.Call) of library entries
        for ctx in contexts:
"""),
    ("""                                              "lineno", 0)))
        self._fixpoint()
""", """                                              "lineno", 0)))
            self._mark_kernel_calls(info)
        self._fixpoint()
"""),
    # host-sync's scope: the mesh lane's collective merge was a jitted
    # program in the JAX package (the tracer guarded it); here it is
    # eager torch whose pulls only this rule sees
    ('_HOT_PATHS = ("cnosdb_tpu/ops/",)\n'
     '_HOT_FILES = ("cnosdb_tpu/storage/scan.py", '
     '"cnosdb_tpu/sql/executor.py")\n',
     """_HOT_PATHS = ("cnosdb_tpu_torch/ops/",)
# the mesh lane's collective merge: in the JAX package a jitted program
# (the tracer guarded it), here eager torch whose pulls only this rule
# sees
_HOT_FILES = ("cnosdb_tpu_torch/storage/scan.py",
              "cnosdb_tpu_torch/sql/executor.py",
              "cnosdb_tpu_torch/parallel/distributed_agg.py")
"""),
    ('    call edges) from jax ops, inside the scan/exec/kernel hot '
     'paths."""',
     """    call edges) from torch ops, inside the scan/exec/kernel hot paths,
    and the explicit syncs there: ``.cpu()``/``.to("cpu")`` on any
    receiver, and ``.synchronize()`` on a stream, an event or the
    card.\"\"\""""),
    ("the XLA pipeline mid-query", "the device pipeline mid-query"),
    ("reaches jnp dispatch or rpc_call two edges down",
     "reaches a torch op or rpc_call two edges down"),
    ("one slow compile/", "one slow launch/"),
]
# per file: exact line substitutions
SUBS = {
    "ops/tpu_exec.py": [('scan_device().platform == "cpu"',
                         'scan_device().type == "cpu"'),
                        # the device staging's one bias helper
                        ("""                dev_vals = (np.asarray(vals, dtype=np.uint64)
                            ^ np.uint64(1 << 63)).view(np.int64)
""", """                from .device_cache import biased_u64

                dev_vals = biased_u64(vals)
""")],
    "ops/mesh_exec.py": [
        ('scan_device().platform == "cpu"', 'scan_device().type == "cpu"'),
        ("from jax.sharding import PartitionSpec as P",
         "from ..parallel.mesh import PartitionSpec as P"),
        # the merged partials are tensors on the lead device: one pull each
        ("np.asarray(v)[:n_seg] for k, v in out.items()",
         "v[:n_seg].cpu().numpy() for k, v in out.items()")],
    "chaos/__init__.py": [("(cnosdb_tpu/faults.py)",
                           "(cnosdb_tpu_torch/faults.py)")],
    "chaos/sweep.py": [
        # the module names of the repro line, the hook imports and the
        # workload subprocess
        ("python -m cnosdb_tpu.chaos.workload run /tmp/dir",
         "python -m cnosdb_tpu_torch.chaos.workload run /tmp/dir"),
        ("    import cnosdb_tpu.", "    import cnosdb_tpu_torch."),
        ('f"-m cnosdb_tpu.chaos.workload run {root}")',
         'f"-m cnosdb_tpu_torch.chaos.workload run {root}")'),
        # no CPU default: the workload takes its placement from the
        # caller's environment (the card unless CNOSDB_TORCH_PLACEMENT=cpu)
        ('    env.setdefault("JAX_PLATFORMS", "cpu")\n', "")],
    "chaos/workload.py": [
        ("python -m cnosdb_tpu.chaos.workload run <root>",
         "python -m cnosdb_tpu_torch.chaos.workload run <root>"),
        ('"usage: python -m cnosdb_tpu.chaos.workload run|verify <root>"',
         '"usage: python -m cnosdb_tpu_torch.chaos.workload run|verify '
         '<root>"')],
    # the program name follows the port's console script
    "client/cli.py": [("cnosdb-tpu-cli", "cnosdb-tpu-torch-cli")],
    # the engine lints its own package: the CLI's and docstrings' module
    # name, and the relpath keys
    "analysis/__init__.py": [
        ("cnosdb_tpu.analysis", "cnosdb_tpu_torch.analysis"),
        ("``cnosdb_tpu/...``", "``cnosdb_tpu_torch/...``")],
    "analysis/__main__.py": [
        ("cnosdb_tpu.analysis", "cnosdb_tpu_torch.analysis"),
        ('"cnosdb_tpu invariants"', '"cnosdb_tpu_torch invariants"')],
    "analysis/rules.py": [
        # jax-purity's section header and scope become torch-sync's
        # (its file list lives in the TorchSync class)
        ("# 7. jax-purity — new: Python control flow / host syncs on "
         "traced values\n",
         "# 7. torch-sync — new: Python truth tests on tensors, .item()\n"),
        ('_JAX_PURITY_FILES = ("cnosdb_tpu/ops/kernels.py",\n'
         '                     "cnosdb_tpu/ops/group_agg.py",\n'
         '                     "cnosdb_tpu/ops/pallas_kernels.py",\n'
         '                     "cnosdb_tpu/ops/device_decode.py")\n'
         '_ARRAY_MODULES = {"jnp", "lax", "pl"}\n', ""),
        ("SwallowedException(), JaxPurity(),",
         "SwallowedException(), TorchSync(),"),
        # every rule scope is a relpath under the linted package
        ('"cnosdb_tpu/', '"cnosdb_tpu_torch/'),
        ("~cnosdb_tpu.analysis.Rule", "~cnosdb_tpu_torch.analysis.Rule"),
        # stages.waited() takes a catalog name too
        ('_STAGE_METHODS = {"stage", "count"}\n',
         '_STAGE_METHODS = {"stage", "count", "waited"}\n')],
    "analysis/interproc.py": _INTERPROC_SUBS,
    # reads are linearizable through the read index; there are no leases
    "parallel/raft.py": [
        ("""  healthy leader on rejoin; leader-lease reads are not implemented (reads
  go through the leader's state machine which is safe for our apply
  model);
""", """  healthy leader on rejoin;
- reads are linearizable through `RaftNode.read_index` (the raft
  thesis's read index, openraft's ensure_linearizable): the leader
  confirms that it still leads with an append round a majority answers,
  and serves once it has applied the commit index it read. There are no
  leases and no clock assumptions: a leader cut off from its peers keeps
  its role until it hears a higher term, and fails the round. A follower
  serves through the follower read index (the thesis's §6.4 too): it
  asks its leader for that index over raft and serves once it has
  applied it;
"""),
        # the election timeout is named: a leaderless read's refusal
        # bound (Coordinator's LEADERLESS_READ_S) derives from it
        ("RAFT_BLANK = 5       # WalEntryType.RAFT_BLANK\n",
         "# A follower that hears no append for a span drawn from this "
         "range (s)\n# starts an election: a group whose leader is gone "
         "elects a new one\n# within about the longest span, a prevote "
         "and a vote round later\nELECTION_TIMEOUT = (0.15, 0.3)\n\n"
         "RAFT_BLANK = 5       # WalEntryType.RAFT_BLANK\n")],
    # the replica manager's lazy build is guarded (see REWRITTEN); a
    # split's BROKEN replicas are data-suspect, no scan clears them
    "parallel/coordinator.py": [
        ("        self._replica_mgr = None  # built on first multi-replica "
         "write\n",
         "        self._replica_mgr = None  # built on first multi-replica "
         "write\n        self._replica_mgr_lock = lockwatch.Lock("
         "\"coord.replica_mgr\")\n"
         "        self._closed = False      # a closed node builds no raft "
         "members\n"
         "        # (owner, replica set id) → the vnode last seen leading it, "
         "for\n        # the leader reads of the sets this node holds no "
         "member of\n        self._leaders_seen: dict = {}\n"),
        # every read of a replicated set goes to the set's raft leader
        # (Coordinator._leader_scan), which confirms it through its read
        # index (RaftNode.read_index); a stand-in for a BROKEN leader, and
        # a failover, serve once the follower read index confirms
        ("    broken_ids: set = field(default_factory=set)\n",
         "    broken_ids: set = field(default_factory=set)\n"
         "    # a replicated set's read: the scan asks for the group's raft "
         "leader,\n    # follows its redirects, and is served once the "
         "leader confirms it\n    # through its read index\n"
         "    leader_read: bool = False\n"
         "    # a leader read planned at a member that need not lead (the "
         "stand-in\n    # of a BROKEN leader, a failover): it serves once "
         "its read index\n    # confirms, the follower read index where it "
         "follows\n    confirmed: bool = False\n"),
        ("from .meta import MetaStore\nfrom ..utils import lockwatch\n",
         "from .meta import MetaStore\nfrom .raft import ELECTION_TIMEOUT\n"
         "from ..utils import lockwatch\n"),
        ('CB_BURN_FRACTION = float(os.environ.get("CNOSDB_CB_BURN_FRACTION",'
         ' "0.5"))\n',
         'CB_BURN_FRACTION = float(os.environ.get("CNOSDB_CB_BURN_FRACTION",'
         ' "0.5"))\n'
         "# A leader read's budget for reaching the raft leader through "
         "redirects\n# and the backoff of an election: the scan RPC's own "
         "timeout, capped by\n# the request's deadline\n"
         "LEADER_READ_TIMEOUT_S = 10.0\n"
         "# A leader's budget for confirming a read through its read index "
         "(one\n# raft round, and the apply of what it committed), capped "
         "by the\n# request's deadline\nREAD_INDEX_TIMEOUT_S = 5.0\n"
         "# A read of a replicated set refuses once, over this span, no "
         "member\n# confirmed it and no leader a member named answered: "
         "every member was\n# unreachable, or refused without naming a "
         "leader it could reach. A\n# group that lost its leader elects a "
         "new one about one election timeout\n# later (a prevote and a "
         "vote round, each settled as soon as a majority\n# answers), and "
         "its members then name it; five of the longest spans\n# leave "
         "room for a split vote and a loaded host, and a read of a group\n"
         "# that cannot elect (a node cut off from its peers) refuses in "
         "well\n# under 2 s instead of waiting out LEADER_READ_TIMEOUT_S\n"
         "LEADERLESS_READ_S = 5 * ELECTION_TIMEOUT[1]\n"),
        ("    # replicas currently marked BROKEN (self-heal on a successful "
         "scan)\n",
         "    # replicas meta marks BROKEN: data-suspect until the repair "
         "clears it\n")],
    # floor, ceil and trunc of an integer are Float64 on any numpy (numpy
    # 2.3 keeps the integer dtype: on the card `ceil(bigint)` rendered 0,
    # not 0.0, in ref_function_common_math_function_ceil.slt)
    "sql/expr.py": [
        ('        "floor": lambda xp, a: xp.floor(a),\n'
         '        "ceil": lambda xp, a: xp.ceil(a),\n',
         "        # numpy 2.3 keeps an integer input's dtype in floor, ceil "
         "and\n"
         "        # trunc; the reference returns Float64 "
         "(math_function/ceil.slt)\n"
         '        "floor": lambda xp, a: _math_float(xp, xp.floor(a)),\n'
         '        "ceil": lambda xp, a: _math_float(xp, xp.ceil(a)),\n'),
        ('        "trunc": lambda xp, a: xp.trunc(a),\n',
         '        "trunc": lambda xp, a: _math_float(xp, xp.trunc(a)),\n'),
        # `!=` of two Python scalars is a SQL boolean (`~True` is -2)
        ('    "!=": lambda xp, a, b: ~_eq(xp, a, b),\n',
         '    "!=": lambda xp, a, b: _ne(xp, a, b),\n')],
    # the port builds its own copy of the host codecs (storage/csrc/)
    # without the libraries' development headers, under a name hashed
    # from its sources and flags, and keeps why a build or load failed
    "storage/native.py": [
        ('''"""ctypes bindings for the native codec library (native/codecs.cpp).

Loads cnosdb_tpu/_native/libcnosdb_codecs.so when present (built via
`make -C native`; auto-built on first import when a compiler is around) and
exposes fused decode kernels; storage.codecs falls back to the vectorized
numpy pipeline when unavailable, so the package works without a toolchain.
"""
''', '''"""ctypes bindings for the native host codec library (storage/csrc/).

The port carries its own copy of the host codecs: storage/csrc/ holds
codecs.cpp, pagedec.cpp, lineproto.cpp, segagg.cpp and bytetrans.h, and
host_libs.h declares the three libzstd and zlib symbols they call, so the
library builds where those libraries' development headers are absent. It
is built at first use into this package's _native/ under a name that
carries a hash of the sources and flags (a stale library is never
loaded) and linked against the runtime sonames libzstd.so.1 and libz.so.1.
storage.codecs falls back to the vectorized numpy pipeline when the
library is unavailable, and build_error() says why it is.
"""
'''),
        ("import ctypes\nimport os\nimport subprocess\n",
         "import ctypes\nimport fcntl\nimport hashlib\nimport os\n"
         "import subprocess\n"),
        ("_tls = threading.local()\n",
         '''_tls = threading.local()

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SRCS = ("codecs.cpp", "lineproto.cpp", "segagg.cpp", "pagedec.cpp")
_CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
# the runtime sonames: no development symlink (libzstd.so) is needed
_LINK = ["-l:libzstd.so.1", "-l:libz.so.1"]
_ERROR = None   # why the library is unavailable, once a load failed
''')],
    # where the zstandard package is absent, libzstd.so.1 through ctypes
    # writes and reads real zstd frames; zlib stands in only where that
    # does not load either, and SOURCE says which is in force
    "utils/zstd_compat.py": [
        ('''"""zstandard import gate with a zlib fallback.

The storage layer (tsm.py, codecs.py) wants zstd, but the dependency may
be absent in slim environments. Rather than failing at import (which
takes the whole engine — and every test that touches it — down), fall
back to zlib behind the same two-class API surface the callers use.

The fallback is NOT wire-compatible with real zstd: files written with
one cannot be read with the other. That is fine for self-contained
deployments/tests (the only situation where zstandard is missing); the
chosen codec is a process-lifetime constant, so a single store never
mixes frames.
"""
from __future__ import annotations
''', '''"""zstandard import gate: the zstandard package, else libzstd, else zlib.

The storage layer (tsm.py, codecs.py) wants zstd, but the zstandard
package may be absent in slim environments. Rather than failing at
import (which takes the whole engine — and every test that touches it —
down), the same two-class API surface the callers use is bound to the
system's libzstd.so.1 through ctypes: it writes real zstd frames, with
their content size, and reads any frame that records its size, as the
zstandard package does. Only where neither loads does zlib stand in.

The zlib stand-in is NOT wire-compatible with real zstd: files written
with one cannot be read with the other, nor by the native page decoder.
SOURCE says which codec is in force ("zstandard", "libzstd" or
"zlib-stand-in"); it is a process-lifetime constant, so a single store
never mixes frames.
"""
from __future__ import annotations

import ctypes

import numpy as np

SOURCE = "zstandard"

# ZSTD_getFrameContentSize's answers for a frame that does not record
# its size, and for input that is no zstd frame
_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_CONTENTSIZE_ERROR = 2 ** 64 - 2

# a bytes object of n bytes that a C call may fill before anyone sees it:
# the decompressed frame lands in the result with no copy
_new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
_new_bytes.restype = ctypes.py_object
_new_bytes.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
'''),
        ("    import zlib as _zlib\n",
         "    import zlib as _zlib\n\n    _LIBZSTD = _load_libzstd()\n"
         '    SOURCE = "libzstd" if _LIBZSTD is not None else "zlib-stand-in"\n')],
    # the fallback reason of a series whose memory rows overlap its file
    "storage/scan.py": [
        ("""#                 cannot touch it (decodes via Python over the block cache)
""", """#                 cannot touch it (decodes via Python over the block cache)
#   memcache_overlap  the series also has unflushed rows: its file pages
#                 merge with them on the per-series Python path
""")],
    # the span, the ring and their clock are the timeline of
    # utils/stages.py; this module continues a propagated trace and
    # exports (Span, TraceCollector and current_span move, see DROPPED;
    # from_headers is a function of the module, see ADDED)
    "server/trace.py": [
        ('"""Distributed tracing: spans, context propagation, in-process '
         'collection.\n',
         '"""Distributed tracing: context propagation and export of the '
         'process timeline.\n'),
        ("""`GET /debug/traces` and the `information_schema.traces` virtual table —
the reference's jaeger-store role collapsed to the embedded case (OTLP
export is a config hook away: the collector interface takes any sink).
""", """`GET /debug/traces` — the reference's jaeger-store role collapsed to the
embedded case (OTLP export is a config hook away: the collector
interface takes any sink).

The span, the ring and their clock are the process timeline of
`utils/stages.py` (every `stages.stage()` is a span there); this module
continues a propagated trace, hands the active one on, and exports.
"""),
        ("import contextvars\nimport secrets\nimport threading\nimport time\n"
         "from ..utils import lockwatch\n",
         "import threading\nfrom ..utils import lockwatch\n"
         "from ..utils.stages import (GLOBAL_COLLECTOR, Span, TraceCollector,\n"
         "                            _current_span, current_span)\n"),
        ('_current_span: contextvars.ContextVar = contextvars.ContextVar(\n'
         '    "cnos_current_span", default=None)\n', ""),
        ("GLOBAL_COLLECTOR = TraceCollector()\n", "")],
    "utils/stages.py": [
        ("""scope both are a single contextvar read — cheap enough to leave on in
production. Profiles propagate:""", """scope `count()` is a single contextvar read. `stage()` is the one way
to time a piece of work: besides the profile, it records a span of the
same name on the process timeline (below), profile or not, as a child
of the context span; `waited()` records a wait handed from one thread
to another the same way. Both cost a few microseconds, cheap
enough to leave on at the grain they are used (a request, a vnode, a
flush, a compaction; never a page, a row or a kernel launch). Profiles
propagate:"""),
        ("import contextvars\nimport threading\n",
         "import contextvars\nimport itertools\nimport secrets\n"
         "import threading\n"),
        ("from contextlib import contextmanager\nfrom . import lockwatch\n",
         "from . import lockwatch\n"),
        ('    "distinct_path.device": "count(DISTINCT) via the jax segment '
         'kernels",',
         '    "distinct_path.device": "count(DISTINCT) via the torch sort '
         'and "\n'
         '                            "segment ops on the card '
         '(ops/kernels.py)",'),
        ('    "pallas_engagements": "aggregations that ran through a Pallas '
         'kernel",',
         '    "pallas_engagements": "aggregations that ran through K1, the "\n'
         '                          "hand-written CUDA windowed segment '
         'kernel "\n'
         '                          "(ops/csrc/segment_window.cu)",'),
        ('                         "(derived data rebuilt, jit may '
         'recompile)",',
         '                         "(derived data rebuilt and uploaded '
         'again)",'),
        ('    "topk.device": "ORDER BY+LIMIT thresholds computed by '
         'jax.lax.top_k",',
         '    "topk.device": "ORDER BY+LIMIT thresholds computed by '
         'torch.topk on "\n'
         '                   "the card",'),
        ("""                        "hedging stays tail-only)",
}""", """                        "hedging stays tail-only)",
    # the write path and the waits (spans on the timeline; the query's
    # own land in its profile too)
    "write.body_ms": "reading a write request's body, awaited on the "
                     "HTTP event loop (server/http.py handle_write)",
    "write.parse_ms": "line-protocol parse of one write request, on the "
                      "HTTP event loop (server/http.py handle_write)",
    "write.queue_ms": "a write request's wait in the HTTP executor's "
                      "queue: hand-off to the first line on a worker",
    "write.apply_ms": "Coordinator.write_points: memory admission, bucket "
                      "split, schema, the replica sets' writes",
    "write.lock_wait_ms": "a write's wait for its vnode's lock (tag "
                          "`holder`: what held it, storage/vnode.py "
                          "VnodeStorage.locked)",
    "write.wal_ms": "a vnode write's WAL record: encode, append, sync "
                    "when asked",
    "write.memcache_ms": "a vnode write's index and memory-cache insert",
    "write.resume_ms": "a write's wait for the HTTP event loop to resume "
                       "its handler once the worker is done",
    "flush_ms": "one vnode flush of its memory caches to an L0 file (tags "
                "`trigger` inline / reclaim / explicit, rows, bytes)",
    "compact_ms": "one compaction round of a vnode (tags bytes read and "
                  "written)",
    "body_ms": "reading a query request's body, awaited on the HTTP "
               "event loop (server/http.py handle_sql)",
    "queue_ms": "a query's wait in the HTTP executor's queue: hand-off to "
                "the first line on a worker",
    "admission_ms": "a query's wait at the admission gate "
                    "(server/admission.py)",
    "lock_wait_ms": "a scan's wait for a vnode's lock (tag `holder`: what "
                    "held it, storage/vnode.py VnodeStorage.locked)",
    "resume_ms": "a query's wait for the HTTP event loop to resume its "
                 "handler once the worker is done",
    "http.render_ms": "rendering a query's answer (CSV, JSON or table), "
                      "on the HTTP event loop",
}"""),
        ("PROFILES = ProfileRing()\n",
         """PROFILES = ProfileRing()


# ---------------------------------------------------------------- timeline
# The process timeline: every `stage()` is also a span here, profile or
# not, in one bounded ring, always on. A finished span is one tuple
# (`FIELDS`) appended to a deque, which needs no lock; dicts are built
# only when the ring is read. Each span keeps its thread and the CPU
# time that thread spent inside it, so that a wait and a piece of work
# can be told apart inside one span. Spans are timed on the monotonic
# clock (`now_ns()`), so a step of the system clock moves no duration,
# and each also keeps its start on `epoch_ns()`, torch.profiler's clock:
# the distance between the two clocks moves (by a millisecond within
# seconds on an H100 host), so no one offset maps the first onto the
# second. server/trace.py propagates and exports the spans.
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "cnos_current_span", default=None)

# ids: numbers of a process counter, written with a per-process random
# prefix when read (16 hex digits, unique across the nodes of a cluster
# without reading os.urandom a span)
_ID_PREFIX = secrets.token_hex(4)
_ids = itertools.count(1)

# what a finished span is in the ring
FIELDS = ("seq", "name", "trace_id", "span_id", "parent_id", "thread",
          "start_ns", "end_ns", "cpu_ns", "tags", "epoch_ns")

GLOBAL_COLLECTOR = TraceCollector()
""")],
    # the handlers' root spans and the executor's context
    "server/http.py": [
        ("import base64\nimport json\n",
         "import base64\nimport contextvars\nimport json\n")],
    # the executor is the loop's default one, shared by every request
    "server/admission.py": [
        ("""Acquisition happens on the executor worker thread (one thread per
in-flight HTTP request), so waiting here blocks no event loop. Counters
and queue-depth/wait gauges feed /metrics via `stats()`.""",
         """Acquisition happens on a worker of the event loop's default executor,
which every HTTP request shares (min(32, CPUs + 4) threads), so waiting
here holds a worker and blocks no event loop. Counters and
queue-depth/wait gauges feed /metrics via `stats()`.""")],
    # an RPC's stage is a child of the span its caller's headers carry on
    "parallel/net.py": [
        ("                from ..server.trace import GLOBAL_COLLECTOR\n",
         "                from ..server.trace import from_headers\n"),
        ("""                    with stages.profile_scope(prof), \\
                            stages.stage(f"rpc_{method}_ms"):
                        with GLOBAL_COLLECTOR.from_headers(
                                self.headers, f"rpc:{method}"):
""", """                    with stages.profile_scope(prof), \\
                            from_headers(self.headers, f"rpc:{method}"):
                        with stages.stage(f"rpc_{method}_ms"):
""")],
    "storage/vnode.py": [
        ("import threading\nfrom dataclasses import dataclass\n",
         "import threading\nfrom contextlib import contextmanager\n"
         "from dataclasses import dataclass\n")],
}
# per file: functions rewritten for the port (qualified names)
REWRITTEN = {
    # the library builds from the port's own storage/csrc/ (it compiled
    # the repo-root native/, the JAX package's sources, whose zstd.h and
    # zlib.h the card lacks: the build failed there, and its error was
    # swallowed), under a name hashed from the sources and flags (a
    # library built from other sources was loaded as current) and a lock
    # the cluster's node processes share, and links the runtime sonames;
    # a failed build or load keeps why for build_error()
    "storage/native.py": {"_lib_path", "_try_build", "_get_lib_locked"},
    # without the zstandard package the codec binds libzstd.so.1: the zlib
    # stand-in's frames, the only codec on the card, were unreadable by
    # the JAX package and rejected by the native page decoder on every
    # page
    "utils/zstd_compat.py": {"_Compressor.__init__", "_Compressor.compress",
                             "_Decompressor.decompress"},
    # the device routes raise instead of answering on the host
    "ops/strkernels.py": {"_topk_device_wanted", "topk_order_indices"},
    "ops/group_agg.py": {"device_enabled", "_device_distinct_count",
                         "device_segment_reduce"},
    # no relay guard before the server starts
    "server/main.py": {"main"},
    # the hooks raise; a closed node builds no replica manager (a raft
    # message on a kept-alive connection built one after close, whose
    # members ticked for good: dozens of them in a test process, enough
    # load to move raft's elections in the tests that followed); the
    # replica manager is built once under a lock:
    # concurrent raft messages at a node's boot built two, and the unseen
    # second one's members took leadership of their groups while the
    # registered members sat at commit 0 (a group leaderless for 180 s
    # after a leader's SIGKILL on the card); a scan's failed RPC no
    # longer marks the replica BROKEN in meta, nor does an answer clear
    # a mark: one node's failed reach (a partition, a peer's restart)
    # made every node shun a healthy replica, its raft leader too, for
    # good, and left no node's mesh lane engaged on the card; meta's
    # BROKEN now means data-suspect only, cleared by the repair; the
    # planner (table_vnodes) follows the live raft leader on every node
    # that holds a member of the group, not only on the node whose own
    # member leads: every other node read meta's static leader, which
    # after an election may be a follower that has not applied the tail
    # of the log, so a read through a third node missed acked rows; and
    # a read planned at the live leader is never hedged (_rank_targets'
    # docstring says so): the hedge read a follower, whose answer, first
    # in on a loaded card, missed rows the leader had acked; a node that
    # holds no member of a replicated set reads it through the set's raft
    # leader (table_vnodes marks the split a leader read and starts it at
    # the leader the node last saw, the scan lanes follow the redirects
    # and never hedge such a read): it read meta's static leader, which
    # after an election may lack the tail of the log, so on a cluster
    # with fewer replicas than nodes an acked write could go unread;
    # every read of a replicated set is a leader read, a member node's
    # too (one whose member knew no leader, between two, read meta's
    # static leader, hedged to a follower), the hedge lane takes the flag
    # from the plan, and a split planned at a member on this node is
    # scanned only once the member's read index confirms it leads
    # (scan_table): a new leader served before it applied what its
    # predecessor acked, and a deposed one, cut off from raft, served
    # what it had; a leader read, local or remote, never fails over to a
    # member that refused it (the refused replica, last in the
    # alternates, answered with a deposed leader's rows), and the scan
    # lanes build their request and decode a reply through one helper;
    # a local scan that a compaction overtook (a file of its file set
    # unlinked before its reader opened: FileNotFoundError under the
    # overload suite's governed flushes) runs again over the new set;
    # every route of a replicated set's read is confirmed: a leader that
    # did not answer failed over to the other replicas with plain scans
    # (the reader's own first, which lacked rows the leader had acked),
    # a stand-in for a BROKEN leader and the failover after a checksum
    # mismatch read a replica unchecked, and a node's tag reads answered
    # from members that had not applied what their group committed; the
    # hedge and solo lanes now hand a replicated set's read to
    # _leader_scan whole
    "parallel/coordinator.py": {"Coordinator._upload_hook",
                                "Coordinator._decode_hook",
                                "Coordinator.replica_manager",
                                "Coordinator.table_vnodes",
                                "Coordinator._rank_targets",
                                "Coordinator._scan_remote_solo",
                                "Coordinator._scan_remote_hedged",
                                "Coordinator._mark_vnode_broken",
                                "Coordinator.scan_table",
                                "Coordinator._scan_local",
                                "Coordinator.close",
                                "Coordinator.tag_values",
                                "Coordinator.tag_values_local",
                                "Coordinator.series_keys_local",
                                # the write is the stage write.apply_ms
                                "Coordinator.write_points"},
    # a leader read at a member that does not lead, or cannot confirm
    # through its read index that it does, is answered with a redirect
    # to the leader it follows, not scanned; a confirmed read is served
    # by a follower too, once its follower read index confirms it
    "parallel/node_service.py": {"DataNodeService._scan_vnode"},
    # a view refresh confirms the member first: a member that had not
    # applied every acked row below the watermark moved the watermark past
    # them, and the view lacked them for good
    "sql/matview.py": {"MatviewEngine._refresh_vnode"},
    # the wire query id names its tracker: ids from 1 in every process
    # collided in peers' cancel tombstones (a restarted node's queries
    # were refused as cancelled)
    "sql/executor.py": {"QueryTracker.__init__", "QueryTracker.register"},
    # the device taint: torch seeds and crossings instead of jnp/lax,
    # device_put/pallas_call and jit aliases; host-sync also flags the
    # explicit syncs (.cpu(), .to("cpu"), .synchronize()) on any
    # receiver; recompile-hazard leaves the registry
    "analysis/interproc.py": {"_is_host_cast", "Project._is_device_call",
                              "Project._expr_device", "HostSync.check",
                              "project_rules"},
    # a restarted replica: the vnode replays its own entries past the
    # flushed watermark and leaves raft's to raft (an entry raft never
    # committed was visible at open, and raft re-applied every entry
    # from index 1: flushed rows back in the memory cache, entries past
    # the flush applied twice); its raft member resumes from the
    # watermark, and a node's boot starts the members of its replicated
    # vnodes (their unflushed entries would otherwise wait for a write)
    "storage/vnode.py": {"VnodeStorage.__init__", "VnodeStorage._replay_wal",
                         "VnodeStorage.apply_entry",
                         # the process timeline: the write's lock wait,
                         # log and memory-cache insert, a flush (its
                         # trigger, rows and bytes) and a compaction
                         # round (bytes read and written) are stages; a
                         # scan's lock wait too
                         "VnodeStorage.write", "VnodeStorage._apply_write",
                         "VnodeStorage.flush", "VnodeStorage.compact",
                         "VnodeStorage.compact_major",
                         "VnodeStorage.scan_token"},
    # the memory broker's flushes are tagged as such
    "storage/engine.py": {"TsKv._reclaim_memcache"},
    # a stage records a span on the process timeline too
    "utils/stages.py": {"stage"},
    "parallel/replica.py": {"VnodeStateMachine.apply",
                            "VnodeStateMachine.install_snapshot",
                            "ReplicaGroupManager.get_or_build"},
    "server/http.py": {"build_server", "build_cluster_node",
                       "HttpServer.handle_health",
                       # a write and a query are each a root span from
                       # the handler's entry to its response (the query's
                       # opened on the worker after admission), the
                       # worker runs in the handler's context, and the
                       # parse, the executor's queue, the admission gate
                       # and the rendering are stages
                       "HttpServer.handle_write", "HttpServer.handle_sql"},
    # why a group elects or does not, on /debug/health: the ticker's age
    # and swallowed errors, each prevote round's tally, and the prevotes
    # a member refused, by reason (after a leader's SIGKILL a group
    # stayed leaderless for 180 s on the card); a candidate draws its
    # election deadline again after a round that outlived it, so two
    # candidates waiting out a silent peer do not split votes in lockstep
    # a member forgets the leader when its term moves on, and a candidate
    # or a deposed leader names none: its stale leader_id (itself, once
    # it led) was the hint a NotLeader and a leader read's redirect took;
    # an append returns its reply and a commit records its term, for the
    # read index (a leader served reads before it had applied what its
    # predecessor acked, or after it was deposed); an append broadcast is
    # numbered, and each peer has one send in flight, carrying the newest
    # broadcast (a broadcast started a thread per peer, so a slow or
    # snapshot-bound peer collected one send, a whole-vnode snapshot
    # among them, per broadcast); a heartbeat waits for no peer's send
    # (a peer 400 ms away held the ticker, the other follower heard
    # nothing past its election timeout and took the lead); a follower
    # answers a read-index request, and the HTTP transport gives that
    # request the read's own budget
    "parallel/raft.py": {"RaftNode.__init__", "RaftNode._tick_loop",
                         "RaftNode.handle_message", "HttpTransport.send",
                         "RaftNode._start_election", "RaftNode._prevote",
                         "RaftNode._on_request_prevote",
                         "RaftNode._step_down", "RaftNode._send_append",
                         "RaftNode._send_snapshot",
                         "RaftNode._advance_commit",
                         "RaftNode._broadcast_append"},
    # a scan reads the memory caches up to the applied watermark it took
    # under the vnode lock (raft's apply during catch-up tore a series'
    # timestamps from its fields: HTTP 500, "could not broadcast input
    # array from shape (100,) into shape (0,)"), and books the series it
    # sends to the per-series path for overlapping a file
    "storage/scan.py": {"_series_parts", "DeltaVnodeView.__init__",
                        "scan_vnode", "_mem_series_ids",
                        "_scan_vnode_native", "_plan_series",
                        "_discover_fields"},
    # the device branch answers as the host branch: an integer x/0 in a
    # device filter is NULL (it was 0) and a constant float division by
    # zero is IEEE (it raised ZeroDivisionError); a strict CAST of a
    # device value runs on the device with the host's conversions and
    # failure (it raised TypeError); an operation of two constants gives
    # SQL's answer on the host as on the device: `NOT (0 = 0)` and
    # `1 NOT BETWEEN 0 AND 2` were `~True`, -2, and matched every row, a
    # comparison with an integer x/0 of two constants (`(i / i) != (0 /
    # 0)`) matched the rows of an object array, `(i / 0) NOT BETWEEN -2
    # AND 1` matched NULLs, a NULL constant in BETWEEN raised TypeError,
    # and `2 NOT IN (2, NULL)` returned a one-row mask that kept every row
    "sql/expr.py": {"_div", "Cast.eval", "BinOp.eval", "Between.eval",
                    "InList.eval"},
    # the fused program declines an aggregate of a TAGS column (it
    # answered 0 or NULL, the tag read as an absent field), TRY_CAST and
    # casts to strings and timestamps
    "ops/tpu_exec.py": {"_device_eligible"},
}
# per file: functions and classes of the original that the port drops
DROPPED = {
    "server/main.py": {"_guard_degraded_relay"},
    # jax-purity guarded jit-traced bodies; the port compiles nothing
    # (its torch counterpart is TorchSync, below)
    "analysis/rules.py": {"_contains_jit", "_static_argnames", "JaxPurity"},
    # jit aliases and the retrace rule: nothing in the port calls
    # torch.compile or torch.jit
    "analysis/interproc.py": {"_contains_jit", "_static_argnames",
                              "Project._add_jit_alias", "RecompileHazard"},
    # a broadcast's sends run in each peer's sender (RaftNode._sender)
    "parallel/raft.py": {"RaftNode._safe_send_append"},
    # the span, its collector and the context span: the timeline's, in
    # utils/stages.py
    "server/trace.py": {"Span", "TraceCollector", "current_span"},
}
# per file: functions and classes the port adds
ADDED = {
    "storage/native.py": {"build_error"},
    # the libzstd binding: loading it, a buffer's address, an error code
    "utils/zstd_compat.py": {"_load_libzstd", "_buffer", "_check"},
    # Python truth tests and .item() on tensors: eager torch has no
    # tracer to refuse them, so the lint is their only guard
    "analysis/rules.py": {"TorchSync"},
    # the torch taint's helpers: where a torch call's result lives, the
    # kernel libraries' entry points, and the sites a rule reports or
    # sees suppressed (chip_smoke.py holds the card's syncs against them)
    "analysis/interproc.py": {"_torch_chain", "_is_cpu", "_is_dtype",
                              "_host_placed", "torch_call_kind", "to_kind",
                              "Project._mark_kernel_calls",
                              "Project._makes_device_value", "rule_sites"},
    # the replica restart: the tail an open leaves to raft, the index a
    # member resumes from, the members a boot starts, the watermark a
    # scan takes, and the part of a memory-cache series at or below it
    "storage/vnode.py": {"VnodeStorage.replay_raft_tail",
                         # the lock, its wait timed and its holder named
                         "VnodeStorage.locked"},
    # a propagated trace continued, as a function of the module
    "server/trace.py": {"from_headers"},
    # the timeline: the span (its thread and CPU time), the ring of
    # tuples it is recorded in and the context span, their clocks (the
    # monotonic one and the profiler's) and the map of the first onto
    # the monotonic clock's seconds, the ids; a wait
    # handed between threads, recorded as a stage
    "utils/stages.py": {"Span", "TraceCollector", "current_span", "now_ns",
                        "epoch_ns", "monotonic_s", "_id_str", "_as_dict",
                        "waited"},
    # the handlers' bodies inside their root spans
    "server/http.py": {"HttpServer._write", "HttpServer._sql"},
    "parallel/raft.py": {"WalLogStore.first_index",
                         "RaftNode.election_stats",
                         # the read index, its leadership check and
                         # round, and a peer's one sender
                         "RaftNode.read_index", "RaftNode._leading",
                         "RaftNode._confirm", "RaftNode._sender",
                         # the follower read index: a follower's request,
                         # and the leader's answer
                         "RaftNode._follower_read_index",
                         "RaftNode._on_read_index"},
    "parallel/replica.py": {"_resume_index", "open_local_members"},
    # the live raft leader as the node sees it, for the planner; the
    # leader reads, remote and local, one member check for both (the
    # scan RPC's handler, the tag reads and the view refreshes ask it
    # too; a node's tag read confirms its members through it), and the
    # scan lanes' request and reply helpers
    "parallel/coordinator.py": {"Coordinator._live_leader_vnode",
                                "Coordinator._leader_seen",
                                "Coordinator.confirm_read",
                                "Coordinator._confirm_members",
                                "Coordinator._leader_scan",
                                "Coordinator._decode_reply",
                                "Coordinator._local_leader_read",
                                "Coordinator._scan_payload",
                                # one scan attempt of _scan_local
                                "Coordinator._scan_local_once"},
    # the leader reads' counters
    "parallel/health.py": {"count_leader_read", "leader_read_counters",
                           "count_read_index", "read_index_counters"},
    # three-valued `!=` and BETWEEN of two constants and of NULLs
    "sql/expr.py": {"_ne", "_none_mask", "_cmp_truths"},
    "storage/scan.py": {"_mem_snapshot"},
    "storage/memcache.py": {"SeriesData.prefix"},
}


def _copied() -> list[str]:
    out = list(COPIED_FILES)
    for tree in COPIED_TREES:
        for dirpath, _dirs, files in os.walk(os.path.join(SRC, tree)):
            for f in files:
                if f.endswith(".py"):
                    out.append(os.path.relpath(os.path.join(dirpath, f), SRC))
    for f in os.listdir(os.path.join(SRC, "parallel")):
        if f.endswith(".py") and f not in NOT_COPIED_PARALLEL:
            out.append(os.path.join("parallel", f))
    return sorted(out)


def _mask(text: str, names: set, dropped: set = frozenset()) -> str:
    """Blank the bodies of the named (qualified) functions, and remove
    the `dropped` functions and classes outright."""
    lines = text.splitlines()
    found = set()

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef) \
                    and prefix + child.name in dropped:
                found.add(prefix + child.name)
                for i in range(child.lineno - 1, child.end_lineno):
                    lines[i] = ""
            elif isinstance(child, ast.ClassDef):
                visit(child, prefix + child.name + ".")
            elif isinstance(child, (ast.Try, ast.ExceptHandler)):
                # definitions under an import gate
                visit(child, prefix)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = prefix + child.name
                if q in names or q in dropped:
                    found.add(q)
                    # a function's decorators go with it
                    first = min([d.lineno for d in child.decorator_list]
                                + [child.lineno])
                    for i in range(first - 1, child.end_lineno):
                        lines[i] = ""
                    if q in names:
                        lines[child.lineno - 1] = f"<rewritten {q}>"

    visit(ast.parse(text), "")
    want = set(names) | set(dropped)
    assert found == want, f"functions not found: {want - found}"
    return "\n".join(ln for ln in lines if ln != "")


@pytest.mark.parametrize("rel", _copied())
def test_copy_is_verbatim_but_for_the_listed_edits(rel):
    with open(os.path.join(SRC, rel), encoding="utf-8") as f:
        want = f.read()
    path = os.path.join(DST, rel)
    if rel in NOT_COPIED:
        assert not os.path.exists(path), f"{rel} is left out of the port"
        return
    assert os.path.exists(path), f"{rel} missing from the port"
    with open(path, encoding="utf-8") as f:
        got = f.read()
    for old, new in GLOBAL_SUBS + SUBS.get(rel, []):
        if (old, new) not in GLOBAL_SUBS:
            assert old in want, f"{rel}: substitution source gone: {old!r}"
        want = want.replace(old, new)
    names = REWRITTEN.get(rel, set())
    if names or rel in DROPPED or rel in ADDED:
        want = _mask(want, names, DROPPED.get(rel, set()))
        got = _mask(got, names, ADDED.get(rel, set()))
    assert got == want, f"{rel} drifted from cnosdb_tpu/{rel}"


@pytest.mark.parametrize("rel", sorted(
    f"{tree}/" for tree in COPIED_TREES + ("parallel",)))
def test_no_port_only_files_in_copied_trees(rel):
    """The copied subtrees hold copies only (the port's own modules live
    in ops/ and as the two listed parallel/ files)."""
    copied = set(_copied())
    for dirpath, _dirs, files in os.walk(os.path.join(DST, rel)):
        for f in files:
            if not f.endswith(".py"):
                continue
            r = os.path.relpath(os.path.join(dirpath, f), DST)
            if rel == "parallel/" and f in NOT_COPIED_PARALLEL:
                continue
            assert r in copied, f"{r} is not a copy of a cnosdb_tpu module"


def test_rewritten_functions_touch_no_jax():
    for rel, names in REWRITTEN.items():
        with open(os.path.join(DST, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                for m in mods:
                    assert not (m or "").split(".")[0] == "jax", rel


# the port's copy of the JAX package's native/ host codecs: verbatim but
# for the libraries' headers, which host_libs.h stands in for
CSRC_DST = os.path.join(DST, "storage", "csrc")
CSRC_ADDED = {"host_libs.h"}
_LIB_INCLUDES = ("#include <zstd.h>", "#include <zlib.h>")


def _native_sources() -> list[str]:
    return sorted(f for f in os.listdir(os.path.join(REPO, "native"))
                  if f.endswith((".cpp", ".h")))


@pytest.mark.parametrize("name", _native_sources())
def test_csrc_copy_is_verbatim_but_for_the_library_includes(name):
    with open(os.path.join(REPO, "native", name), encoding="utf-8") as f:
        want = f.read().splitlines()
    with open(os.path.join(CSRC_DST, name), encoding="utf-8") as f:
        got = f.read().splitlines()
    assert not any(ln.strip() in _LIB_INCLUDES for ln in got), name
    has_libs = any(ln.strip() in _LIB_INCLUDES for ln in want)
    assert has_libs == ('#include "host_libs.h"' in got), name
    want = [ln for ln in want if ln.strip() not in _LIB_INCLUDES]
    got = [ln for ln in got if ln != '#include "host_libs.h"']
    assert got == want, f"storage/csrc/{name} drifted from native/{name}"


def test_csrc_adds_only_host_libs_h():
    have = {f for f in os.listdir(CSRC_DST) if f.endswith((".cpp", ".h"))}
    assert have == set(_native_sources()) | CSRC_ADDED
