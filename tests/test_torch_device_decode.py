"""The port's device-decode lane against the JAX package and the host
decoder, bit for bit.

K2 (cnosdb_tpu_torch.ops.device_decode: xor_scan, the Gorilla prefix-XOR
scan, and gorilla_decode, the whole plane-assembly + scan decode) runs
its plain PyTorch version here and is held against the JAX package's
Pallas scan in interpret mode (CNOSDB_TPU_PALLAS=1) and its XLA decode. The whole
lane (X3 programs + K2) must reproduce storage/codecs.decode and
cnosdb_tpu's DeviceDecodeLane exactly over the test_device_decode.py
cases, and the scan's third lane must give the same batches as the
Python scan.
"""
import os

import numpy as np
import pytest
import torch

from cnosdb_tpu.ops import device_decode as jdd
from cnosdb_tpu_torch.models.codec import Encoding
from cnosdb_tpu_torch.models.points import SeriesRows, WriteBatch
from cnosdb_tpu_torch.models.schema import TskvTableSchema, ValueType
from cnosdb_tpu_torch.models.series import SeriesKey
from cnosdb_tpu_torch.models.strcol import DictArray
from cnosdb_tpu_torch.ops import device_decode as tdd
from cnosdb_tpu_torch.storage import codecs
from cnosdb_tpu_torch.storage.scan import scan_vnode
from cnosdb_tpu_torch.storage.vnode import VnodeStorage


@pytest.fixture(autouse=True)
def _cpu_placement(monkeypatch):
    monkeypatch.setenv("CNOSDB_TORCH_PLACEMENT", "cpu")


def _lane_decode(lane, block: bytes, vt: ValueType) -> np.ndarray:
    """Round one encoded block through a decode lane (the port's or the
    JAX package's) → decoded values shaped like codecs.decode's output."""
    plan, reason = codecs.split_for_device(block, vt)
    assert plan is not None, f"split rejected: {reason}"
    n = plan["n"]
    if vt in (ValueType.STRING, ValueType.GEOMETRY):
        got = {}

        def sink(dense, _plan=plan):
            got["vals"] = np.asarray(_plan["values"])[dense]

        lane.submit(plan, "tok", "c", vt, 0, n, None, None, None, sink=sink)
        assert lane.run() == []
        return got["vals"]
    out_vals = np.zeros(n, dtype=vt.numpy_dtype())
    out_valid = np.zeros(n, dtype=bool)
    lane.submit(plan, "tok", "c", vt, 0, n, None, out_vals, out_valid)
    assert lane.run() == []
    assert out_valid.all()
    return out_vals


def _assert_bit_identical(a: np.ndarray, b: np.ndarray):
    assert a.dtype == b.dtype
    if a.dtype == np.float64:
        # NaN payloads included: compare the raw bit patterns
        np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))
    else:
        np.testing.assert_array_equal(a, b)


def _check(block: bytes, vt: ValueType):
    """Port lane == host decode == the JAX package's lane."""
    host = codecs.decode(block, vt)
    if vt == ValueType.STRING:
        host = np.asarray(host.materialize(), dtype=object)
    got = _lane_decode(tdd.DeviceDecodeLane(), block, vt)
    ref = _lane_decode(jdd.DeviceDecodeLane(interpret=True), block, vt)
    if vt == ValueType.STRING:
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got, ref)
        return
    _assert_bit_identical(got, host)
    _assert_bit_identical(got, ref)


_LENGTHS = [1, 2, 3, 127, 128, 129, 1000, 4096]


@pytest.mark.parametrize("n", _LENGTHS)
def test_delta_i64_parity(rng, n):
    vals = rng.integers(-(1 << 40), 1 << 40, n).cumsum()
    _check(codecs.encode(vals, ValueType.INTEGER, Encoding.DELTA),
           ValueType.INTEGER)


def test_delta_i64_extreme_values():
    vals = np.array([np.iinfo(np.int64).min, -1, 0, 1,
                     np.iinfo(np.int64).max, 7, -(1 << 62)], np.int64)
    _check(codecs.encode(vals, ValueType.INTEGER, Encoding.DELTA),
           ValueType.INTEGER)


@pytest.mark.parametrize("n", _LENGTHS)
def test_delta_ts_const_stride_parity(rng, n):
    ts = int(rng.integers(0, 1 << 50)) \
        + np.arange(n, dtype=np.int64) * 30_000_000
    _check(codecs.encode_timestamps(ts), ValueType.INTEGER)


@pytest.mark.parametrize("n", _LENGTHS)
def test_unsigned_parity(rng, n):
    vals = rng.integers(0, np.iinfo(np.uint64).max, n, dtype=np.uint64)
    _check(codecs.encode(vals, ValueType.UNSIGNED, Encoding.DELTA),
           ValueType.UNSIGNED)


@pytest.mark.parametrize("n", _LENGTHS)
def test_gorilla_f64_parity(rng, n, monkeypatch):
    monkeypatch.setenv("CNOSDB_TPU_PALLAS", "1")   # the JAX side: Pallas
    vals = rng.normal(20.0, 5.0, n).round(3)
    before = tdd.xor_engagements()
    _check(codecs.encode(vals, ValueType.FLOAT, Encoding.GORILLA),
           ValueType.FLOAT)
    assert tdd.xor_engagements() > before


def test_gorilla_f64_special_values(monkeypatch):
    monkeypatch.setenv("CNOSDB_TPU_PALLAS", "1")
    vals = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324,
                     np.finfo(np.float64).max, 1.0, 1.0, 1.0], np.float64)
    _check(codecs.encode(vals, ValueType.FLOAT, Encoding.GORILLA),
           ValueType.FLOAT)


@pytest.mark.parametrize("n", _LENGTHS)
def test_bitpack_bool_parity(rng, n):
    vals = rng.random(n) < 0.5
    _check(codecs.encode(vals, ValueType.BOOLEAN, Encoding.BITPACK),
           ValueType.BOOLEAN)


@pytest.mark.parametrize("n", [1, 127, 1000])
def test_dict_string_parity(rng, n):
    words = np.array(["", "ok", "wärn", "err", "crité"], dtype=object)
    vals = words[rng.integers(0, len(words), n)]
    _check(codecs.encode(vals, ValueType.STRING), ValueType.STRING)


@pytest.mark.parametrize("shape", [(1, 128), (4, 1024), (8, 4096)])
def test_k2_plain_matches_pallas_xor_scan(shape):
    """K2 scans u64 words; the JAX package scans the lo and hi u32 halves
    with its Pallas kernel (interpret) — XOR is bitwise, so the halves of
    the port's result must equal the JAX scans exactly. (Row lengths are
    powers of two, as the lane's length buckets are.)"""
    import jax.numpy as jnp

    rng = np.random.default_rng(shape[1])
    words = rng.integers(0, np.iinfo(np.uint64).max, shape, dtype=np.uint64,
                         endpoint=True)
    got = tdd.xor_scan(torch.from_numpy(words.view(np.int64))).numpy()
    got = got.view(np.uint64)
    lo = jdd._pallas_xor_scan(jnp.asarray(words.astype(np.uint32)), True)
    hi = jdd._pallas_xor_scan(
        jnp.asarray((words >> np.uint64(32)).astype(np.uint32)), True)
    want = (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.bitwise_xor.accumulate(words,
                                                                 axis=1))


def _gorilla_planes(rng, n: int, b: int, special: bool = False):
    """[b, 8, L] u8 byte planes as the lane uploads them (L the pow2
    length bucket of n, rows zero past n) from real Gorilla pages, and
    the [b, n] f64 values they encode."""
    width = tdd._pow2(n, tdd._MIN_LANE)
    planes = np.zeros((b, 8, width), dtype=np.uint8)
    vals = np.empty((b, n), dtype=np.float64)
    for bi in range(b):
        if special:
            v = rng.permutation(_SPECIAL)[np.arange(n) % len(_SPECIAL)]
        else:
            v = rng.normal(20.0, 5.0, n).round(3)
        plan, reason = codecs.split_for_device(
            codecs.encode(v, ValueType.FLOAT, Encoding.GORILLA),
            ValueType.FLOAT)
        assert plan is not None and plan["kind"] == "gorilla", reason
        planes[bi, :, :n] = np.frombuffer(plan["raw"],
                                          dtype=np.uint8).reshape(8, n)
        vals[bi] = v
    return planes, vals


_SPECIAL = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324,
                     np.finfo(np.float64).max, 1.0, 1.0, 1.0], np.float64)


def _jax_gorilla(planes: np.ndarray):
    """The JAX package's decode of the same planes two ways: its XLA
    kernel, and its Pallas scan (interpret mode) between the plane
    assembly and the recombination. → two [B, L] u64 arrays."""
    import jax.numpy as jnp

    p = jnp.asarray(planes)
    xla = np.asarray(jdd._gorilla_xla_kernel(p)).view(np.uint64)
    lo, hi = jdd._gorilla_pre_kernel(p)
    lo = jdd._pallas_xor_scan(lo, True)
    hi = jdd._pallas_xor_scan(hi, True)
    pallas = np.asarray(jdd._gorilla_post_kernel(lo, hi)).view(np.uint64)
    return xla, pallas


@pytest.mark.parametrize("b", [1, 3, 32])
@pytest.mark.parametrize("n", _LENGTHS)
def test_gorilla_decode_plain_matches_jax(n, b):
    """K2's whole-decode entry (its plain version on the CPU) against the
    JAX package's XLA decode and its Pallas scan, bit for bit, on ragged
    rows inside the padded length bucket."""
    planes, vals = _gorilla_planes(np.random.default_rng(n * 7 + b), n, b)
    got = tdd.gorilla_decode(torch.from_numpy(planes)).numpy().view(np.uint64)
    xla, pallas = _jax_gorilla(planes)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got[:, :n], vals.view(np.uint64))


@pytest.mark.parametrize("b", [1, 3, 32])
def test_gorilla_decode_plain_special_values(b):
    planes, vals = _gorilla_planes(np.random.default_rng(b), 40, b,
                                   special=True)
    got = tdd.gorilla_decode(torch.from_numpy(planes)).numpy().view(np.uint64)
    xla, pallas = _jax_gorilla(planes)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got[:, :40], vals.view(np.uint64))


def test_gorilla_decode_rejects_bad_input():
    with pytest.raises(ValueError):
        tdd.gorilla_decode(torch.zeros((2, 7, 128), dtype=torch.uint8))
    with pytest.raises(ValueError):
        tdd.gorilla_decode(torch.zeros((2, 8, 128), dtype=torch.int64))


def test_k2_rejects_bad_input():
    with pytest.raises(ValueError):
        tdd.xor_scan(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        tdd.xor_scan(torch.zeros((2, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# outcome booking
# ---------------------------------------------------------------------------
def test_declined_and_decoded_pages_book_outcomes(rng):
    before = tdd.outcomes_snapshot()
    lane = tdd.DeviceDecodeLane()
    assert not lane.accepts(int(ValueType.INTEGER), int(Encoding.QUANTILE))
    assert lane.accepts(int(ValueType.FLOAT), int(Encoding.GORILLA))
    lane.declined("encoding", 3)
    eng = tdd.engagements()
    block = codecs.encode(rng.integers(0, 9, 64), ValueType.INTEGER,
                          Encoding.DELTA)
    _lane_decode(lane, block, ValueType.INTEGER)
    snap = tdd.outcomes_snapshot()
    assert snap[("host", "encoding")] == before.get(("host", "encoding"),
                                                     0) + 3
    assert snap[("device", "ok")] > before.get(("device", "ok"), 0)
    assert tdd.engagements() > eng
    assert ("host", "kernel_error") not in snap


# ---------------------------------------------------------------------------
# end to end: the scan's third lane
# ---------------------------------------------------------------------------
def _schema():
    return {"m": TskvTableSchema.new_measurement(
        "t", "db", "m", tags=["host"],
        fields=[("f", ValueType.FLOAT), ("i", ValueType.INTEGER),
                ("b", ValueType.BOOLEAN), ("s", ValueType.STRING)])}


def _write(v, host, ts, **cols):
    types = {"f": ValueType.FLOAT, "i": ValueType.INTEGER,
             "b": ValueType.BOOLEAN, "s": ValueType.STRING}
    fields = {name: (int(types[name]),
                     [None if x is None
                      else (x.item() if isinstance(x, np.generic) else x)
                      for x in xs])
              for name, xs in cols.items() if xs is not None}
    wb = WriteBatch()
    wb.add_series("m", SeriesRows(SeriesKey("m", {"host": host}),
                                  list(ts), fields))
    v.write(wb)


def _assert_batches_equal(a, b):
    assert a.n_rows == b.n_rows
    np.testing.assert_array_equal(a.series_ids, b.series_ids)
    np.testing.assert_array_equal(a.ts, b.ts)
    np.testing.assert_array_equal(a.sid_ordinal, b.sid_ordinal)
    assert set(a.fields) == set(b.fields)
    for name in a.fields:
        vt_a, vals_a, valid_a = a.fields[name]
        vt_b, vals_b, valid_b = b.fields[name]
        assert vt_a == vt_b
        np.testing.assert_array_equal(valid_a, valid_b)
        if isinstance(vals_a, DictArray) or isinstance(vals_b, DictArray):
            obj_a = np.asarray(vals_a.materialize()
                               if isinstance(vals_a, DictArray) else vals_a)
            obj_b = np.asarray(vals_b.materialize()
                               if isinstance(vals_b, DictArray) else vals_b)
            np.testing.assert_array_equal(obj_a[valid_a], obj_b[valid_b])
        else:
            np.testing.assert_array_equal(vals_a[valid_a], vals_b[valid_b])


def _device_scan(v, **kw):
    got = scan_vnode(v, "m", decode_hook=tdd.DeviceDecodeLane, **kw)
    os.environ["CNOSDB_NO_NATIVE_SCAN"] = "1"
    try:
        want = scan_vnode(v, "m", **kw)
    finally:
        del os.environ["CNOSDB_NO_NATIVE_SCAN"]
    return got, want


def test_scan_device_lane_equivalence(tmp_engine_dir, rng):
    v = VnodeStorage(1, tmp_engine_dir, schemas=_schema())
    n = 1200
    _write(v, "h1", range(n), f=rng.normal(size=n),
           i=rng.integers(-50, 50, n), b=rng.integers(0, 2, n) > 0,
           s=[f"v{x}" for x in rng.integers(0, 5, n)])
    _write(v, "h2", range(500, 900), f=rng.normal(size=400))
    v.flush()
    before = tdd.engagements()
    got, want = _device_scan(v)
    assert tdd.engagements() > before, \
        "scan did not engage the device-decode lane"
    _assert_batches_equal(got, want)
    v.close()


def test_scan_device_lane_with_nulls(tmp_engine_dir):
    v = VnodeStorage(1, tmp_engine_dir, schemas=_schema())
    n = 500
    _write(v, "h1", range(n),
           f=[float(x) if x % 2 == 0 else None for x in range(n)],
           i=[int(x) if x % 3 == 0 else None for x in range(n)],
           s=[f"s{x}" if x % 5 == 0 else None for x in range(n)])
    v.flush()
    got, want = _device_scan(v)
    _assert_batches_equal(got, want)
    v.close()


def test_scan_device_lane_attaches_device_columns(tmp_engine_dir, rng):
    """Null-free columns fully decoded on the device attach to the batch
    as `_preuploaded` tensors through EagerUploader.put_device — and the
    staged values match the host arrays exactly."""
    from cnosdb_tpu_torch.ops.device_cache import EagerUploader

    v = VnodeStorage(1, tmp_engine_dir, schemas=_schema())
    n = 800
    f = rng.normal(size=n)
    i = rng.integers(-1000, 1000, n)
    _write(v, "h1", range(n), f=f, i=i)
    v.flush()
    got = scan_vnode(v, "m", upload_hook=EagerUploader,
                     decode_hook=tdd.DeviceDecodeLane)
    pre = getattr(got, "_preuploaded", None)
    assert pre is not None, "no columns were staged on the device"
    n_pad, cols = pre
    for name, host_vals in (("f", f), ("i", i)):
        assert name in cols, f"column {name} not device-resident"
        vt, dev_vals, dev_valid, all_valid = cols[name]
        assert all_valid and dev_valid is None
        np.testing.assert_array_equal(
            dev_vals[:n].numpy().astype(host_vals.dtype), host_vals)
    v.close()
