"""Frozen copies of the program's sound arithmetic for rooflines and for
trusting a device trace, each with the file and line it came from
(chip_smoke.py at the commit before this benchmark). Later changes to
the program do not move these.
"""
from __future__ import annotations

# chip_smoke.py:224 HBM_BYTES_PER_S: NVIDIA's data sheet, H100 SXM, at
# the card's full 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def k1_bytes(n: int, ns: int) -> int:
    """chip_smoke.py:519 k1_bytes: what K1's function must move: values,
    valid flags and segment ids in (13 B a row), count/sum/min/max out
    (28 B a segment)."""
    return n * (8 + 1 + 4) + ns * (4 + 8 * 3)


def k2_bytes(b: int, width: int) -> int:
    """chip_smoke.py:595 compare_k2's `moved`: K2 over [b, width] words
    reads 8 B a word (byte planes or XOR words) and writes the 8 B f64
    bits: 16 B a word."""
    return b * width * (8 + 8)


def trace_complete(uploads: int, launches: dict) -> bool:
    """chip_smoke.py:680-755 profile_query's check: every K1 launch and
    every X4 op uploads its input, so a trace that kept fewer
    host-to-device copies than those launches has lost device events
    (K2, which decodes pages already on the card, is not counted)."""
    want = sum(n for k, n in launches.items() if k != "K2")
    return uploads >= want
