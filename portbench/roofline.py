"""The table of peaks and the scan's least work: the yardstick of
``scan_roofline``.

Copied from ``chip_smoke.py:1415-1431`` (``MEM_RATE``, ``INT_RATE``,
``bound_ms``), with the scan's instruction count made a lower bound
(``scan_instr``): the old count, ``2W (3 + 6k + dam (3k + 2))``, is one
instruction per logical operation and shift, which a kernel using Hopper's
three-input logic (``LOP3``) and shifts on the FMA pipe (``IMAD.SHL``) can
beat.
"""

from __future__ import annotations

#: One H100 SXM (NVIDIA's data sheet), at its 700 W limit: device memory
#: bytes a second; 32-bit logic (``LOP3``) lane-instructions a second, the
#: integer ALU pipe's 64 lanes on each of 132 SMs at 1.98 GHz, its highest
#: clock.
MEM_RATE = 3.35e12
INT_RATE = 16.75e12


def scan_instr(W: int, k: int, damerau: bool) -> int:
    """The fewest 32-bit ``LOP3`` (three-input logic) instructions that the
    bit-parallel recurrence of ``scan_bits_wide_kernel`` (``Nfa::step_row``,
    ``csrc/packed_bitap.cuh``) needs per symbol over ``W`` 64-bit limbs,
    ``k`` error rows and, with ``damerau``, the transposition rows.

    Only ``LOP3`` is counted. Shifts need not run on the integer ALU pipe:
    a left shift's low half is an ``IMAD.SHL`` and the rest of a 64-bit
    shift can be built from ``IMAD`` and ``IMAD.HI`` too, on the FMA pipe.
    The shipped kernel already does this for some of its shifts. A logic
    function of overlapping words has no such path. A tree of m ``LOP3``
    reads at most 2m + 1 words, so a new word that depends on n words
    needs at least ceil((n - 1) / 2) ``LOP3``. Per 32-bit half of a limb:

    * row 0, ``n0 = ((r0 << 1) | st) & bc``: 3 words, 1;
    * error row 1, ``n1 = ((r1 << 1) & bc) | ((r0 | n0) << 1) | r0 | st``:
      6 words (``r1 << 1``, ``bc``, ``r0 << 1``, ``n0 << 1``, ``r0``,
      ``st``), 3;
    * each error row d >= 2: the same without ``st``, which row d - 1
      already holds (every error row ORs it in), 5 words, 2;
    * the hit test: the rows grow with d, so the top row's match bits
      alone, OR'd into the flag, 1;
    * Damerau, from k >= 1: ``bcm = (bc >> 1) & notlast`` once a symbol
      (1), and per error row the transposition word's update ``(x & bcm)``
      (1) and its term in the row's OR, one more word (1).

    So ``2W (2 + (2k + 1)(1 + dam))`` for k >= 1 and ``4W`` for k = 0.
    Loads, addresses, byte extraction, shifts and the loop are not
    counted: a floor under any kernel of this recurrence, which is what
    the roofline needs. (``chip_smoke.scan_instr`` counts every logical
    operation and shift, ``2W (3 + 6k + dam (3k + 2))``, which a kernel
    with ``LOP3`` and ``IMAD`` shifts beats.)"""
    rows = (2 * k + 1) * (2 if damerau else 1) if k >= 1 else 0
    return 2 * W * (2 + rows)


def bound_s(nbytes: float, ops: float):
    """(the least seconds the card could take, which of the two binds)."""
    t_bytes, t_ops = nbytes / MEM_RATE, ops / INT_RATE
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound_s(symbols: int, W: int, k: int, damerau: bool):
    """One scan pass over ``symbols`` corpus symbols: each symbol read once
    (1 byte) and each 32-bit hit word written once (a bit a symbol), against
    ``symbols * scan_instr(W, k, damerau)`` instructions."""
    return bound_s(symbols + symbols / 8, symbols * scan_instr(W, k, damerau))
