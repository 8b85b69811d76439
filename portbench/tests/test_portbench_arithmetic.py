"""The window's arithmetic, the idle union and the scan's least count, on
hand-made numbers."""

import pytest

from portbench import roofline, sass_check, stats, trace


def test_rate_over_all_bytes_and_all_time():
    # 3 searches of 100 MB in a 2 s window (first start to last end).
    assert stats.rate_mbps(100_000_000, 3, 2.0) == pytest.approx(150.0)


def test_p95_over_all_searches():
    lat = [i / 1000 for i in range(1, 101)]  # 1 .. 100 ms
    assert stats.p95_ms(lat) == pytest.approx(95.05)
    assert stats.p95_ms([0.004]) == pytest.approx(4.0)
    # one stall among 40 searches sets the tail
    assert stats.p95_ms([0.010] * 38 + [0.5, 0.5]) > 10.0


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert stats.union_s(iv, 0, 10) == pytest.approx(3 + 1 + 1)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.union_s([], 0, 1) == 0.0
    assert stats.gaps([], 0, 1) == [(0, 1)]


def test_trace_reduction_on_hand_made_events():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "search", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "search", "ts": 120, "dur": 80},
        {"ph": "X", "cat": "user_annotation", "name": "stage:decode", "ts": 60, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "void scan_bits_wide_kernel<4, 8, 1, true>(x)",
         "ts": 5, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void scan_bits_wide_kernel<4, 8, 1, true>(x)",
         "ts": 125, "dur": 40},
    ]
    t = trace.reduce(ev, [{}, {}], [], {"scan_bits_wide": 2}, 1000)
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(85e-6)
    idle = dict(t.breakdown["idle_gaps"])
    assert idle["decode"] == pytest.approx(40e-6)
    assert idle["between_searches"] == pytest.approx(20e-6)
    assert idle["search_other_host"] == pytest.approx(5e-6 + 10e-6 + 5e-6 + 35e-6)
    assert dict(t.breakdown["device_ops"])["scan_bits_wide_kernel<4, 8, 1, true>"] == \
        pytest.approx(70e-6)


@pytest.mark.parametrize("W, k, dam, want", [
    # LOP3 per 32-bit half: row 0 1, the hit test 1, error row 1 3 and each
    # further row 2; Damerau 1 a symbol and 2 an error row
    (1, 0, False, 2 * 1 * 2),
    (31, 1, True, 2 * 31 * (2 + 3 + 3)),
    (6, 8, False, 2 * 6 * (2 + 3 + 7 * 2)),
    (2, 2, True, 2 * 2 * (2 + 5 + 5)),
])
def test_scan_instr_hand_worked(W, k, dam, want):
    assert roofline.scan_instr(W, k, dam) == want


def test_scan_instr_is_under_the_old_count():
    old = lambda W, k, dam: 2 * W * (3 + 6 * k + ((3 * k + 2) if dam else 0))
    for W in (1, 6, 31, 64):
        for k in range(0, 25):
            for dam in (False, True):
                assert roofline.scan_instr(W, k, dam) <= old(W, k, dam)


SASS = """
        /*0100*/                   LDS.64 R40, [R5+0x100] ;
        /*0110*/                   IADD3 R7, R7, 0x1, RZ ;
        /*0120*/                   LEA R10, R8, R9, 0x5 ;
        /*0130*/                   LDS.128 R12, [R10] ;
        /*0140*/                   LDS.128 R16, [R10+0x10] ;
        /*0150*/                   LDS.64 R20, [R5+0x200] ;
        /*0160*/                   LOP3.LUT R30, R12, R20, R31, 0xf8, !PT ;
        /*0170*/                   IMAD.SHL.U32 R32, R30, 0x2, RZ ;
        /*0180*/                   LEA R10, R11, R9, 0x5 ;
        /*0190*/                   LDS.128 R12, [R10] ;
        /*01a0*/                   LDS.128 R16, [R10+0x10] ;
        /*01b0*/                   LDS.64 R20, [R5+0x208] ;
        /*01c0*/                   LOP3.LUT R30, R12, R20, R31, 0xf8, !PT ;
        /*01d0*/                   SHF.L.U64.HI R33, R30, 0x1, R31 ;
        /*01e0*/              @!P0 BRA 0x100 ;
"""


def test_sass_loop_counts_symbols_by_their_table_rows():
    # Two symbols of 4 limbs: each table row read through a base the loop
    # works out, 32 bytes; the match rows through one base, rows apart.
    loop = sass_check.sass_loop(SASS, 8 * 4)
    assert (loop["symbols"], loop["table_lds"], loop["lds"]) == (2, 4, 7)
    # the shift's low half on the FMA pipe (IMAD.SHL), its high half an SHF
    assert (loop["lop3"], loop["alu"], loop["imad"]) == (2, 4, 1)


def test_scan_bound_picks_the_larger():
    t, binds = roofline.scan_bound_s(96 << 20, 31, 1, True)
    assert binds == "operations"
    assert t == pytest.approx((96 << 20) * 496 / roofline.INT_RATE)
    # a symbol's byte and its hit bit take 1.125 / 3.35e12 s, four LOP3
    # 4 / 16.75e12 s: at one limb and k = 0 the bytes bind
    t, binds = roofline.scan_bound_s(1000, 1, 0, False)
    assert binds == "bytes" and t == pytest.approx(1125 / roofline.MEM_RATE)
    assert roofline.bound_s(1e6, 1e6) == (pytest.approx(1e6 / roofline.MEM_RATE), "bytes")
