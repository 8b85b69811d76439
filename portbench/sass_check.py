"""Cross-check of ``roofline.scan_instr`` against the shipped scan kernel's
SASS, run once on the card after a build:

    python portbench/sass_check.py

For every instance ``<LPL, G, K, DAM>`` of ``scan_bits_wide_kernel`` with
K >= 1 in the port's built library, it finds the main loop and prints its
``LOP3`` a (limb, symbol) beside ``scan_instr(1, K, DAM)``, which must be
at most that, and its other integer ALU and ``IMAD`` instructions. The
loop's static body holds all K rows, so it is the work of a run at k = K
(the masked instances skip the rows past a smaller k at run time).
``sass_loop`` follows ``chip_smoke.py:1341-1388``, with the symbols an
iteration counted from the table-row loads alone, not from every shared
load (the match rows' loads too, where they are not held in registers).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

#: Integer ALU-pipe instructions besides ``LOP3``.
ALU_OPS = ("SHF", "IADD3", "ISETP", "SEL", "PRMT", "LEA", "IMNMX", "VIMNMX", "POPC", "FLO",
           "SGXT", "BMSK", "PLOP3", "IABS", "LOP", "VIADD")
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _dest(op: str, args: str):
    """The registers an instruction writes: its first operand where that is
    a register (stores, branches and compares into predicates write none)."""
    mo = re.match(r"\s*R(\d+)\b", args)
    if mo is None or op.startswith(("ST", "RED", "ATOM", "BRA")):
        return ()
    width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
    return [str(int(mo.group(1)) + i) for i in range(width)]


def _table_bytes(body, limb_bytes: int):
    """(bytes, loads) of the body's shared loads of table rows. Loads are
    grouped by the value of their base register (a register and the write
    that set it, or the value it held before the loop). A symbol's table row
    is one group whose offsets span one lane's limbs of a row
    (``limb_bytes``); the match rows, where not held in registers, are read
    through a base that spans rows (a row's stride apart)."""
    version, groups = {}, {}
    for o, a in body:
        base = re.search(r"\[R(\d+)(?:\+(?:U?R\d+\+?)?)?(?:0x([0-9a-f]+))?\]", a)
        if o.startswith("LDS") and base:
            width = 16 if ".128" in o else 8 if ".64" in o else 4
            off = int(base.group(2) or "0", 16)
            key = (base.group(1), version.get(base.group(1), 0))
            groups.setdefault(key, []).append((off, width))
        for r in _dest(o, a):
            version[r] = version.get(r, 0) + 1
    table = loads = 0
    for g in groups.values():
        span = max(o + w for o, w in g) - min(o for o, _ in g)
        if span <= limb_bytes:
            table += sum(w for _, w in g)
            loads += len(g)
    return table, loads


def sass_loop(sass: str, limb_bytes: int):
    """The main loop of one kernel's SASS (``cuobjdump -sass -fun``): of the
    innermost loops that load from shared memory, the one with the most
    loads. The symbols an iteration are the bytes of its table-row loads
    (``_table_bytes``) over ``limb_bytes``, a lane's limbs of one table
    row. Returns {"instructions", "lds", "table_lds", "symbols", "lop3",
    "alu", "imad", "ops"}, or None."""
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in INSTR.finditer(sass)]
    spans = []
    for addr, op, args in ins:
        tgt = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and tgt and int(tgt.group(1), 16) <= addr:
            spans.append((int(tgt.group(1), 16), addr))

    def lds(span):
        return sum(o.startswith("LDS") for a, o, _ in ins if span[0] <= a <= span[1])

    inner = [sp for sp in spans if lds(sp) and not any(
        o != sp and sp[0] <= o[0] and o[1] <= sp[1] and lds(o) for o in spans)]
    if not inner:
        return None
    main = max(inner, key=lds)
    body = [(o, args) for a, o, args in ins if main[0] <= a <= main[1]]
    table, table_lds = _table_bytes(body, limb_bytes)
    ops = {}
    for o, _ in body:
        ops[o.split(".")[0]] = ops.get(o.split(".")[0], 0) + 1
    return {"instructions": len(body), "lds": lds(main), "table_lds": table_lds,
            "symbols": table // limb_bytes, "lop3": ops.get("LOP3", 0),
            "alu": sum(ops.get(o, 0) for o in ALU_OPS), "imad": ops.get("IMAD", 0), "ops": ops}


def cuobjdump(so_path: str, mangled: str) -> str:
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        raise FileNotFoundError("cuobjdump")
    return subprocess.run([tool, "-sass", "-fun", mangled, so_path], capture_output=True,
                          text=True, timeout=300).stdout


def report(lpl: int, g: int, K: int, dam: bool, sass: str) -> str:
    from portbench.roofline import scan_instr

    # a lane reads a u64 for each of its limbs of a symbol's table row
    loop = sass_loop(sass, 8 * lpl)
    head = f"sass <{lpl}, {g}, {K}, {dam}>: "
    if loop is None or loop["symbols"] == 0:
        return head + "no loop found"
    per = lambda n: n / loop["symbols"] / lpl
    floor = scan_instr(1, K, dam)
    return (head + f"{loop['symbols']} symbols ({loop['table_lds']} of {loop['lds']} shared loads "
            f"are table rows), {loop['instructions']} instructions; a (limb, symbol): LOP3 "
            f"{per(loop['lop3']):.2f} against scan_instr(1, {K}, {dam}) = {floor}"
            f"{'' if per(loop['lop3']) >= floor else ' BELOW THE FLOOR'}; other ALU "
            f"{per(loop['alu']):.2f}, IMAD {per(loop['imad']):.2f}; ops {loop['ops']}")


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from fuzzy_aho_corasick_tpu_torch.ops import _cuda_build

    kern = _cuda_build.load()
    print(f"library {kern.path}")
    # Instances scan_bits_wide_kernel<LPL, G, K, DAM>, from the ptxas report
    # of the build: dict1k's <4, 8, 1, true> (W = 31, k = 1, Damerau) and
    # ocr-names' <1, 8, 12, false> (W = 6, k = 8, masked to 12 rows) among them.
    pat = r"'(_Z\w*scan_bits_wide_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E\w*)'"
    for mo in sorted(set(re.findall(pat, kern.log)), key=lambda m: tuple(map(int, m[1:]))):
        lpl, g, K, dam = int(mo[1]), int(mo[2]), int(mo[3]), mo[4] == "1"
        if K:
            print(report(lpl, g, K, dam, cuobjdump(str(kern.path), mo[0])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
