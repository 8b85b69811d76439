"""``scan_roofline``: the least time of the scan's work (``roofline``) over
the profiler's device time of the scan kernel's launches, summed over the
traced searches. Each search's scan passes (one a table it scanned) read
every corpus symbol once; the count is taken for the W, k and Damerau flag
of the tables each pass ran. A traced run whose profiler recorded fewer
launches of the kernel than the port's counter fails: a share is never
read over part of the launches."""

from portbench import roofline

KERNEL = {True: ("scan_bits_wide", "scan_bits_wide_kernel<"),
          False: ("scan_bits", "scan_bits_kernel<")}


def read(trace):
    if not trace.scan_calls:
        return None
    least = device = 0.0
    binds = set()
    for wide in sorted({c["wide"] for c in trace.scan_calls}):
        counter, name = KERNEL[wide]
        durs = [d for k, d in trace.kernels if name in k]
        if len(durs) != trace.launches.get(counter, 0):
            raise RuntimeError(f"the profiler recorded {len(durs)} launches of {name[:-1]}, the "
                               f"port counted {trace.launches.get(counter, 0)}")
        passes = {(c["search"], c["table"]): c for c in trace.scan_calls if c["wide"] == wide}
        for c in passes.values():
            t, b = roofline.scan_bound_s(trace.corpus_bytes, c["W"], c["k"], c["damerau"])
            least += t
            binds.add(b)
        device += sum(durs)
    note = (f"scan_roofline: least {least * 1e3:.6f} ms ({'/'.join(sorted(binds))} bound) over "
            f"{device * 1e3:.6f} device ms")
    return 100.0 * least / device, note
