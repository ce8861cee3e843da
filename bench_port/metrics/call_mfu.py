"""call_mfu: the whole call's share of the chip's peak: the least time of
the frozen work of every kernel the cell lists (`mfu_parts` of its cell
file: readers whose `work(run)` counts their kernel's operations), by
operations alone, over the traced calls' wall time, in percent."""

from bench_port import readers, roofline


def read(run):
    parts = run.cell.get("mfu_parts")
    if not parts or not readers.traced(run):
        return None
    t = 0.0
    for name in parts:
        ops, _ = run.registry.metric(name).work(run)
        t += sum(n / roofline.PEAK_FLOPS[p] for p, n in ops.items())
    return 100.0 * t / readers.call_seconds(run)
