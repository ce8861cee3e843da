"""march_lane_use_pct: the march kernel's lane use over the traced calls,
lane-trips / (32 warp-trips) from the port's counter, in percent."""


def read(run):
    warps = sum(c["warp_trips"] for c in run.counters)
    if not warps:
        return None
    return 100.0 * sum(c["lane_trips"] for c in run.counters) / (32 * warps)
