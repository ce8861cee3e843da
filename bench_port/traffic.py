"""The one generator of every traffic mix.

A mix (`traffic/<name>.json`) names the entry its calls go to and the
parameters each call draws:

    "draws": {"a0": [0.997936, 0.998]}  a range for each drawn parameter
    "strata": 64                        calls a cycle

Every seed makes the same set of values: each cycle of `strata` calls
gives every parameter one value in each of its `strata` equal parts of
its range (a Latin hypercube), at an offset inside the part drawn from
the seed, in an order drawn from the seed.  So two seeds do the same
work in another order, and a seed always makes the same calls.  The rest
of the mix (sizes, sample counts) is read by the entry and the harness.
"""

import numpy as np


def rng(seed, *stream):
    """A numpy Generator for the stream `stream` of `seed`: the harness's
    calls, warm-up calls, samples and each sampled answer draw from
    streams of their own, so that one never shifts another."""
    return np.random.default_rng([int(seed) % 2 ** 64, *stream])


def calls(mix, seed, stream=0):
    """The endless sequence of the mix's calls for `seed`: dicts of the
    drawn parameters, Python floats."""
    draws = mix.get("draws", {})
    k = int(mix.get("strata", 1))
    g = rng(seed, 0, stream)
    while True:
        cycle = {}
        for name in sorted(draws):
            lo, hi = (float(v) for v in draws[name])
            order = g.permutation(k)
            offset = g.random(k)
            cycle[name] = lo + (order + offset) / k * (hi - lo)
        for i in range(k):
            yield {name: float(v[i]) for name, v in cycle.items()}


def sampled(mix, seed):
    """The indices of the window's calls whose answers are judged: the
    mix's `sample.calls` distinct indices below `sample.among`, drawn from
    the seed (every run makes at least `among` calls)."""
    s = mix["sample"]
    g = rng(seed, 1)
    return sorted(int(i) for i in g.choice(int(s["among"]), int(s["calls"]),
                                           replace=False))
