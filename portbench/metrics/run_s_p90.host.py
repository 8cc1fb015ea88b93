"""The 90th percentile of the window's run seconds (host clock): the wait
MD-Bench users read as TOTAL, stalls included. Per-layer, for a cell whose
card idles too much for the tail to bear a bound."""

import statistics

WINDOW = True  # reads the timed window's run times


def read(m):
    if len(m.run_times) < 2:
        return None
    return statistics.quantiles(m.run_times, n=10)[8]
