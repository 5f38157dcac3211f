"""The 95th percentile of every query's time in the window, from its call
to its result ready on the card (host clock, ms)."""

import statistics


def read(rec):
    lat = rec.latencies_s
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
