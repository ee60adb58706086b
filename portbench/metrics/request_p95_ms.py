"""The nearest-rank 95th percentile of the window's request latencies, each
on the host clock from the call to the returned array."""

import math


def read(facts):
    lat = sorted(facts.get("latencies_ms") or [])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
