"""K1's part of the device's idle share, in percent: the traced slice's
device-idle time that lies inside the program's ``prdisagg.k1`` spans (the
host in an upsample-conv call while the card has nothing to run), by exact
intersection of intervals, over the slice's wall time.  At most
``program_idle_share.serve``.  None when the slice holds no
``prdisagg.request`` span (a program without spans)."""

from portbench.trace import union_us


def spans(tr, name):
    """The host spans called `name`, clipped to the slice's window."""
    lo, hi = tr.start_us, tr.start_us + tr.window_us
    return [(max(s, lo), min(e, hi)) for n, s, e in tr.host
            if n == name and s < hi and e > lo]


def read(facts):
    tr = facts.get("trace")
    if tr is None or not spans(tr, "prdisagg.request"):
        return None
    busy = [(s, e) for _, s, e in tr.device]
    # idle within the spans: what the spans add to the busy union
    idle = union_us(busy + spans(tr, "prdisagg.k1")) - union_us(busy)
    return 100.0 * idle / tr.window_us
