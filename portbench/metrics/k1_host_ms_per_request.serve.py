"""K1's host milliseconds a request: the host's wall time inside the
program's ``prdisagg.k1`` spans (one upsample-conv call each: its checks,
weight pack and launch), their union clipped to the traced slice, over the
slice's requests.  None when the slice holds no ``prdisagg.request`` span
(a program without spans)."""

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
    return union_us(spans(tr, "prdisagg.k1")) / 1e3 / tr.units
