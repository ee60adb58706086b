"""Host synchronisations a request: the CUDA runtime calls that block the
host until the device is done (stream, device and event synchronises and
``cudaMemcpy`` without ``Async``; a suffix such as ``_ptsz`` ignored) that
start inside one of the program's ``prdisagg.request`` spans in the traced
slice, over the slice's requests.  None when the slice holds no request
span (a program without spans)."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def read(facts):
    tr = facts.get("trace")
    if tr is None:
        return None
    lo, hi = tr.start_us, tr.start_us + tr.window_us
    requests = [(max(s, lo), min(e, hi)) for n, s, e in tr.host
                if n == "prdisagg.request" and s < hi and e > lo]
    if not requests:
        return None
    syncs = [s for n, s, _ in tr.host if n.split("_")[0] in SYNCS]
    return sum(any(a <= t <= b for a, b in requests)
               for t in syncs) / tr.units
