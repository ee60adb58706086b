"""Device-to-host copy milliseconds a request: the profiler's DtoH memcpy
time in the traced slice over its requests (the response's host copy)."""


def read(facts):
    tr = facts.get("trace")
    if facts.get("kind_of_cell") != "serve" or tr is None:
        return None
    copies = tr.memcpy("Memcpy DtoH")
    if not copies:
        return None
    return sum(e - s for _, s, e in copies) / 1e3 / tr.units
