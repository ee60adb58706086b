"""The device's idle share of the traced slice, in percent: one minus the
union of its kernel, copy and set intervals over the slice's wall time
(whole calls of graph replays)."""


def read(facts):
    tr = facts.get("trace")
    if facts.get("kind_of_cell") != "train" or tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
