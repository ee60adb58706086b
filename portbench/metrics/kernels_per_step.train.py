"""Device kernels a fused step: the kernels the profiler saw in the traced
calls (graph replays), copies and sets left out, over the steps they ran."""


def read(facts):
    tr = facts.get("trace")
    if facts.get("kind_of_cell") != "train" or tr is None:
        return None
    return len(tr.kernels()) / tr.units
