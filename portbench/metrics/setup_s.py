"""Set-up seconds: from the process's start (before torch is imported) to
the end of the warm-up, a synchronise included: loading, the kernels'
build or load, weights and data made on the card, the warm-up calls (for
training, the graph's capture and the checked steps)."""


def read(facts):
    return facts.get("setup_s")
