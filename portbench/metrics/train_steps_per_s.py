"""Fused train steps per second: every step the window's calls ran, over
the host seconds from the first call to the synchronise after the last."""


def read(facts):
    if facts.get("kind_of_cell") != "train" or not facts.get("units"):
        return None
    return facts["units"] / facts["window_s"]
