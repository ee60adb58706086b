"""Served scenarios per second: every scenario returned to the host in the
window, over the window's host seconds."""


def read(facts):
    if facts.get("kind_of_cell") != "serve" or not facts.get("units"):
        return None
    return facts["scenarios"] / facts["window_s"]
