"""The model's share of the card's peak in the window, in percent: the
frozen FLOP count of a request (portbench/arith.py) times those completed,
over the window's seconds times the peak of the cell's precision."""


def read(facts):
    if facts.get("kind_of_cell") != "serve" or not facts.get("units"):
        return None
    return (100.0 * facts["flops_per_unit"] * facts["units"]
            / (facts["window_s"] * facts["peak_flops"]))
