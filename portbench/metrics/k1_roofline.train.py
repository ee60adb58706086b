"""K1's share of its roofline, in percent: at each shape and dtype at which
the cell's timed path calls the upsample-conv
(portbench/arith.py k1_train_cases), the least time the card could take
(FLOPs over the peak or bytes over HBM's rate, the larger), summed, over
the device time of its public entry at those shapes, summed (CUDA events
around many calls queued behind a spin, after the window)."""


def read(facts):
    k1 = facts.get("k1")
    if facts.get("kind_of_cell") != "train" or not k1:
        return None
    return 100.0 * sum(b for b, _ in k1) / sum(m for _, m in k1)
