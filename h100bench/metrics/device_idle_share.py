"""device_idle_share: the share of the traced window in which no device
operation ran, in %: 100 x (1 - union of the operations' intervals /
window)."""


def read(ctx):
    d = ctx["digest"]
    return 100.0 * (1.0 - d["busy_ns"] / d["window_ns"]) if d["window_ns"] > 0 and d["busy_ns"] > 0 else None
