"""fwd_bwd_device_ms: device milliseconds a step of the operations whose
launch the host made inside the port's `train/forward_backward` span."""


def read(ctx):
    d = ctx["digest"]
    ns = sum(b - a for a, b, _, owner in d["device"] if owner == "train/forward_backward")
    return ns / 1e6 / d["steps"] if ns else None
