"""index_codec_idle_share: the share of the traced window in which the
device waited while the host was in the port's index codec, in %: 100 x the
idle gaps named `exchange/encode/index` or `exchange/decode/index` (the
innermost span the host was in when the gap began) over the window. None
without those spans or without device operations."""

SPANS = ("exchange/encode/index", "exchange/decode/index")


def read(ctx):
    d = ctx["digest"]
    if d["window_ns"] <= 0 or d["busy_ns"] <= 0 or not any(d["spans"].get(name) for name in SPANS):
        return None
    return 100.0 * sum(ns for name, ns in d["gaps"] if name in SPANS) / d["window_ns"]
