"""index_codec_host_ms: host milliseconds a step inside the port's
`exchange/encode/index` and `exchange/decode/index` spans (the index codec
of every leaf: the bloom filter's build and its queries). Read only where
the traced steps ran device operations, as `sparsify_host_ms`."""

SPANS = ("exchange/encode/index", "exchange/decode/index")


def read(ctx):
    d = ctx["digest"]
    ivs = [iv for name in SPANS for iv in d["spans"].get(name, [])]
    return sum(b - a for a, b in ivs) / 1e6 / d["steps"] if ivs and d["busy_ns"] > 0 else None
