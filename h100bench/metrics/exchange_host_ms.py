"""exchange_host_ms: host milliseconds a step inside the port's
`train/exchange` span."""


def read(ctx):
    d = ctx["digest"]
    ivs = d["spans"].get("train/exchange", [])
    return sum(b - a for a, b in ivs) / 1e6 / d["steps"] if ivs else None
