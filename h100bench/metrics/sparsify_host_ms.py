"""sparsify_host_ms: host milliseconds a step inside the port's
`exchange/encode/sparsify` spans (the sparsifier of every leaf). Read only
where the traced steps ran device operations: a run without a card (the
CPU dry run) has no exchange on the card to split by stage."""


def read(ctx):
    d = ctx["digest"]
    ivs = d["spans"].get("exchange/encode/sparsify", [])
    return sum(b - a for a, b in ivs) / 1e6 / d["steps"] if ivs and d["busy_ns"] > 0 else None
