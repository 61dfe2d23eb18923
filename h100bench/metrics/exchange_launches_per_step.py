"""exchange_launches_per_step: kernels a step (copies and sets left out)
whose launch the host made inside the port's `train/exchange` span."""


def read(ctx):
    d = ctx["digest"]
    n = sum(1 for _, _, name, owner in d["device"]
            if owner == "train/exchange" and "Memcpy" not in name and "Memset" not in name)
    return n / d["steps"] if n else None
