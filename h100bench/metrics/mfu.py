"""mfu: the whole step's share of the card's peak, in %: samples a second of
the untraced stretch that precedes the profiler, times the configuration's
FLOPs a sample (forward and backward, `counts/`), over the dense peak of the
precision the step computes in (`peaks.json`)."""


def read(ctx):
    if not ctx.get("rate") or not ctx.get("flops_per_sample") or not ctx.get("peak_flops"):
        return None
    return 100.0 * ctx["rate"] * ctx["flops_per_sample"] / ctx["peak_flops"]
