"""qsgd_encode_roofline: the cell's QSGD segment table at the HBM rate
(each live value read once, each row byte written once: `counts/
qsgd_table_bytes.py`) over the mean device time of one launch of the
`qsgd_encode_rows` kernels, in %. The kernel is bound by bytes."""


def read(ctx):
    nbytes = ctx.get("qsgd_table_bytes")
    times = [b - a for a, b, name, _ in ctx["digest"]["device"] if "qsgd_encode_rows_kernel" in name]
    if not nbytes or not times:
        return None
    return 100.0 * (nbytes / ctx["hbm_bytes_per_s"]) / (sum(times) / len(times) / 1e9)
