"""Frozen counts: FLOPs a sample of each configuration (`<config>.py`,
`flops_per_sample(config)`) and the bytes of a QSGD segment table
(`qsgd_table_bytes.py`). They import nothing of the port."""
