"""Gradient codecs of the port: bloom (index) and QSGD (value)."""
