"""Plain PyTorch references of the port's exchanges, one module per knob set.

Each module defines `Exchange(shapes, knobs, workers)` whose `step(comp,
step)` takes every worker's compensated gradients (a list of name -> tensor)
and returns (the mean the optimizer gets, each worker's own decode). The
arithmetic they share is in `plain.py`: frozen copies of the bloom
geometry and hashes, the rank order of the positives, the QSGD quantizer and
the Philox draws, written from their specifications and importing nothing of
the port.
"""
