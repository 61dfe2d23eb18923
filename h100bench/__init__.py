"""The H100 benchmark of `deepreduce_tpu_torch`: synchronous data-parallel
training steps of the port's `Trainer`, compressed and dense, on one card.

`python -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` (at the checkout's root) and prints
one JSON result line. Everything that belongs to one configuration, traffic
mix, codec reference or per-layer metric sits in a file of its own, found by
the name that `BENCHMARK.json` or the traffic file gives:

- `configs/<config>.json`: the model's sizes, the port's class that runs it
  and its loss; `configs/<config>.py`: its plain PyTorch reference (weights
  from the seed, the forward and loss), which imports nothing of the port;
- `traffic/<traffic>.json`: batch, ring of inputs, optimizer and the
  DeepReduce knobs of the step, read by the one generator in `traffic.py`;
- `codecs/<name>.py`: the plain reference of a knob set's exchange;
- `metrics/<metric>.py`: the reader of one per-layer metric;
- `counts/`: the FLOPs of each configuration and the QSGD table's bytes;
- `limits/<workload>.json`: the limits of the numbers that decide `correct`.

Nothing here imports JAX or the JAX package.
"""
