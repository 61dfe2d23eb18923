"""Reference of the fused allgather exchange with exact top-k, residual
error feedback and the mod-blocked bloom index (`deepreduce='index'`), or
with QSGD over the index's value table (`deepreduce='both'`, DRQSGD).

Per leaf of d elements, k = max(1, int(d * ratio)):
- d <= min_compress_size: the top-k pairs travel raw (the whole tensor
  where 2k >= d);
- otherwise the filter of the top-k indices is built, every universe index
  is queried, and the first `budget` positives in ascending order carry the
  compensated values there (false positives included): in 'index' mode
  exactly, in 'both' mode through QSGD on the leaf's Philox stream.
The mean over workers multiplies the sum by fl(1/W).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from h100bench.codecs import plain


class Exchange:
    def __init__(self, shapes: Dict[str, Tuple[int, ...]], knobs: dict, workers: int):
        if knobs.get("compressor") != "topk" or knobs.get("index") != "bloom" or knobs.get("bloom_blocked") != "mod":
            raise NotImplementedError(f"topk_bloom references exact top-k with the mod-blocked bloom index, not {knobs}")
        self.mode = knobs["deepreduce"]
        if self.mode not in ("index", "both") or (self.mode == "both" and knobs.get("value") != "qsgd"):
            raise NotImplementedError(f"topk_bloom: deepreduce={self.mode!r} value={knobs.get('value')!r}")
        self.knobs = knobs
        self.workers = workers
        self.seed = int(knobs.get("seed", 0))
        self.q = int(knobs.get("quantum_num", 127))
        self.bucket = int(knobs.get("bucket_size", 512))
        ratio = float(knobs["compress_ratio"])
        small = int(knobs.get("min_compress_size") or 1000)
        self.leaves = {}
        for name, shape in shapes.items():
            d = math.prod(shape)
            k = plain.num_slots(d, ratio)
            if d > small:
                fpr = knobs.get("fpr") or 0.1 * k / d
                self.leaves[name] = ("bloom", k, plain.bloom_geometry(k, d, fpr, knobs.get("policy", "leftmost")))
            else:
                self.leaves[name] = ("dense" if 2 * k >= d else "topk", k, None)

    def qsgd_segments(self):
        """The value-table length of every leaf QSGD encodes ('both' mode):
        the segments of the step's one grouped encode."""
        if self.mode != "both":
            return []
        return [geom[2] for kind, _, geom in self.leaves.values() if kind == "bloom"]

    def decode_leaf(self, name: str, x: torch.Tensor, step: int, worker: int) -> torch.Tensor:
        kind, k, geom = self.leaves[name]
        flat = x.reshape(-1).float()
        if kind == "dense":
            return flat.reshape(x.shape)
        sel = plain.topk_mask(flat, k)
        if kind == "topk":
            return torch.where(sel, flat, 0.0).reshape(x.shape)
        n_words, h, budget = geom
        pos = plain.first_positions(plain.bloom_positives(sel, n_words, h), budget)
        vals = flat[pos]
        if self.mode == "both":
            u = plain.philox_uniforms(-(-budget // self.bucket) * self.bucket,
                                      *plain.stream(self.seed, name, step, worker), device=flat.device)
            table = torch.zeros(budget, dtype=torch.float32, device=flat.device)
            table[: pos.shape[0]] = vals
            vals = plain.qsgd_roundtrip(table, self.q, self.bucket, u)[: pos.shape[0]]
        return torch.zeros_like(flat).index_copy_(0, pos, vals).reshape(x.shape)

    def step(self, comp: List[Dict[str, torch.Tensor]], step: int):
        own = [{n: self.decode_leaf(n, t, step, w) for n, t in c.items()} for w, c in enumerate(comp)]
        inv = float(torch.tensor(1.0) / torch.tensor(float(self.workers)))
        mean = {n: sum(o[n] for o in own) * inv for n in own[0]}
        return mean, own
