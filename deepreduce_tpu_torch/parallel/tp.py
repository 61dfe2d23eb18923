"""Tensor parallelism, ported from `deepreduce_tpu/parallel/tp.py`.

The JAX package expresses Megatron-style column / row splits as regex rules
from flax parameter paths to `PartitionSpec`s, places the parameters with
`NamedSharding`s, and lets XLA's GSPMD partitioner insert the collectives.
The port keeps the rules and their matching (`bert_tp_rules`,
`tp_shardings`: a spec is a tuple of axis names or None, one per dimension,
() replicated) and cuts this rank's contiguous shards (`shard_params`, as
`jax.device_put` places them). The function GSPMD computes from those
shards is `models.BertEncoder(model_axis=group)`, written out there with
`functional`'s collectives; `from_params` builds it from a dense model's
parameters.

The rules' embedding and head patterns (`.*/tok/embedding$`,
`.*/mlm/kernel$`, `.*/mlm/bias$`) need a component before `tok` or `mlm`:
on the params tree itself (`tok/embedding`, the form the JAX package's test
passes) they do not match and the embedding and head replicate; under the
whole variables dict (`params/tok/embedding`) they shard the vocabulary.
`tp_shardings(..., scope="params")` gives the latter, and
`BertEncoder(shard_vocab=True)` computes it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deepreduce_tpu_torch.collectives import collectives_for

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]


def bert_tp_rules(axis: str = "model") -> List[Tuple[str, Spec]]:
    """Sharding rules for `models.BertEncoder` params (the dense layout:
    MultiHeadDotProductAttention + Dense MLP)."""
    return [
        # fused-head attention projections: [hidden, heads, head_dim] — shard heads
        (r".*/(query|key|value)/kernel$", (None, axis, None)),
        (r".*/(query|key|value)/bias$", (axis, None)),
        # output projection: [heads, head_dim, hidden] — row parallel
        (r".*/out/kernel$", (axis, None, None)),
        (r".*/out/bias$", ()),
        # MLP: column then row parallel
        (r".*TransformerLayer_\d+/Dense_0/kernel$", (None, axis)),
        (r".*TransformerLayer_\d+/Dense_0/bias$", (axis,)),
        (r".*TransformerLayer_\d+/Dense_1/kernel$", (axis, None)),
        (r".*TransformerLayer_\d+/Dense_1/bias$", ()),
        # embeddings / MLM head: shard the vocab axis
        (r".*/tok/embedding$", (axis, None)),
        (r".*/mlm/kernel$", (None, axis)),
        (r".*/mlm/bias$", (axis,)),
    ]


def tp_shardings(params: Dict[str, object], mesh: Dict[str, object], rules: Rules, *,
                 scope: Optional[str] = None) -> Dict[str, Spec]:
    """{name: spec} for `params` (flax name -> tensor or shape): the first
    rule whose regex matches the "/"-joined name wins (prefixed by
    `scope + "/"` where a scope is given, as JAX names the paths of the
    whole variables dict); unmatched params, and a spec longer than the
    leaf, replicate. `mesh` maps axis names to their groups or sizes."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    out = {}
    for name, leaf in params.items():
        path = name if scope is None else f"{scope}/{name}"
        ndim = len(getattr(leaf, "shape", leaf))
        out[name] = ()
        for pat, spec in compiled:
            if pat.search(path):
                if len(spec) <= ndim:  # else a malformed match (e.g. scalar): replicate
                    missing = [a for a in spec if a is not None and a not in mesh]
                    if missing:
                        raise ValueError(f"{name}: spec {spec} names axes {missing} not in the mesh {list(mesh)}")
                    out[name] = tuple(spec)
                break
    return out


def shard(t: torch.Tensor, spec: Spec, mesh: Dict[str, object]) -> torch.Tensor:
    """This rank's contiguous shard of `t` under `spec`; an axis size that
    does not divide its dimension raises, as `jax.device_put` does."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        coll = collectives_for(mesh[axis])
        n = coll.world_size
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {t.shape[dim]} is not divisible by the {n} workers of "
                             f"axis {axis!r}")
        t = t.narrow(dim, coll.rank * (t.shape[dim] // n), t.shape[dim] // n)
    return t.contiguous()


def shard_params(params: Dict[str, torch.Tensor], mesh: Dict[str, object], rules: Rules, *,
                 scope: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """This rank's shard of every parameter per the rules (`mesh` maps axis
    names to this rank's groups), as `jax.device_put` places them."""
    specs = tp_shardings(params, mesh, rules, scope=scope)
    return {n: shard(t, specs[n], mesh) for n, t in params.items()}


def from_params(params: Dict[str, torch.Tensor], group, *, shard_vocab: bool = False):
    """This rank's tensor-parallel `models.BertEncoder` (dense attention over
    the model group `group`) from the full parameters of a dense one (flax
    names): the shards `shard_params` cuts under `bert_tp_rules()`, under
    the scope "params" with `shard_vocab`. The model is built on the meta
    device, so nothing is drawn, then filled on the parameters' device."""
    from deepreduce_tpu_torch.models.bert import BertEncoder

    vocab, hidden = params["tok/embedding"].shape
    with torch.device("meta"):
        model = BertEncoder(
            vocab, hidden, sum(n.endswith("/Dense_0/kernel") for n in params),
            params["TransformerLayer_0/MultiHeadDotProductAttention_0/query/kernel"].shape[1],
            params["TransformerLayer_0/Dense_0/kernel"].shape[1], params["pos/embedding"].shape[0],
            model_axis=group, shard_vocab=shard_vocab)
    model.to_empty(device=params["tok/embedding"].device)
    model.load_flax_params(shard_params(params, {"model": model.model}, bert_tp_rules(),
                                        scope="params" if shard_vocab else None))
    return model
