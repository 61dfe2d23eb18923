"""The chaos injector: deterministic perturbation of a packed payload at
the wire boundary, ported from `deepreduce_tpu/resilience/chaos.py`.

After a worker packs its buffer (checksum words included) and before the
gather, `ChaosInjector.perturb` may corrupt it (each byte selected with
p = 0.05 XORed with noise in [1, 255]), truncate it (the bytes from B // 2
on set to zero) and drop it (every byte zero), in that order, each an
independent Bernoulli event per (step, worker, salt) with its own rate.
The events and the byte draws come from the counter-based stream keyed by
(seed, tag 0x0C405, salt, step, worker) (`resilience.stream`): the events
are drawn on the host, so a step whose events do not fire launches
nothing, and the byte draws on the buffer's device. `perturb_rows` perturbs
a block of workers' buffers at once (the federated round's batched
cohort), with the same draws made on the device for every row. With the checksum on,
the receiver detects the damage and the payload decodes to an exact zero.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from deepreduce_tpu_torch.resilience import stream

# domain separation of the chaos stream (the dropout stream's is 0x0FA17)
CHAOS_TAG = 0x0C405
# the sub-streams of one (step, worker, salt) key
_DROP, _CORRUPT, _TRUNCATE, _SELECT, _NOISE = range(5)


@dataclasses.dataclass(frozen=True)
class ChaosInjector:
    """Drop / byte-corrupt / truncate, each with its own rate."""

    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    truncate_rate: float = 0.0
    seed: int = 0
    # the share of bytes XORed when a corrupt event fires
    corrupt_frac: float = 0.05

    @classmethod
    def from_config(cls, cfg) -> Optional["ChaosInjector"]:
        """None unless resilience is on and a chaos rate is above 0."""
        if not cfg.resilience:
            return None
        if all(r <= 0.0 for r in (cfg.chaos_drop_rate, cfg.chaos_corrupt_rate, cfg.chaos_truncate_rate)):
            return None
        return cls(drop_rate=float(cfg.chaos_drop_rate), corrupt_rate=float(cfg.chaos_corrupt_rate),
                   truncate_rate=float(cfg.chaos_truncate_rate), seed=int(cfg.seed))

    def _key(self, step: int, worker: int, salt: int, sub: int) -> int:
        return stream.key(self.seed, CHAOS_TAG, salt, step, worker, sub)

    def events(self, *, step: int, worker: int, salt: int = 0) -> Dict[str, bool]:
        """Which faults fire on (step, worker, salt), drawn on the host; a
        rate of 0 never fires."""
        out = {}
        for name, rate, sub in (("corrupt", self.corrupt_rate, _CORRUPT), ("truncate", self.truncate_rate, _TRUNCATE),
                                ("drop", self.drop_rate, _DROP)):
            out[name] = rate > 0.0 and stream.bernoulli(self._key(step, worker, salt, sub), rate)
        return out

    def byte_draws(self, n: int, device, *, step: int, worker: int, salt: int = 0) -> Dict[str, torch.Tensor]:
        """The corrupt event's byte selection (bool[n]) and XOR noise
        (uint8[n] in [1, 255]) on `device`."""
        sel = stream.words(self._key(step, worker, salt, _SELECT), n, device) < stream.threshold(self.corrupt_frac)
        noise = 1 + stream.words(self._key(step, worker, salt, _NOISE), n, device) % 255
        return {"sel": sel, "noise": noise.to(torch.uint8)}

    def perturb_rows(self, rows: torch.Tensor, *, step: int, workers: torch.Tensor, salt: int = 0) -> torch.Tensor:
        """uint8[B, n] buffers of workers `workers` (int64[B] on their
        device) perturbed at once: row b is `perturb(rows[b], step=step,
        worker=workers[b], salt=salt)`, bit for bit, with the events and
        the byte draws made on the device (no host sync, no per-row launch)."""
        n = rows.shape[1]
        if n == 0:
            return rows
        pre = stream.key(self.seed, CHAOS_TAG, salt, step)
        # the key chain's last two words on the device: the worker, the sub-stream
        kw = stream.fmix32_chain(pre, workers)

        def sub_key(sub):
            return stream.fmix32_chain(kw, sub)

        def fires(sub, rate):
            if rate <= 0.0:
                return torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
            return stream.words_at_keys(sub_key(sub), torch.zeros_like(workers)) < stream.threshold(rate)

        pos = torch.arange(n, device=rows.device)
        out = rows
        if self.corrupt_rate > 0.0:
            sel = stream.words_at_keys(sub_key(_SELECT)[:, None], pos[None, :]) < stream.threshold(self.corrupt_frac)
            noise = (1 + stream.words_at_keys(sub_key(_NOISE)[:, None], pos[None, :]) % 255).to(torch.uint8)
            out = torch.where(fires(_CORRUPT, self.corrupt_rate)[:, None] & sel, out ^ noise, out)
        zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
        if self.truncate_rate > 0.0:
            out = torch.where(fires(_TRUNCATE, self.truncate_rate)[:, None] & (pos >= n // 2)[None, :], zero, out)
        if self.drop_rate > 0.0:
            out = torch.where(fires(_DROP, self.drop_rate)[:, None], zero, out)
        return out

    def perturb(self, buf: torch.Tensor, *, step: int, worker: int, salt: int = 0,
                draws: Optional[Dict[str, object]] = None) -> torch.Tensor:
        """The perturbed copy of uint8[B] `buf` (`buf` itself when nothing
        fires). `draws` replaces the stream: the events 'corrupt',
        'truncate' and 'drop' (bools) and the corrupt event's 'sel' and
        'noise' tensors (the parity tests inject `jax.random`'s)."""
        B = buf.shape[0]
        if B == 0:
            return buf
        ev = self.events(step=step, worker=worker, salt=salt) if draws is None else {
            k: bool(draws[k]) for k in ("corrupt", "truncate", "drop")}
        out = buf
        if ev["corrupt"]:
            d = self.byte_draws(B, buf.device, step=step, worker=worker, salt=salt) if draws is None else draws
            out = torch.where(d["sel"], out ^ d["noise"], out)
        if ev["truncate"]:
            out = out.clone() if out is buf else out
            out[B // 2 :].zero_()
        if ev["drop"]:
            # last: a dropped payload is all zero whatever came before, and
            # its salted checksum word never matches
            out = torch.zeros_like(buf)
        return out
