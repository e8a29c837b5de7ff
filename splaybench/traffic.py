"""The one generator of the benchmark's inputs, driven by the data files.

A configuration file fixes the deployment's keys: how many, drawn from
what key space, which share is populated, how reads and writes choose
among them, and the rebalancing coin.  A traffic file fixes the op mix
and the batch.  From these and the run's seed, :class:`Traffic` makes
every input on the device with a ``torch.Generator`` of its own:

* the key set and the populate order, once, at set-up, from the run's
  seed, or from the configuration's ``layout_seed`` where it gives one
  (a deployment whose keys, hot ranks and load order are fixed, so
  that the seed varies only the requests);
* batch ``i``, from a generator seeded by ``(seed, i)`` alone, so any
  batch can be drawn again after the window for the reference, and
  every seed gets the same sizes: exactly ``round(share * B)`` ops of
  each kind and ``round(p * B)`` coins a batch, at drawn positions.

Read-key laws (``read_keys.dist``): ``zipf`` (bounded Zipf(s) over the
key set, ranks permuted over the keys, drawn by an inverse CDF on the
card), ``hotset`` (a share ``x`` of reads on the first ``y`` of the
keys, the rest uniform over the others) and ``uniform``.  Writes
(inserts and deletes) are uniform over a drawn ``write_keys.share`` of
the keys.
"""

from __future__ import annotations

import torch

OP_CONTAINS, OP_INSERT, OP_DELETE = 0, 1, 2
# the op kinds the reference answers (the ordered ones it does not yet)
KINDS = {"contains": OP_CONTAINS, "insert": OP_INSERT, "delete": OP_DELETE}
_MASK = (1 << 63) - 1


def mix_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``stream`` of run ``seed`` (any whole
    numbers): a splitmix64 step of the pair."""
    z = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK


def op_counts(mix: dict, batch: int) -> dict:
    """Ops of each kind a batch holds: ``round(share * batch)`` of each
    kind but contains, contains the rest."""
    unknown = set(mix) - set(KINDS)
    if unknown:
        raise ValueError(f"unknown op kinds in the mix: {sorted(unknown)}")
    out = {k: int(round(float(v) * batch)) for k, v in mix.items()
           if k != "contains"}
    out["contains"] = batch - sum(out.values())
    if out["contains"] < 0:
        raise ValueError(f"mix {mix} holds more than a batch")
    return out


class Traffic:
    """Inputs of one run: ``cfg`` (a configuration), ``mix`` (a traffic
    file), ``seed``, on ``device``."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.batch_size = int(mix["batch"])
        self.counts = op_counts(mix["mix"], self.batch_size)
        self.n_coins = int(round(float(cfg["coin_p"]) * self.batch_size))
        g = self._gen(-1, cfg.get("layout_seed"))
        dev = self.device
        n, space = int(cfg["keys"]), int(cfg["key_space"])
        if n > space:
            raise ValueError(f"{n} keys from a key space of {space}")
        self.keys = torch.randperm(space, generator=g, device=dev)[:n].to(
            torch.int32)
        n_pop = int(round(float(cfg["populate_share"]) * n))
        pop = self.keys[torch.randperm(n, generator=g, device=dev)[:n_pop]]
        self.populated = torch.sort(pop)[0]
        # the populate's insert order, drawn apart from the set itself
        self.populate_order = pop[torch.randperm(n_pop, generator=g,
                                                 device=dev)]
        rk = cfg["read_keys"]
        self.read_dist = rk["dist"]
        if self.read_dist == "zipf":
            ranks = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
            p = ranks ** (-float(rk["s"]))
            self.cdf = torch.cumsum(p / p.sum(), 0)
            # rank r's key: the key set is itself a random draw, so its
            # order is already a permutation of the ranks
        elif self.read_dist == "hotset":
            self.n_hot = max(int(round(float(rk["y"]) * n)), 1)
            self.x = float(rk["x"])
        elif self.read_dist != "uniform":
            raise ValueError(f"unknown read_keys law {self.read_dist!r}")
        n_w = max(int(round(float(cfg["write_keys"]["share"]) * n)), 1)
        self.write_keys = self.keys[torch.randperm(n, generator=g,
                                                   device=dev)[:n_w]]
        base = []
        for name, c in sorted(self.counts.items(), key=lambda kv: KINDS[
                kv[0]]):
            base.append(torch.full((c,), KINDS[name], dtype=torch.int32,
                                   device=dev))
        self.base_kinds = torch.cat(base)
        self.read_only = (self.counts.get("insert", 0) == 0
                          and self.counts.get("delete", 0) == 0)

    def _gen(self, stream: int, seed=None) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(mix_seed(self.seed if seed is None else int(seed),
                               stream))
        return g

    def table_bytes(self) -> int:
        """Device bytes of the generator's own tables (key set, populate
        order, CDF, write set, kinds), which stay allocated through the
        window and are not the program's."""
        ts = [self.keys, self.populated, self.populate_order,
              self.write_keys, self.base_kinds]
        if self.read_dist == "zipf":
            ts.append(self.cdf)
        return sum(t.numel() * t.element_size() for t in ts)

    def _reads(self, g, n: int) -> torch.Tensor:
        dev, nk = self.device, self.keys.shape[0]
        if self.read_dist == "zipf":
            u = torch.rand((n,), generator=g, dtype=torch.float64,
                           device=dev)
            idx = torch.searchsorted(self.cdf, u, right=True)
            return self.keys[torch.clamp(idx, max=nk - 1)]
        if self.read_dist == "hotset":
            hot = torch.rand((n,), generator=g, device=dev) < self.x
            h = torch.randint(0, self.n_hot, (n,), generator=g, device=dev)
            c = torch.randint(self.n_hot, max(nk, self.n_hot + 1), (n,),
                              generator=g, device=dev)
            return self.keys[torch.where(hot, h, torch.clamp(c, max=nk - 1))]
        return self.keys[torch.randint(0, nk, (n,), generator=g,
                                       device=dev)]

    def batch(self, i: int):
        """Batch ``i``: ``(kinds int32, keys int32, upd bool)`` of
        ``batch_size`` ops on the device.  Pure in ``(seed, i)``."""
        g = self._gen(i)
        B, dev = self.batch_size, self.device
        kinds = self.base_kinds[torch.randperm(B, generator=g, device=dev)]
        keys = self._reads(g, B)
        if not self.read_only:
            w = self.write_keys[torch.randint(
                0, self.write_keys.shape[0], (B,), generator=g, device=dev)]
            keys = torch.where((kinds == OP_INSERT) | (kinds == OP_DELETE),
                               w, keys)
        upd = torch.zeros((B,), dtype=torch.bool, device=dev)
        upd[torch.randperm(B, generator=g, device=dev)[:self.n_coins]] = True
        return kinds, keys.to(torch.int32).contiguous(), upd
