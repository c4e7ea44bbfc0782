"""``"system": "uplif"``: one ``UpLIF``, the paper's index, as the
configuration deploys it (its ``index`` knobs). The harness calls it only
through the methods below, and opens its spans around each call into a
layer."""
from __future__ import annotations


def index_config(cfg: dict):
    """The port's ``UpLIFConfig`` for the configuration's index knobs."""
    from repro_torch.core.uplif import UpLIFConfig

    return UpLIFConfig(**cfg["index"])


class IndexSystem:
    """One ``UpLIF``: the paper's index."""

    def __init__(self, cfg, keys, vals, device, rec):
        from repro_torch.core.uplif import UpLIF

        self.rec = rec
        self.index = UpLIF(keys, vals, index_config(cfg), device=device)

    def wave(self, reads, ins, ins_vals):
        rec = self.rec
        found = vals = None
        if len(reads):
            with rec.span("index.lookup", sync=True):
                found, vals = self.index.lookup(reads)
        if len(ins):
            with rec.span("index.insert", sync=True):
                self.index.insert(ins, ins_vals)
        return found, vals

    def contents(self):
        return self.index.extract_live()

    def close(self):
        self.index = None


def build(cfg: dict, keys, vals, device, rec):
    return IndexSystem(cfg, keys, vals, device, rec)
