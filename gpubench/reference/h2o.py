"""The ten h2o db-benchmark groupby questions (`gpubench/queries/h2o.json`)
in plain torch over the generated table.

Groups are unique packed keys; integer sums are exact int64; float sums
and means go through float64; the standard deviation and the correlation
take two passes over the rows (the mean first), and the median is the
interpolated middle of each group's sorted values (percentile_cont at
0.5). q8 keeps, per id6, the two largest v3. The control computes the
same in float32 (`ops.Kernel`).
"""

from __future__ import annotations

import torch

from ..answer import Answer, RCol
from ..tables import Tables
from .ops import Data, Kernel, count, group

T = "x"


class Reference:
    def __init__(self, tables: Tables, device="cpu", control: bool = False):
        self.d = Data(tables, device)
        self.k = Kernel(control)
        self.device = torch.device(device)

    def answer(self, qid: str) -> Answer:
        return getattr(self, qid)()

    def keys(self, names):
        inv, G, first = group([self.d(T, n) for n in names])
        cols = []
        for n in names:
            v = self.d(T, n)[first]
            cols.append(RCol("string", v, self.d.dictionary(T, n))
                        if self.d.tables[T][n].dtype == "string"
                        else RCol("int", v))
        return inv, G, cols

    def _f(self, name):
        return self.d(T, name).to(self.k.fdt)

    def mean(self, name, inv, G, n):
        return self.k.fsum(self._f(name), inv, G) / n

    def q1(self):
        inv, G, keys = self.keys(["id1"])
        return Answer(["id1", "v1"],
                      keys + [RCol("int", self.k.isum(self.d(T, "v1"), inv, G))])

    def q2(self):
        inv, G, keys = self.keys(["id1", "id2"])
        return Answer(["id1", "id2", "v1"],
                      keys + [RCol("int", self.k.isum(self.d(T, "v1"), inv, G))])

    def q3(self):
        inv, G, keys = self.keys(["id3"])
        n = count(inv, G)
        return Answer(["id3", "v1", "v3"],
                      keys + [RCol("int", self.k.isum(self.d(T, "v1"), inv, G)),
                              RCol("float", self.mean("v3", inv, G, n))])

    def q4(self):
        inv, G, keys = self.keys(["id4"])
        n = count(inv, G)
        return Answer(["id4", "v1", "v2", "v3"],
                      keys + [RCol("float", self.mean(c, inv, G, n))
                              for c in ("v1", "v2", "v3")])

    def q5(self):
        inv, G, keys = self.keys(["id6"])
        k = self.k
        return Answer(["id6", "v1", "v2", "v3"],
                      keys + [RCol("int", k.isum(self.d(T, "v1"), inv, G)),
                              RCol("int", k.isum(self.d(T, "v2"), inv, G)),
                              RCol("float", k.fsum(self._f("v3"), inv, G))])

    def q6(self):
        inv, G, keys = self.keys(["id4", "id5"])
        n = count(inv, G)
        v = self._f("v3")
        # median: each group's values sorted, the middle interpolated
        order = torch.argsort(v, stable=True)
        order = order[torch.argsort(inv[order], stable=True)]
        sv = v[order].to(torch.float64)
        starts = torch.cumsum(n, 0) - n
        pos = starts.to(torch.float64) + (n - 1).to(torch.float64) / 2
        lo, hi = pos.floor().to(torch.int64), pos.ceil().to(torch.int64)
        median = sv[lo] + (sv[hi] - sv[lo]) * (pos - lo.to(torch.float64))
        # sample standard deviation, two passes
        mean = (self.k.fsum(v, inv, G) / n).to(self.k.fdt)
        dev = v - mean[inv]
        var = self.k.fsum(dev * dev, inv, G) / (n - 1)
        return Answer(["id4", "id5", "median_v3", "stddev_v3"],
                      keys + [RCol("float", median),
                              RCol("float", var.sqrt(), valid=n > 1)])

    def q7(self):
        inv, G, keys = self.keys(["id3"])
        dev = self.device
        big = torch.iinfo(torch.int64)
        mx = torch.full((G,), big.min, dtype=torch.int64, device=dev)
        mn = torch.full((G,), big.max, dtype=torch.int64, device=dev)
        mx.scatter_reduce_(0, inv, self.d(T, "v1"), "amax")
        mn.scatter_reduce_(0, inv, self.d(T, "v2"), "amin")
        return Answer(["id3", "range_v1_v2"], keys + [RCol("int", mx - mn)])

    def q8(self):
        id6 = self.d(T, "id6")
        v = self._f("v3")
        # rows by id6, then v3 descending: the first two of each id6 run
        order = torch.argsort(v, stable=True, descending=True)
        order = order[torch.argsort(id6[order], stable=True)]
        s = id6[order]
        first = torch.ones(len(s), dtype=torch.bool, device=self.device)
        first[1:] = s[1:] != s[:-1]
        second = torch.zeros_like(first)
        second[1:] = first[:-1] & ~first[1:]
        keep = order[first | second]
        return Answer(["id6", "v3"], [RCol("int", id6[keep]),
                                      RCol("float", v[keep].to(torch.float64))])

    def q9(self):
        inv, G, keys = self.keys(["id2", "id4"])
        n = count(inv, G)
        x, y = self._f("v1"), self._f("v2")
        mx = (self.k.fsum(x, inv, G) / n).to(self.k.fdt)
        my = (self.k.fsum(y, inv, G) / n).to(self.k.fdt)
        dx, dy = x - mx[inv], y - my[inv]
        sxy = self.k.fsum(dx * dy, inv, G)
        sxx, syy = self.k.fsum(dx * dx, inv, G), self.k.fsum(dy * dy, inv, G)
        corr = sxy / (sxx * syy).sqrt()
        return Answer(["id2", "id4", "corr"],
                      keys + [RCol("float", corr,
                                   valid=(n > 1) & (sxx > 0) & (syy > 0))])

    def q10(self):
        names = ["id1", "id2", "id3", "id4", "id5", "id6"]
        # six keys are too wide to pack into one int64: two halves
        lo_inv, _, _ = group([self.d(T, n) for n in names[3:]])
        hi_inv, _, _ = group([self.d(T, n) for n in names[:3]])
        inv, G, first = group([hi_inv, lo_inv])
        keys = []
        for n in names:
            v = self.d(T, n)[first]
            keys.append(RCol("string", v, self.d.dictionary(T, n))
                        if self.d.tables[T][n].dtype == "string"
                        else RCol("int", v))
        return Answer(names + ["v3", "cnt"],
                      keys + [RCol("float", self.k.fsum(self._f("v3"), inv, G)),
                              RCol("int", count(inv, G))])
