"""The 22 TPC-H queries, with the validation substitution parameters of
`gpubench/queries/tpch.json`, in plain torch over the generated tables.

Written from the TPC-H specification's query definitions, not from the
program: joins are lookups of unique keys by sort and binary search,
groups are unique packed keys, EXISTS and IN are membership tests, and
decimals stay scaled int64 (a product's scale is the sum of its
factors'). Averages and quotients of decimals are exact fractions; the
comparison rounds them at the scale the program states. The one average
that a predicate reads (Q22's) is rounded as its decimal type holds it:
half away from zero at the argument's scale + 4.

Each query returns an `Answer`: its columns, its ORDER BY and LIMIT.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..answer import Answer, RCol
from ..tables import Tables
from .ops import Data, Kernel, count, days, group, like, lookup


def _year_lut(device) -> torch.Tensor:
    d = np.arange(0, 40000).astype("datetime64[D]")
    return torch.as_tensor(d.astype("datetime64[Y]").astype(np.int64) + 1970,
                           device=device)


class Reference:
    def __init__(self, tables: Tables, device="cpu", control: bool = False):
        self.d = Data(tables, device)
        self.k = Kernel(control)
        self.device = torch.device(device)
        self._years = None

    def answer(self, qid: str) -> Answer:
        return getattr(self, qid)()

    # -- helpers --
    def year(self, days_t: torch.Tensor) -> torch.Tensor:
        if self._years is None:
            self._years = _year_lut(self.device)
        return self._years[days_t]

    def s(self, table, name, rows) -> RCol:
        """A string column of the answer: the table's strings at rows."""
        codes, dictionary = self.d.strings(table, name, rows)
        return RCol("string", codes, dictionary)

    def nation_of(self, nationkeys: torch.Tensor) -> torch.Tensor:
        idx, _ = lookup(self.d("nation", "n_nationkey"), nationkeys)
        return idx

    def nations_in(self, region: str) -> torch.Tensor:
        d = self.d
        rk = d("region", "r_regionkey")[
            d("region", "r_name") == d.code("region", "r_name", region)]
        return d("nation", "n_nationkey")[
            torch.isin(d("nation", "n_regionkey"), rk)]

    def nation_key(self, name: str) -> int:
        d = self.d
        return int(d("nation", "n_nationkey")[
            d("nation", "n_name") == d.code("nation", "n_name", name)][0])

    def volume(self, rows=None) -> torch.Tensor:
        """l_extendedprice * (1 - l_discount), scale 4."""
        d = self.d
        e, disc = d("lineitem", "l_extendedprice"), d("lineitem", "l_discount")
        if rows is not None:
            e, disc = e[rows], disc[rows]
        return e * (100 - disc)

    def order_rows(self, okeys):
        return lookup(self.d("orders", "o_orderkey"), okeys)

    # -- the queries --
    def q1(self):
        d, k = self.d, self.k
        m = d("lineitem", "l_shipdate") <= days(1998, 9, 2)
        rows = torch.nonzero(m).flatten()
        flag, status = (d("lineitem", "l_returnflag")[rows],
                        d("lineitem", "l_linestatus")[rows])
        inv, G, first = group([flag, status])
        qty, price = (d("lineitem", "l_quantity")[rows],
                      d("lineitem", "l_extendedprice")[rows])
        disc, tax = (d("lineitem", "l_discount")[rows],
                     d("lineitem", "l_tax")[rows])
        n = count(inv, G)
        s_qty, s_price = k.dsum(qty, inv, G), k.dsum(price, inv, G)
        s_disc = k.dsum(price * (100 - disc), inv, G)
        s_charge = k.dsum(price * (100 - disc) * (100 + tax), inv, G)
        s_d = k.dsum(disc, inv, G)
        cnt = n.tolist()

        def avg(s):
            return [Fraction(int(a), 100 * c) for a, c in zip(s.tolist(), cnt)]
        g = rows[first]
        return Answer(
            ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
             "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
             "avg_disc", "count_order"],
            [self.s("lineitem", "l_returnflag", g),
             self.s("lineitem", "l_linestatus", g),
             RCol("decimal", s_qty, scale=2), RCol("decimal", s_price, scale=2),
             RCol("decimal", s_disc, scale=4),
             RCol("decimal", s_charge, scale=6),
             RCol("ratio", avg(s_qty), scale=6),
             RCol("ratio", avg(s_price), scale=6),
             RCol("ratio", avg(s_d), scale=6), RCol("int", n)],
            [(0, False), (1, False)])

    def q2(self):
        d = self.d
        p_ok = (d("part", "p_size") == 15) & d.where(
            "part", "p_type", like("%BRASS"))
        eu = self.nations_in("EUROPE")
        s_eu = torch.isin(d("supplier", "s_nationkey"), eu)
        sidx, sfound = lookup(d("supplier", "s_suppkey"),
                              d("partsupp", "ps_suppkey"))
        pidx, pfound = lookup(d("part", "p_partkey"), d("partsupp", "ps_partkey"))
        ps_eu = sfound & s_eu[sidx] & pfound
        cost = d("partsupp", "ps_supplycost")
        big = torch.iinfo(torch.int64).max
        mincost = torch.full((d.rows("part"),), big, dtype=torch.int64,
                             device=self.device)
        mincost.scatter_reduce_(0, pidx[ps_eu], cost[ps_eu], "amin")
        sel = torch.nonzero(ps_eu & p_ok[pidx] & (cost == mincost[pidx])
                            ).flatten()
        s, p = sidx[sel], pidx[sel]
        nat = self.nation_of(d("supplier", "s_nationkey")[s])
        return Answer(
            ["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
             "s_address", "s_phone", "s_comment"],
            [RCol("decimal", d("supplier", "s_acctbal")[s], scale=2),
             self.s("supplier", "s_name", s), self.s("nation", "n_name", nat),
             RCol("int", d("part", "p_partkey")[p]),
             self.s("part", "p_mfgr", p), self.s("supplier", "s_address", s),
             self.s("supplier", "s_phone", s),
             self.s("supplier", "s_comment", s)],
            [(0, True), (2, False), (1, False), (3, False)], 100)

    def q3(self):
        d, k = self.d, self.k
        cust = d("customer", "c_mktsegment") == d.code(
            "customer", "c_mktsegment", "BUILDING")
        cidx, cf = lookup(d("customer", "c_custkey"), d("orders", "o_custkey"))
        o_ok = (d("orders", "o_orderdate") < days(1995, 3, 15)) & cf & cust[cidx]
        oidx, of = self.order_rows(d("lineitem", "l_orderkey"))
        rows = torch.nonzero((d("lineitem", "l_shipdate") > days(1995, 3, 15))
                             & of & o_ok[oidx]).flatten()
        inv, G, first = group([d("lineitem", "l_orderkey")[rows]])
        rev = k.dsum(self.volume(rows), inv, G)
        o = oidx[rows[first]]
        return Answer(
            ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"],
            [RCol("int", d("orders", "o_orderkey")[o]),
             RCol("decimal", rev, scale=4),
             RCol("int", d("orders", "o_orderdate")[o]),
             RCol("int", d("orders", "o_shippriority")[o])],
            [(1, True), (2, False)], 10)

    def q4(self):
        d = self.d
        late = d("lineitem", "l_commitdate") < d("lineitem", "l_receiptdate")
        od = d("orders", "o_orderdate")
        m = ((od >= days(1993, 7, 1)) & (od < days(1993, 10, 1))
             & torch.isin(d("orders", "o_orderkey"), d("lineitem", "l_orderkey")[late]))
        rows = torch.nonzero(m).flatten()
        inv, G, first = group([d("orders", "o_orderpriority")[rows]])
        return Answer(["o_orderpriority", "order_count"],
                      [self.s("orders", "o_orderpriority", rows[first]),
                       RCol("int", count(inv, G))], [(0, False)])

    def _line_customer_nation(self, rows):
        """c_nationkey of each lineitem row's order's customer."""
        d = self.d
        oidx, _ = self.order_rows(d("lineitem", "l_orderkey")[rows])
        cidx, _ = lookup(d("customer", "c_custkey"), d("orders", "o_custkey")[oidx])
        return d("customer", "c_nationkey")[cidx], oidx

    def _line_supplier(self, rows):
        sidx, _ = lookup(self.d("supplier", "s_suppkey"),
                         self.d("lineitem", "l_suppkey")[rows])
        return sidx

    def q5(self):
        d, k = self.d, self.k
        asia = self.nations_in("ASIA")
        oidx, _ = self.order_rows(d("lineitem", "l_orderkey"))
        od = d("orders", "o_orderdate")[oidx]
        rows = torch.nonzero((od >= days(1994, 1, 1)) & (od < days(1995, 1, 1))
                             ).flatten()
        cn, _ = self._line_customer_nation(rows)
        sn = d("supplier", "s_nationkey")[self._line_supplier(rows)]
        keep = (cn == sn) & torch.isin(sn, asia)
        rows, sn = rows[keep], sn[keep]
        nat = self.nation_of(sn)
        inv, G, first = group([d("nation", "n_name")[nat]])
        return Answer(["n_name", "revenue"],
                      [self.s("nation", "n_name", nat[first]),
                       RCol("decimal", k.dsum(self.volume(rows), inv, G),
                            scale=4)], [(1, True)])

    def q6(self):
        d, k = self.d, self.k
        sd, disc = d("lineitem", "l_shipdate"), d("lineitem", "l_discount")
        m = ((sd >= days(1994, 1, 1)) & (sd < days(1995, 1, 1)) & (disc >= 5)
             & (disc <= 7) & (d("lineitem", "l_quantity") < 2400))
        v = d("lineitem", "l_extendedprice")[m] * disc[m]
        return Answer(["revenue"], [RCol("decimal", torch.tensor(
            [k.total(v)], device=self.device), scale=4)])

    def q7(self):
        d, k = self.d, self.k
        fr, de = self.nation_key("FRANCE"), self.nation_key("GERMANY")
        sd = d("lineitem", "l_shipdate")
        rows = torch.nonzero((sd >= days(1995, 1, 1)) & (sd <= days(1996, 12, 31))
                             ).flatten()
        sn = d("supplier", "s_nationkey")[self._line_supplier(rows)]
        cn, _ = self._line_customer_nation(rows)
        keep = ((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))
        rows, sn, cn = rows[keep], sn[keep], cn[keep]
        s_nat, c_nat = self.nation_of(sn), self.nation_of(cn)
        yr = self.year(sd[rows])
        names = d("nation", "n_name")
        inv, G, first = group([names[s_nat], names[c_nat], yr])
        return Answer(
            ["supp_nation", "cust_nation", "l_year", "revenue"],
            [self.s("nation", "n_name", s_nat[first]),
             self.s("nation", "n_name", c_nat[first]), RCol("int", yr[first]),
             RCol("decimal", k.dsum(self.volume(rows), inv, G), scale=4)],
            [(0, False), (1, False), (2, False)])

    def q8(self):
        d, k = self.d, self.k
        america = self.nations_in("AMERICA")
        brazil = self.nation_key("BRAZIL")
        p_ok = d("part", "p_type") == d.code("part", "p_type",
                                             "ECONOMY ANODIZED STEEL")
        pidx, _ = lookup(d("part", "p_partkey"), d("lineitem", "l_partkey"))
        oidx, _ = self.order_rows(d("lineitem", "l_orderkey"))
        od = d("orders", "o_orderdate")[oidx]
        rows = torch.nonzero(p_ok[pidx] & (od >= days(1995, 1, 1))
                             & (od <= days(1996, 12, 31))).flatten()
        cn, oi = self._line_customer_nation(rows)
        keep = torch.isin(cn, america)
        rows, oi = rows[keep], oi[keep]
        sn = d("supplier", "s_nationkey")[self._line_supplier(rows)]
        yr = self.year(d("orders", "o_orderdate")[oi])
        inv, G, first = group([yr])
        vol = self.volume(rows)
        tot = k.dsum(vol, inv, G)
        br = k.dsum(torch.where(sn == brazil, vol, torch.zeros_like(vol)),
                    inv, G)
        share = [Fraction(int(b), int(t)) for b, t in zip(br.tolist(),
                                                          tot.tolist())]
        return Answer(["o_year", "mkt_share"],
                      [RCol("int", yr[first]), RCol("ratio", share, scale=8)],
                      [(0, False)])

    def q9(self):
        d, k = self.d, self.k
        green = d.where("part", "p_name", like("%green%"))
        pidx, _ = lookup(d("part", "p_partkey"), d("lineitem", "l_partkey"))
        rows = torch.nonzero(green[pidx]).flatten()
        pk, sk = d("lineitem", "l_partkey")[rows], d("lineitem", "l_suppkey")[rows]
        span = int(d("partsupp", "ps_suppkey").max()) + 1
        psi, _ = lookup(d("partsupp", "ps_partkey") * span
                        + d("partsupp", "ps_suppkey"), pk * span + sk)
        amount = (self.volume(rows) - d("partsupp", "ps_supplycost")[psi]
                  * d("lineitem", "l_quantity")[rows])
        nat = self.nation_of(d("supplier", "s_nationkey")[
            self._line_supplier(rows)])
        oidx, _ = self.order_rows(d("lineitem", "l_orderkey")[rows])
        yr = self.year(d("orders", "o_orderdate")[oidx])
        inv, G, first = group([d("nation", "n_name")[nat], yr])
        return Answer(["nation", "o_year", "sum_profit"],
                      [self.s("nation", "n_name", nat[first]),
                       RCol("int", yr[first]),
                       RCol("decimal", k.dsum(amount, inv, G), scale=4)],
                      [(0, False), (1, True)])

    def q10(self):
        d, k = self.d, self.k
        od = d("orders", "o_orderdate")
        o_ok = (od >= days(1993, 10, 1)) & (od < days(1994, 1, 1))
        oidx, of = self.order_rows(d("lineitem", "l_orderkey"))
        r_flag = d("lineitem", "l_returnflag") == d.code(
            "lineitem", "l_returnflag", "R")
        rows = torch.nonzero(r_flag & of & o_ok[oidx]).flatten()
        cidx, _ = lookup(d("customer", "c_custkey"),
                         d("orders", "o_custkey")[oidx[rows]])
        inv, G, first = group([d("customer", "c_custkey")[cidx]])
        c = cidx[first]
        nat = self.nation_of(d("customer", "c_nationkey")[c])
        return Answer(
            ["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
             "c_address", "c_phone", "c_comment"],
            [RCol("int", d("customer", "c_custkey")[c]),
             self.s("customer", "c_name", c),
             RCol("decimal", k.dsum(self.volume(rows), inv, G), scale=4),
             RCol("decimal", d("customer", "c_acctbal")[c], scale=2),
             self.s("nation", "n_name", nat),
             self.s("customer", "c_address", c),
             self.s("customer", "c_phone", c),
             self.s("customer", "c_comment", c)],
            [(2, True)], 20)

    def q11(self):
        d, k = self.d, self.k
        de = self.nation_key("GERMANY")
        sidx, _ = lookup(d("supplier", "s_suppkey"), d("partsupp", "ps_suppkey"))
        rows = torch.nonzero(d("supplier", "s_nationkey")[sidx] == de).flatten()
        value = (d("partsupp", "ps_supplycost")[rows]
                 * d("partsupp", "ps_availqty")[rows])
        total = k.total(value)
        inv, G, first = group([d("partsupp", "ps_partkey")[rows]])
        sums = k.dsum(value, inv, G)
        # sum > total * 0.0001000000, both at scale 2
        keep = sums * 10000 > total
        return Answer(["ps_partkey", "value"],
                      [RCol("int", d("partsupp", "ps_partkey")[rows[first]][keep]),
                       RCol("decimal", sums[keep], scale=2)], [(1, True)])

    def q12(self):
        d = self.d
        mode = d("lineitem", "l_shipmode")
        modes = [d.code("lineitem", "l_shipmode", m) for m in ("MAIL", "SHIP")]
        cd, rd, sd = (d("lineitem", "l_commitdate"), d("lineitem", "l_receiptdate"),
                      d("lineitem", "l_shipdate"))
        m = (torch.isin(mode, torch.tensor(modes, device=self.device))
             & (cd < rd) & (sd < cd) & (rd >= days(1994, 1, 1))
             & (rd < days(1995, 1, 1)))
        rows = torch.nonzero(m).flatten()
        oidx, _ = self.order_rows(d("lineitem", "l_orderkey")[rows])
        prio = d("orders", "o_orderpriority")[oidx]
        urgent = [d.code("orders", "o_orderpriority", p)
                  for p in ("1-URGENT", "2-HIGH")]
        high = torch.isin(prio, torch.tensor(urgent, device=self.device))
        inv, G, first = group([mode[rows]])
        hi = torch.zeros(G, dtype=torch.int64, device=self.device).index_add_(
            0, inv, high.to(torch.int64))
        return Answer(["l_shipmode", "high_line_count", "low_line_count"],
                      [self.s("lineitem", "l_shipmode", rows[first]),
                       RCol("int", hi), RCol("int", count(inv, G) - hi)],
                      [(0, False)])

    def q13(self):
        d = self.d
        keep = ~d.where("orders", "o_comment", like("%special%requests%"))
        cidx, cf = lookup(d("customer", "c_custkey"), d("orders", "o_custkey"))
        per = torch.bincount(cidx[keep & cf], minlength=d.rows("customer"))
        inv, G, first = group([per])
        return Answer(["c_count", "custdist"],
                      [RCol("int", per[first]), RCol("int", count(inv, G))],
                      [(1, True), (0, True)])

    def q14(self):
        d, k = self.d, self.k
        sd = d("lineitem", "l_shipdate")
        rows = torch.nonzero((sd >= days(1995, 9, 1)) & (sd < days(1995, 10, 1))
                             ).flatten()
        pidx, _ = lookup(d("part", "p_partkey"), d("lineitem", "l_partkey")[rows])
        promo = d.where("part", "p_type", like("PROMO%"))[pidx]
        vol = self.volume(rows)
        tot = k.total(vol)
        pr = k.total(torch.where(promo, vol, torch.zeros_like(vol)))
        return Answer(["promo_revenue"],
                      [RCol("ratio", [Fraction(100 * pr, tot)], scale=8)])

    def q15(self):
        d, k = self.d, self.k
        sd = d("lineitem", "l_shipdate")
        rows = torch.nonzero((sd >= days(1996, 1, 1)) & (sd < days(1996, 4, 1))
                             ).flatten()
        inv, G, first = group([d("lineitem", "l_suppkey")[rows]])
        rev = k.dsum(self.volume(rows), inv, G)
        top = rev == rev.max()
        sidx, _ = lookup(d("supplier", "s_suppkey"),
                         d("lineitem", "l_suppkey")[rows[first]][top])
        return Answer(
            ["s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"],
            [RCol("int", d("supplier", "s_suppkey")[sidx]),
             self.s("supplier", "s_name", sidx),
             self.s("supplier", "s_address", sidx),
             self.s("supplier", "s_phone", sidx),
             RCol("decimal", rev[top], scale=4)], [(0, False)])

    def q16(self):
        d = self.d
        p_ok = ((d("part", "p_brand") != d.code("part", "p_brand", "Brand#45"))
                & ~d.where("part", "p_type", like("MEDIUM POLISHED%"))
                & torch.isin(d("part", "p_size"), torch.tensor(
                    [49, 14, 23, 45, 19, 3, 36, 9], device=self.device)))
        bad = d("supplier", "s_suppkey")[d.where(
            "supplier", "s_comment", like("%Customer%Complaints%"))]
        pidx, _ = lookup(d("part", "p_partkey"), d("partsupp", "ps_partkey"))
        sk = d("partsupp", "ps_suppkey")
        rows = torch.nonzero(p_ok[pidx] & ~torch.isin(sk, bad)).flatten()
        p = pidx[rows]
        keys = [d("part", "p_brand")[p], d("part", "p_type")[p],
                d("part", "p_size")[p]]
        inv, G, first = group(keys)
        # distinct suppliers per group
        pair_inv, _, pair_first = group([inv, sk[rows]])
        distinct = torch.bincount(inv[pair_first], minlength=G)
        g = p[first]
        return Answer(["p_brand", "p_type", "p_size", "supplier_cnt"],
                      [self.s("part", "p_brand", g), self.s("part", "p_type", g),
                       RCol("int", d("part", "p_size")[g]),
                       RCol("int", distinct)],
                      [(3, True), (0, False), (1, False), (2, False)])

    def q17(self):
        d, k = self.d, self.k
        p_ok = ((d("part", "p_brand") == d.code("part", "p_brand", "Brand#23"))
                & (d("part", "p_container") == d.code("part", "p_container",
                                                      "MED BOX")))
        lp = d("lineitem", "l_partkey")
        pidx, _ = lookup(d("part", "p_partkey"), lp)
        n_part = d.rows("part")
        qty = d("lineitem", "l_quantity")
        s = torch.zeros(n_part, dtype=torch.int64, device=self.device
                        ).index_add_(0, pidx, qty)
        c = torch.bincount(pidx, minlength=n_part)
        # l_quantity < 0.2 * avg(l_quantity) of its part: 5 * q * c < s
        m = p_ok[pidx] & (5 * qty * c[pidx] < s[pidx])
        total = k.total(d("lineitem", "l_extendedprice")[m])
        value = Fraction(total, 700) if bool(m.any()) else None
        return Answer(["avg_yearly"], [RCol(
            "ratio", [value if value is not None else Fraction(0)], scale=6,
            valid=torch.tensor([value is not None], device=self.device))])

    def q18(self):
        d, k = self.d, self.k
        lok = d("lineitem", "l_orderkey")
        inv, G, first = group([lok])
        qty = k.dsum(d("lineitem", "l_quantity"), inv, G)
        big = qty > 30000
        oidx, _ = self.order_rows(lok[first][big])
        cidx, _ = lookup(d("customer", "c_custkey"), d("orders", "o_custkey")[oidx])
        return Answer(
            ["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice",
             "sum(l_quantity)"],
            [self.s("customer", "c_name", cidx),
             RCol("int", d("customer", "c_custkey")[cidx]),
             RCol("int", d("orders", "o_orderkey")[oidx]),
             RCol("int", d("orders", "o_orderdate")[oidx]),
             RCol("decimal", d("orders", "o_totalprice")[oidx], scale=2),
             RCol("decimal", qty[big], scale=2)],
            [(4, True), (3, False)], 100)

    def q19(self):
        d, k = self.d, self.k
        pidx, _ = lookup(d("part", "p_partkey"), d("lineitem", "l_partkey"))
        brand, cont = d("part", "p_brand")[pidx], d("part", "p_container")[pidx]
        size = d("part", "p_size")[pidx]
        qty = d("lineitem", "l_quantity")
        common = (torch.isin(d("lineitem", "l_shipmode"), torch.tensor(
            [d.code("lineitem", "l_shipmode", m) for m in ("AIR", "AIR REG")],
            device=self.device))
            & (d("lineitem", "l_shipinstruct")
               == d.code("lineitem", "l_shipinstruct", "DELIVER IN PERSON")))

        def arm(b, conts, qlo, qhi, smax):
            cs = torch.tensor([d.code("part", "p_container", c) for c in conts],
                              device=self.device)
            return ((brand == d.code("part", "p_brand", b))
                    & torch.isin(cont, cs) & (qty >= qlo * 100)
                    & (qty <= qhi * 100) & (size >= 1) & (size <= smax))
        m = common & (arm("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
                          1, 11, 5)
                      | arm("Brand#23", ("MED BAG", "MED BOX", "MED PKG",
                                         "MED PACK"), 10, 20, 10)
                      | arm("Brand#34", ("LG CASE", "LG BOX", "LG PACK",
                                         "LG PKG"), 20, 30, 15))
        rows = torch.nonzero(m).flatten()
        return Answer(["revenue"], [RCol("decimal", torch.tensor(
            [k.total(self.volume(rows))], device=self.device), scale=4)])

    def q20(self):
        d = self.d
        forest = d("part", "p_partkey")[d.where("part", "p_name",
                                                like("forest%"))]
        ps_pk, ps_sk = d("partsupp", "ps_partkey"), d("partsupp", "ps_suppkey")
        span = int(ps_sk.max()) + 1
        sd = d("lineitem", "l_shipdate")
        lrows = torch.nonzero((sd >= days(1994, 1, 1)) & (sd < days(1995, 1, 1))
                              ).flatten()
        psi, found = lookup(ps_pk * span + ps_sk,
                            d("lineitem", "l_partkey")[lrows] * span
                            + d("lineitem", "l_suppkey")[lrows])
        n_ps = len(ps_pk)
        s = torch.zeros(n_ps, dtype=torch.int64, device=self.device).index_add_(
            0, psi[found], d("lineitem", "l_quantity")[lrows][found])
        c = torch.bincount(psi[found], minlength=n_ps)
        # ps_availqty > 0.5 * sum(l_quantity); an empty sum is NULL
        ok = (torch.isin(ps_pk, forest) & (c > 0)
              & (200 * d("partsupp", "ps_availqty") > s))
        ca = self.nation_key("CANADA")
        sm = (torch.isin(d("supplier", "s_suppkey"), ps_sk[ok])
              & (d("supplier", "s_nationkey") == ca))
        rows = torch.nonzero(sm).flatten()
        return Answer(["s_name", "s_address"],
                      [self.s("supplier", "s_name", rows),
                       self.s("supplier", "s_address", rows)], [(0, False)])

    def q21(self):
        d = self.d
        lok, lsk = d("lineitem", "l_orderkey"), d("lineitem", "l_suppkey")
        late = d("lineitem", "l_receiptdate") > d("lineitem", "l_commitdate")
        oidx, _ = self.order_rows(lok)
        # distinct suppliers of each order, over all its lines and its late ones
        o_inv, n_orders, _ = group([oidx])
        _, _, pair_first = group([o_inv, lsk])
        n_all = torch.bincount(o_inv[pair_first], minlength=n_orders)
        late_rows = torch.nonzero(late).flatten()
        _, _, lp_first = group([o_inv[late_rows], lsk[late_rows]])
        n_late = torch.bincount(o_inv[late_rows][lp_first], minlength=n_orders)
        sa = self.nation_key("SAUDI ARABIA")
        sidx, _ = lookup(d("supplier", "s_suppkey"), lsk)
        f = d("orders", "o_orderstatus")[oidx] == d.code(
            "orders", "o_orderstatus", "F")
        m = (late & f & (d("supplier", "s_nationkey")[sidx] == sa)
             & (n_all[o_inv] >= 2) & (n_late[o_inv] == 1))
        rows = torch.nonzero(m).flatten()
        inv, G, first = group([d("supplier", "s_name")[sidx[rows]]])
        return Answer(["s_name", "numwait"],
                      [self.s("supplier", "s_name", sidx[rows[first]]),
                       RCol("int", count(inv, G))], [(1, True), (0, False)], 100)

    def q22(self):
        d, k = self.d, self.k
        codes = ("13", "31", "23", "29", "30", "18", "17")
        phones = d.dictionary("customer", "c_phone")
        cc_of_entry = np.array([p[:2] for p in phones.tolist()], dtype=object)
        cc_dict = np.unique(cc_of_entry)
        entry_cc = torch.as_tensor(np.searchsorted(cc_dict, cc_of_entry),
                                   device=self.device)
        cc = entry_cc[d("customer", "c_phone")]
        in_set = torch.isin(cc, torch.as_tensor(
            np.searchsorted(cc_dict, [c for c in codes if c in cc_dict]),
            device=self.device))
        bal = d("customer", "c_acctbal")
        pos = in_set & (bal > 0)
        s, n = k.total(bal[pos]), int(pos.sum())
        # avg(c_acctbal) as its decimal(.., 6) holds it, half away from zero
        q, r = divmod(abs(s) * 10**4, n)
        avg6 = (q + (2 * r >= n)) * (1 if s >= 0 else -1)
        no_orders = ~torch.isin(d("customer", "c_custkey"), d("orders", "o_custkey"))
        rows = torch.nonzero(in_set & (bal * 10**4 > avg6) & no_orders).flatten()
        inv, G, first = group([cc[rows]])
        return Answer(["cntrycode", "numcust", "totacctbal"],
                      [RCol("string", cc[rows][first], cc_dict),
                       RCol("int", count(inv, G)),
                       RCol("decimal", k.dsum(bal[rows], inv, G), scale=2)],
                      [(0, False)])
