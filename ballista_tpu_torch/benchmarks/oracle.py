"""Pandas reference implementations of the 22 TPC-H queries: the row-exact
oracle the engine is diffed against (port of
ballista_tpu/benchmarks/oracle.py; the reference repo diffs against
expected results the same way, `tpch.rs --expected-results`).

pandas is imported inside the functions, so this module imports where
pandas is absent (the card machine); calling an oracle there raises
ImportError.
"""

import datetime

import numpy as np

from ..schema import TypeKind


def _pd():
    try:
        import pandas
    except ImportError as e:   # pragma: no cover - the card machine
        raise ImportError("the TPC-H oracle needs pandas") from e
    return pandas


def _frame(fields, columns):
    """One table's host columns as the frame the JAX package's `to_pd`
    makes of its arrow table: decimals as float64, dates as
    datetime64[ns], strings as str objects, NULL as NaN / NaT / None."""
    pd = _pd()
    out = {}
    for f in fields:
        h = columns[f.name]
        kind = f.dtype.kind
        valid = h.validity
        if kind is TypeKind.STRING:
            vals = h.dictionary[h.values] if len(h.dictionary) \
                else np.full(len(h.values), "", dtype=object)
            vals = np.asarray(vals, dtype=object).astype(str).astype(object)
            if not valid.all():
                vals[~valid] = None
            out[f.name] = pd.Series(vals)   # pandas infers its str dtype
        elif kind is TypeKind.DECIMAL:
            vals = h.values.astype(np.float64) / 10 ** f.dtype.scale
            out[f.name] = pd.Series(np.where(valid, vals, np.nan))
        elif kind is TypeKind.DATE32:
            # the unit pandas gives date objects (the reference converts
            # those), which differs between pandas versions
            unit = pd.to_datetime(pd.Series([datetime.date(1970, 1, 1)]))
            s = pd.Series(h.values.astype("datetime64[D]")).astype(unit.dtype)
            if not valid.all():
                s[~valid] = pd.NaT
            out[f.name] = s
        elif valid.all():
            out[f.name] = pd.Series(h.values)
        else:
            out[f.name] = pd.Series(np.where(valid, h.values, np.nan))
    return pd.DataFrame(out, columns=[f.name for f in fields])


def to_pd(tables):
    """Port tables -> pandas frames for the oracles. `tables` maps a name
    to `generate_tpch`'s (fields, {column: HostColumn}), or is a context's
    `tables` (providers with `fields` and `host`; a parquet dataset's
    columns are read across its part files, `_host_column`)."""
    out = {}
    for name, t in tables.items():
        fields, columns = ((t.fields, {f.name: t._host_column(f.name)
                                       for f in t.fields})
                           if hasattr(t, "host") else t)
        out[name] = _frame(fields, columns)
    return out


def q1(t):
    pd = _pd()
    li = t["lineitem"]
    f = li[li["l_shipdate"] <= pd.Timestamp("1998-09-02")].copy()
    f["disc_price"] = f["l_extendedprice"] * (1 - f["l_discount"])
    f["charge"] = f["disc_price"] * (1 + f["l_tax"])
    g = f.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "size"),
    )
    return g.sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)


def q3(t):
    pd = _pd()
    c = t["customer"]; o = t["orders"]; li = t["lineitem"]
    c = c[c["c_mktsegment"] == "BUILDING"]
    o = o[o["o_orderdate"] < pd.Timestamp("1995-03-15")]
    li = li[li["l_shipdate"] > pd.Timestamp("1995-03-15")].copy()
    m = li.merge(o, left_on="l_orderkey", right_on="o_orderkey") \
          .merge(c, left_on="o_custkey", right_on="c_custkey")
    m["revenue"] = m["l_extendedprice"] * (1 - m["l_discount"])
    g = m.groupby(["l_orderkey", "o_orderdate", "o_shippriority"], as_index=False) \
         .agg(revenue=("revenue", "sum"))
    g = g[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]]
    return g.sort_values(["revenue", "o_orderdate"],
                         ascending=[False, True]).head(10).reset_index(drop=True)


def q4(t):
    pd = _pd()
    o = t["orders"]; li = t["lineitem"]
    o = o[(o["o_orderdate"] >= pd.Timestamp("1993-07-01")) &
          (o["o_orderdate"] < pd.Timestamp("1993-10-01"))]
    lk = li[li["l_commitdate"] < li["l_receiptdate"]]["l_orderkey"].unique()
    o = o[o["o_orderkey"].isin(lk)]
    g = o.groupby("o_orderpriority", as_index=False).agg(
        order_count=("o_orderkey", "size"))
    return g.sort_values("o_orderpriority").reset_index(drop=True)


def q5(t):
    pd = _pd()
    m = t["customer"].merge(t["orders"], left_on="c_custkey", right_on="o_custkey")
    m = m.merge(t["lineitem"], left_on="o_orderkey", right_on="l_orderkey")
    m = m.merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    m = m[m["c_nationkey"] == m["s_nationkey"]]
    m = m.merge(t["nation"], left_on="s_nationkey", right_on="n_nationkey")
    m = m.merge(t["region"], left_on="n_regionkey", right_on="r_regionkey")
    m = m[(m["r_name"] == "ASIA") &
          (m["o_orderdate"] >= pd.Timestamp("1994-01-01")) &
          (m["o_orderdate"] < pd.Timestamp("1995-01-01"))].copy()
    m["revenue"] = m["l_extendedprice"] * (1 - m["l_discount"])
    g = m.groupby("n_name", as_index=False).agg(revenue=("revenue", "sum"))
    return g.sort_values("revenue", ascending=False).reset_index(drop=True)


def q6(t):
    pd = _pd()
    li = t["lineitem"]
    f = li[(li["l_shipdate"] >= pd.Timestamp("1994-01-01")) &
           (li["l_shipdate"] < pd.Timestamp("1995-01-01")) &
           (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07) &
           (li["l_quantity"] < 24)]
    return pd.DataFrame({"revenue": [(f["l_extendedprice"] * f["l_discount"]).sum()]})


def q7(t):
    pd = _pd()
    n1 = t["nation"].rename(columns=lambda c: "n1_" + c)
    n2 = t["nation"].rename(columns=lambda c: "n2_" + c)
    m = t["supplier"].merge(t["lineitem"], left_on="s_suppkey", right_on="l_suppkey")
    m = m.merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
    m = m.merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
    m = m.merge(n1, left_on="s_nationkey", right_on="n1_n_nationkey")
    m = m.merge(n2, left_on="c_nationkey", right_on="n2_n_nationkey")
    m = m[(((m["n1_n_name"] == "FRANCE") & (m["n2_n_name"] == "GERMANY")) |
           ((m["n1_n_name"] == "GERMANY") & (m["n2_n_name"] == "FRANCE"))) &
          (m["l_shipdate"] >= pd.Timestamp("1995-01-01")) &
          (m["l_shipdate"] <= pd.Timestamp("1996-12-31"))].copy()
    m["l_year"] = m["l_shipdate"].dt.year
    m["volume"] = m["l_extendedprice"] * (1 - m["l_discount"])
    g = m.groupby(["n1_n_name", "n2_n_name", "l_year"], as_index=False).agg(
        revenue=("volume", "sum"))
    g.columns = ["supp_nation", "cust_nation", "l_year", "revenue"]
    return g.sort_values(["supp_nation", "cust_nation", "l_year"]).reset_index(drop=True)


def q8(t):
    pd = _pd()
    n1 = t["nation"].rename(columns=lambda c: "n1_" + c)
    n2 = t["nation"].rename(columns=lambda c: "n2_" + c)
    m = t["part"].merge(t["lineitem"], left_on="p_partkey", right_on="l_partkey")
    m = m.merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    m = m.merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
    m = m.merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
    m = m.merge(n1, left_on="c_nationkey", right_on="n1_n_nationkey")
    m = m.merge(t["region"], left_on="n1_n_regionkey", right_on="r_regionkey")
    m = m.merge(n2, left_on="s_nationkey", right_on="n2_n_nationkey")
    m = m[(m["r_name"] == "AMERICA") &
          (m["o_orderdate"] >= pd.Timestamp("1995-01-01")) &
          (m["o_orderdate"] <= pd.Timestamp("1996-12-31")) &
          (m["p_type"] == "ECONOMY ANODIZED STEEL")].copy()
    if not len(m):
        return pd.DataFrame({"o_year": pd.Series([], dtype=int),
                             "mkt_share": pd.Series([], dtype=float)})
    m["o_year"] = m["o_orderdate"].dt.year
    m["volume"] = m["l_extendedprice"] * (1 - m["l_discount"])
    m["brazil"] = np.where(m["n2_n_name"] == "BRAZIL", m["volume"], 0.0)
    g = m.groupby("o_year", as_index=False).agg(
        brazil=("brazil", "sum"), total=("volume", "sum"))
    g["mkt_share"] = g["brazil"] / g["total"]
    return g[["o_year", "mkt_share"]].sort_values("o_year").reset_index(drop=True)


def q9(t):
    m = t["part"].merge(t["lineitem"], left_on="p_partkey", right_on="l_partkey")
    m = m.merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    m = m.merge(t["partsupp"], left_on=["l_partkey", "l_suppkey"],
                right_on=["ps_partkey", "ps_suppkey"])
    m = m.merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
    m = m.merge(t["nation"], left_on="s_nationkey", right_on="n_nationkey")
    m = m[m["p_name"].str.contains("green")].copy()
    m["o_year"] = m["o_orderdate"].dt.year
    m["amount"] = (m["l_extendedprice"] * (1 - m["l_discount"])
                   - m["ps_supplycost"] * m["l_quantity"])
    g = m.groupby(["n_name", "o_year"], as_index=False).agg(
        sum_profit=("amount", "sum"))
    g.columns = ["nation", "o_year", "sum_profit"]
    return g.sort_values(["nation", "o_year"],
                         ascending=[True, False]).reset_index(drop=True)


def q10(t):
    pd = _pd()
    o = t["orders"]
    o = o[(o["o_orderdate"] >= pd.Timestamp("1993-10-01")) &
          (o["o_orderdate"] < pd.Timestamp("1994-01-01"))]
    li = t["lineitem"]
    li = li[li["l_returnflag"] == "R"]
    m = li.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    m = m.merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
    m = m.merge(t["nation"], left_on="c_nationkey", right_on="n_nationkey").copy()
    m["revenue"] = m["l_extendedprice"] * (1 - m["l_discount"])
    g = m.groupby(["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                   "c_address", "c_comment"], as_index=False).agg(
        revenue=("revenue", "sum"))
    g = g[["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
           "c_address", "c_phone", "c_comment"]]
    return g.sort_values("revenue", ascending=False).head(20).reset_index(drop=True)


def q12(t):
    pd = _pd()
    li = t["lineitem"]
    li = li[li["l_shipmode"].isin(["MAIL", "SHIP"]) &
            (li["l_commitdate"] < li["l_receiptdate"]) &
            (li["l_shipdate"] < li["l_commitdate"]) &
            (li["l_receiptdate"] >= pd.Timestamp("1994-01-01")) &
            (li["l_receiptdate"] < pd.Timestamp("1995-01-01"))]
    m = li.merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey").copy()
    high = m["o_orderpriority"].isin(["1-URGENT", "2-HIGH"])
    m["high_line_count"] = np.where(high, 1, 0)
    m["low_line_count"] = np.where(~high, 1, 0)
    g = m.groupby("l_shipmode", as_index=False).agg(
        high_line_count=("high_line_count", "sum"),
        low_line_count=("low_line_count", "sum"))
    return g.sort_values("l_shipmode").reset_index(drop=True)


def q14(t):
    pd = _pd()
    li = t["lineitem"]
    li = li[(li["l_shipdate"] >= pd.Timestamp("1995-09-01")) &
            (li["l_shipdate"] < pd.Timestamp("1995-10-01"))]
    m = li.merge(t["part"], left_on="l_partkey", right_on="p_partkey").copy()
    m["rev"] = m["l_extendedprice"] * (1 - m["l_discount"])
    promo = m[m["p_type"].str.startswith("PROMO")]["rev"].sum()
    total = m["rev"].sum()
    # SQL: SUM over zero rows is NULL; x/NULL is NULL
    val = 100.0 * promo / total if len(m) and total != 0 else np.nan
    return pd.DataFrame({"promo_revenue": [val]})


def q19(t):
    pd = _pd()
    m = t["lineitem"].merge(t["part"], left_on="l_partkey", right_on="p_partkey")
    c1 = ((m["p_brand"] == "Brand#12") &
          m["p_container"].isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"]) &
          (m["l_quantity"] >= 1) & (m["l_quantity"] <= 11) &
          (m["p_size"] >= 1) & (m["p_size"] <= 5))
    c2 = ((m["p_brand"] == "Brand#23") &
          m["p_container"].isin(["MED BAG", "MED BOX", "MED PKG", "MED PACK"]) &
          (m["l_quantity"] >= 10) & (m["l_quantity"] <= 20) &
          (m["p_size"] >= 1) & (m["p_size"] <= 10))
    c3 = ((m["p_brand"] == "Brand#34") &
          m["p_container"].isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"]) &
          (m["l_quantity"] >= 20) & (m["l_quantity"] <= 30) &
          (m["p_size"] >= 1) & (m["p_size"] <= 15))
    common = (m["l_shipmode"].isin(["AIR", "AIR REG"]) &
              (m["l_shipinstruct"] == "DELIVER IN PERSON"))
    f = m[common & (c1 | c2 | c3)]
    # SQL: SUM over zero rows is NULL
    val = (f["l_extendedprice"] * (1 - f["l_discount"])).sum() if len(f) else np.nan
    return pd.DataFrame({"revenue": [val]})


def q2(t):
    m = t["part"].merge(t["partsupp"], left_on="p_partkey", right_on="ps_partkey")
    m = m.merge(t["supplier"], left_on="ps_suppkey", right_on="s_suppkey")
    m = m.merge(t["nation"], left_on="s_nationkey", right_on="n_nationkey")
    m = m.merge(t["region"], left_on="n_regionkey", right_on="r_regionkey")
    m = m[(m["r_name"] == "EUROPE")]
    mins = m.groupby("p_partkey")["ps_supplycost"].transform("min")
    m = m[(m["p_size"] == 15) & m["p_type"].str.endswith("BRASS") &
          (m["ps_supplycost"] == mins)]
    out = m[["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
             "s_address", "s_phone", "s_comment"]]
    return out.sort_values(["s_acctbal", "n_name", "s_name", "p_partkey"],
                           ascending=[False, True, True, True]).head(100) \
              .reset_index(drop=True)


def q11(t):
    m = t["partsupp"].merge(t["supplier"], left_on="ps_suppkey", right_on="s_suppkey")
    m = m.merge(t["nation"], left_on="s_nationkey", right_on="n_nationkey")
    m = m[m["n_name"] == "GERMANY"].copy()
    m["v"] = m["ps_supplycost"] * m["ps_availqty"]
    g = m.groupby("ps_partkey", as_index=False).agg(value=("v", "sum"))
    thresh = m["v"].sum() * 0.0001
    g = g[g["value"] > thresh]
    return g.sort_values("value", ascending=False).reset_index(drop=True)


def q13(t):
    o = t["orders"]
    o = o[~o["o_comment"].str.contains("special.*requests", regex=True)]
    m = t["customer"].merge(o, left_on="c_custkey", right_on="o_custkey",
                            how="left")
    g = m.groupby("c_custkey", as_index=False).agg(
        c_count=("o_orderkey", "count"))
    g2 = g.groupby("c_count", as_index=False).agg(custdist=("c_count", "size"))
    g2 = g2[["c_count", "custdist"]]
    return g2.sort_values(["custdist", "c_count"],
                          ascending=[False, False]).reset_index(drop=True)


def q15(t):
    pd = _pd()
    li = t["lineitem"]
    f = li[(li["l_shipdate"] >= pd.Timestamp("1996-01-01")) &
           (li["l_shipdate"] < pd.Timestamp("1996-04-01"))].copy()
    f["rev"] = f["l_extendedprice"] * (1 - f["l_discount"])
    rev = f.groupby("l_suppkey", as_index=False).agg(total_revenue=("rev", "sum"))
    mx = rev["total_revenue"].max()
    m = t["supplier"].merge(rev[rev["total_revenue"] == mx],
                            left_on="s_suppkey", right_on="l_suppkey")
    out = m[["s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"]]
    return out.sort_values("s_suppkey").reset_index(drop=True)


def q16(t):
    bad = t["supplier"][t["supplier"]["s_comment"].str.contains(
        "Customer.*Complaints", regex=True)]["s_suppkey"]
    m = t["partsupp"].merge(t["part"], left_on="ps_partkey", right_on="p_partkey")
    m = m[(m["p_brand"] != "Brand#45") &
          ~m["p_type"].str.startswith("MEDIUM POLISHED") &
          m["p_size"].isin([49, 14, 23, 45, 19, 3, 36, 9]) &
          ~m["ps_suppkey"].isin(bad)]
    g = m.groupby(["p_brand", "p_type", "p_size"], as_index=False).agg(
        supplier_cnt=("ps_suppkey", "nunique"))
    return g.sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                         ascending=[False, True, True, True]).reset_index(drop=True)


def q17(t):
    pd = _pd()
    li = t["lineitem"]
    avg_qty = li.groupby("l_partkey")["l_quantity"].transform("mean")
    m = li[li["l_quantity"] < 0.2 * avg_qty]
    m = m.merge(t["part"], left_on="l_partkey", right_on="p_partkey")
    m = m[(m["p_brand"] == "Brand#23") & (m["p_container"] == "MED BOX")]
    val = m["l_extendedprice"].sum() / 7.0 if len(m) else np.nan
    return pd.DataFrame({"avg_yearly": [val]})


def q18(t):
    big = t["lineitem"].groupby("l_orderkey", as_index=False).agg(
        q=("l_quantity", "sum"))
    big = big[big["q"] > 300]["l_orderkey"]
    m = t["orders"][t["orders"]["o_orderkey"].isin(big)]
    m = m.merge(t["customer"], left_on="o_custkey", right_on="c_custkey")
    m = m.merge(t["lineitem"], left_on="o_orderkey", right_on="l_orderkey")
    g = m.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                   "o_totalprice"], as_index=False).agg(
        sq=("l_quantity", "sum"))
    g.columns = ["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                 "o_totalprice", "sum(l_quantity)"]
    return g.sort_values(["o_totalprice", "o_orderdate"],
                         ascending=[False, True]).head(100).reset_index(drop=True)


def q20(t):
    pd = _pd()
    forest = t["part"][t["part"]["p_name"].str.startswith("forest")]["p_partkey"]
    li = t["lineitem"]
    li = li[(li["l_shipdate"] >= pd.Timestamp("1994-01-01")) &
            (li["l_shipdate"] < pd.Timestamp("1995-01-01"))]
    sums = li.groupby(["l_partkey", "l_suppkey"], as_index=False).agg(
        s=("l_quantity", "sum"))
    ps = t["partsupp"][t["partsupp"]["ps_partkey"].isin(forest)]
    m = ps.merge(sums, left_on=["ps_partkey", "ps_suppkey"],
                 right_on=["l_partkey", "l_suppkey"])
    m = m[m["ps_availqty"] > 0.5 * m["s"]]
    sk = m["ps_suppkey"].unique()
    s = t["supplier"][t["supplier"]["s_suppkey"].isin(sk)]
    s = s.merge(t["nation"], left_on="s_nationkey", right_on="n_nationkey")
    s = s[s["n_name"] == "CANADA"]
    return s[["s_name", "s_address"]].sort_values("s_name").reset_index(drop=True)


def q21(t):
    li = t["lineitem"]
    supp_per_order = li.groupby("l_orderkey")["l_suppkey"].nunique()
    late = li[li["l_receiptdate"] > li["l_commitdate"]]
    late_supp = late.groupby("l_orderkey")["l_suppkey"].agg(["nunique", "first"])
    l1 = late.merge(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
    l1 = l1[l1["o_orderstatus"] == "F"]
    l1 = l1.merge(t["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    l1 = l1.merge(t["nation"], left_on="s_nationkey", right_on="n_nationkey")
    l1 = l1[l1["n_name"] == "SAUDI ARABIA"]
    # exists: another supplier in the order
    nsupp = l1["l_orderkey"].map(supp_per_order)
    ex = nsupp >= 2
    # not exists: no OTHER supplier was late on this order
    nlate = l1["l_orderkey"].map(late_supp["nunique"]).fillna(0)
    one_late = l1["l_orderkey"].map(late_supp["first"])
    nex = (nlate == 0) | ((nlate == 1) & (one_late == l1["l_suppkey"]))
    f = l1[ex & nex]
    g = f.groupby("s_name", as_index=False).agg(numwait=("s_name", "size"))
    return g.sort_values(["numwait", "s_name"],
                         ascending=[False, True]).head(100).reset_index(drop=True)


def q22(t):
    c = t["customer"].copy()
    c["cntrycode"] = c["c_phone"].str[:2]
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    pool = c[c["cntrycode"].isin(codes) & (c["c_acctbal"] > 0.0)]
    avg_bal = pool["c_acctbal"].mean()
    has_order = t["orders"]["o_custkey"].unique()
    f = c[c["cntrycode"].isin(codes) & (c["c_acctbal"] > avg_bal) &
          ~c["c_custkey"].isin(has_order)]
    g = f.groupby("cntrycode", as_index=False).agg(
        numcust=("c_acctbal", "size"), totacctbal=("c_acctbal", "sum"))
    return g.sort_values("cntrycode").reset_index(drop=True)


ORACLES = {1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9,
           10: q10, 11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16,
           17: q17, 18: q18, 19: q19, 20: q20, 21: q21, 22: q22}


def diff_frames(got, exp,
                rtol: float = 1e-6, atol: float = 1e-4):
    """Row/column diff (positional columns, ordered rows — TPC-H results
    are globally sorted). Returns None on match, else a short message.
    The reference's `tpch.rs --expected-results` is the same check."""
    pd = _pd()
    if len(got.columns) != len(exp.columns):
        return f"column count {len(got.columns)} vs {len(exp.columns)}"
    if len(got) != len(exp):
        return f"row count {len(got)} vs {len(exp)}"
    for gcol, ecol in zip(got.columns, exp.columns):
        g, e = got[gcol], exp[ecol]
        try:
            if pd.api.types.is_float_dtype(e) or pd.api.types.is_float_dtype(g):
                np.testing.assert_allclose(
                    g.astype(float).to_numpy(), e.astype(float).to_numpy(),
                    rtol=rtol, atol=atol)
            elif pd.api.types.is_datetime64_any_dtype(e):
                if list(pd.to_datetime(g)) != list(e):
                    return f"col {gcol}: datetime mismatch"
            else:
                gl, el = list(g), list(e)
                if gl != el:
                    bad = [i for i, (a, b) in enumerate(zip(gl, el)) if a != b]
                    i = bad[0]
                    return (f"col {gcol}: value mismatch at {len(bad)} rows, "
                            f"first row {i}: got {gl[i]!r} exp {el[i]!r}")
        except AssertionError as err:
            return f"col {gcol}: {str(err).splitlines()[-1][:120]}"
    return None
