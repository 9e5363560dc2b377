from .queries import ANALYTIC_QUERIES, TPCH_QUERIES
