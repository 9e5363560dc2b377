from . import h2o, nyctaxi
from .queries import ANALYTIC_QUERIES, TPCH_QUERIES
