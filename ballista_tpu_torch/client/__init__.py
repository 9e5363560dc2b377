from .context import SessionContext
from .dataframe import DataFrame, col, lit
