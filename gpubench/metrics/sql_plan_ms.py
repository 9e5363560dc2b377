"""sql_plan_ms: ctx.sql(text) per query, in ms: parsing and logical
planning (client and SQL front end). Host clock around the call."""


def read(rec):
    return sum(rec.sql_s) / len(rec.sql_s) * 1e3 if rec.sql_s else None
