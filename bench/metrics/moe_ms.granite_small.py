"""The expert layers' time a vector (ms): the ``moe_ms`` of the program's
``oracle.stage`` spans over the traced vectors (each stage's expert units,
from CUDA events read at the stage's sync: the router, the dispatch with
its one read of the held experts' row counts, the held experts' and the
shared expert's products), returned by the driver, over the traced
vectors."""


def read(ctx):
    n = ctx.out.get("traced_vectors")
    ms = [s["args"]["moe_ms"] for s in ctx.out.get("spans", [])
          if s["name"] == "oracle.stage" and "moe_ms" in (s["args"] or {})]
    if not n or not ms:
        return None
    return sum(ms) / n
