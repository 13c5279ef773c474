"""MLA's time a vector (ms): the ``mla_ms`` of the program's
``oracle.stage`` spans over the traced vectors (each stage's MLA units,
from CUDA events read at the stage's sync: the latent projections, YaRN's
rotation, the decompressions, the causal core through ``chunked_sdpa`` and
the output projection, each unit's RMSNorm and residual with them),
returned by the driver, over the traced vectors."""


def read(ctx):
    n = ctx.out.get("traced_vectors")
    ms = [s["args"]["mla_ms"] for s in ctx.out.get("spans", [])
          if s["name"] == "oracle.stage" and "mla_ms" in (s["args"] or {})]
    if not n or not ms:
        return None
    return sum(ms) / n
