"""The stages' time a vector (ms): the program's ``oracle.stage`` spans
over the traced vectors (each stage's run on the host clock, waited for on
the device; the head in the last; no span nests inside one, so this is
their self time), returned by the driver, over the traced vectors."""


def read(ctx):
    n = ctx.out.get("traced_vectors")
    durs = [s["dur"] for s in ctx.out.get("spans", [])
            if s["name"] == "oracle.stage"]
    if not n or not durs:
        return None
    return 1e3 * sum(durs) / n
