"""The stages' weight quantization a vector (ms): the program's
``oracle.quantize`` spans over the traced vectors (one a stage as the
runner is built: its units' leaves stacked by kind and fake-quantized;
no span nests inside one, so this is their self time), returned by the
driver, over the traced vectors."""


def read(ctx):
    n = ctx.out.get("traced_vectors")
    durs = [s["dur"] for s in ctx.out.get("spans", [])
            if s["name"] == "oracle.quantize"]
    if not n or not durs:
        return None
    return 1e3 * sum(durs) / n
