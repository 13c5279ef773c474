"""Device-to-host reads a search: the profiler's device-to-host copies
(each ``.item()``, ``int(tensor)`` or ``.cpu()``) over the traced search,
the peel's one read a front among them."""


def read(ctx):
    tr, n = ctx.trace, ctx.out.get("traced_searches")
    if tr is None or not n or not tr.device:
        return None
    return tr.device_to_host_copies() / n
