"""The expert layers' time a vector (ms) on DeepSeek-V3: the ``moe_ms``
of the program's ``oracle.stage`` spans over the traced vectors (the
``noaux_tc`` router, the dispatch with its one read of the held experts'
row counts, the held experts' and the shared expert's products), as
``moe_ms.granite_small`` reads them."""

from bench.lib.harness import metric_module

read = metric_module("moe_ms.granite_small").read
