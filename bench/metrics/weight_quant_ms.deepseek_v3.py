"""The stages' weight quantization a vector (ms) on DeepSeek-V3: the
program's ``oracle.quantize`` spans over the traced vectors (a stage's
leaves stacked by unit kind, MLA, MLP and expert layer, and
fake-quantized; up to 4.09 B parameters a vector), as
``weight_quant_ms.granite`` reads them."""

from bench.lib.harness import metric_module

read = metric_module("weight_quant_ms.granite").read
