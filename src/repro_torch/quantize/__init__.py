from repro_torch.quantize.evaluate import (cnn_measured_accuracy,
                                           partition_plan, quantized_eval)
