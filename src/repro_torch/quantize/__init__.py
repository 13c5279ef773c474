from repro_torch.quantize.evaluate import (cnn_measured_accuracy,
                                           lm_measured_accuracy,
                                           partition_plan, qat_finetune,
                                           quantized_eval)
