from repro_torch.optim.optimizers import (adafactor, adamw, apply_updates,
                                          clip_by_global_norm, get_optimizer,
                                          sgd, stacked_grads, stacked_params)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine
