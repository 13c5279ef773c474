from repro_torch.training.train_lib import (IGNORE, TrainState, cross_entropy,
                                            evaluate_classifier, init_params,
                                            lm_loss,
                                            make_classifier_train_step,
                                            make_train_step)
