from repro_torch.data.synthetic import (SyntheticImages, SyntheticTokens,
                                        batch_iterator, make_batch_for)
