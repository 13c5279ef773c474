from repro_torch.data.synthetic import SyntheticImages, SyntheticTokens
