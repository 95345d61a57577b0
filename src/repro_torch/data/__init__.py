from repro_torch.data.pipeline import SyntheticLMData, make_global_batch
