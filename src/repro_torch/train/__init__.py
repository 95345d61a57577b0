from repro_torch.train.optim import AdamWConfig, init_state, apply_update
from repro_torch.train.steps import (make_train_step, make_prefill_step,
                                     make_serve_step, model_params)
from repro_torch.data.pipeline import SyntheticLMData, make_global_batch
