from repro_torch.models import attention, common, model, moe, recurrent
from repro_torch.models.common import ShardCtx
from repro_torch.models.model import (LM, decode_step, forward, init_params,
                                      load_params, model_cache_defs,
                                      model_defs, prefill, sample_greedy)

__all__ = [
    "LM", "ShardCtx", "attention", "common", "decode_step", "forward",
    "init_params", "load_params", "model", "model_cache_defs", "model_defs",
    "moe", "prefill", "recurrent", "sample_greedy",
]
