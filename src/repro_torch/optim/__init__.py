from repro_torch.optim.optimizers import (OptState, adam, init_opt_state,
                                          momentum, optimizer_update, sgd)
from repro_torch.optim.schedule import (constant, cosine, linear_warmup,
                                        sqrt_decay)

__all__ = ["OptState", "adam", "constant", "cosine", "init_opt_state",
           "linear_warmup", "momentum", "optimizer_update", "sgd",
           "sqrt_decay"]
