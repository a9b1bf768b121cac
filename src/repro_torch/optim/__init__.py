from repro_torch.optim.optimizers import (adam, adamw, apply_updates, clip_by_global_norm,
                                          sgd)
from repro_torch.optim.schedules import constant, cosine, wsd
