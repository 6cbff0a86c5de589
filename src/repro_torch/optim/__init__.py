"""Optimizers and learning-rate schedules."""
from repro_torch.optim.optimizers import (  # noqa: F401
    adafactor,
    adamw,
    make_optimizer,
    sgd_momentum,
)
from repro_torch.optim.schedules import warmup_cosine, warmup_step  # noqa: F401
