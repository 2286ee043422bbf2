from .adamw import Optimizer, adamw, apply_updates, sgd_momentum
from .schedule import constant, cosine, linear_warmup, wsd

__all__ = [
    "Optimizer",
    "adamw",
    "apply_updates",
    "constant",
    "cosine",
    "linear_warmup",
    "sgd_momentum",
    "wsd",
]
