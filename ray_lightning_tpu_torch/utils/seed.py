"""Seed plumbing (the JAX package's ``utils/seed.py``).

``seed_everything`` seeds Python's ``random``, numpy and torch and records
the seed in the environment; ``reset_seed`` re-applies a recorded seed at
the start of a run. The trainer derives its per-step generators from the
same seed, so a fixed seed gives the same run twice.
"""
import os
import random
from typing import Optional

import numpy as np
import torch

GLOBAL_SEED_ENV = "RLT_GLOBAL_SEED"


def seed_everything(seed: Optional[int] = None) -> int:
    """Seed Python, numpy and torch, and record the seed for later runs."""
    if seed is None:
        env = os.environ.get(GLOBAL_SEED_ENV)
        seed = int(env) if env is not None else random.randint(0, 2**31 - 1)
    seed = int(seed)
    os.environ[GLOBAL_SEED_ENV] = str(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


def reset_seed() -> Optional[int]:
    """Re-apply the recorded seed, if one was set."""
    env = os.environ.get(GLOBAL_SEED_ENV)
    if env is None:
        return None
    return seed_everything(int(env))
