"""Rank-zero-only logging helpers (the port of
``ray_lightning_tpu/utils/rank_zero.py``).

Workers set ``rank_zero_only.rank`` to their global rank, so only rank 0
emits warnings and summaries (the reference sets PTL's the same way,
``ray_ddp.py:169``).
"""
import functools
import logging
from typing import Any, Callable, Optional, TypeVar

logger = logging.getLogger("ray_lightning_tpu_torch")

T = TypeVar("T", bound=Callable[..., Any])


def rank_zero_only(fn: T) -> T:
    """Decorator: run ``fn`` only on global rank 0 (returns None elsewhere)."""

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Optional[Any]:
        if getattr(rank_zero_only, "rank", 0) == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped  # type: ignore[return-value]


rank_zero_only.rank = 0  # type: ignore[attr-defined]


@rank_zero_only
def rank_zero_info(msg: str, *args: Any) -> None:
    logger.info(msg, *args)


@rank_zero_only
def rank_zero_warn(msg: str, *args: Any) -> None:
    logger.warning(msg, *args)
