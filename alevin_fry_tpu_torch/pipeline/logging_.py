"""Stage logging to stderr under the ``aft_torch`` logger (the
reference uses slog with timestamped terminal output,
src/main.rs:263-272).  In a multi-process run each line names its
rank."""

from __future__ import annotations

import logging
import sys

_CONFIGURED = False


class _RankFilter(logging.Filter):
    """Sets ``record.rank`` to `` rank r/N`` in a multi-process run, else
    to the empty string."""

    def filter(self, record: logging.LogRecord) -> bool:
        from ..parallel import dist

        rank, world = (dist.rank_world() if dist.is_initialized() else (0, 1))
        record.rank = f" rank {rank}/{world}" if world > 1 else ""
        return True


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        h = logging.StreamHandler(sys.stderr)
        h.addFilter(_RankFilter())
        h.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s [%(name)s]%(rank)s %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        root = logging.getLogger("aft_torch")
        root.addHandler(h)
        root.setLevel(logging.INFO)
        _CONFIGURED = True
    return logging.getLogger(f"aft_torch.{name}")
