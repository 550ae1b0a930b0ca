"""Stdlib logging setup with dependency-noise suppression.

Reference: ddpo/utils/logger.py:7-29.
"""

from __future__ import annotations

import logging
import warnings


def init_logging(name: str, verbose: bool = False) -> logging.Logger:
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("[ %(name)s ] %(message)s"))

    logger = logging.getLogger(name)
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False

    if verbose:
        logging.getLogger("torch").setLevel(logging.INFO)
    else:
        logging.getLogger("torch").setLevel(logging.WARNING)
        logging.getLogger("transformers").setLevel(logging.ERROR)
        warnings.simplefilter(action="ignore", category=FutureWarning)

    return logger
