"""Structured run logging (replaces the reference's stderr printfs,
sim5utils.c:6-54, with standard logging + JSON run records).

Port of `sim5_tpu/utils/log.py`."""

import json
import logging
import sys
import time


def get_logger(name="sim5_tpu_torch"):
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "[%(asctime)s %(name)s %(levelname)s] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def log_run(logger, event, **fields):
    """Emit one structured JSON record (config, throughput, shard stats)."""
    rec = dict(event=event, t=time.time(), **fields)
    logger.info(json.dumps(rec))
