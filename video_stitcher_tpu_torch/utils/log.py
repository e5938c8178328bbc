"""Structured logging (vs the reference's LOGLN cout macro, defs.h:77)."""

import logging

_logger = logging.getLogger("video_stitcher_tpu_torch")
if not _logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    _logger.addHandler(h)
    _logger.setLevel(logging.INFO)

info = _logger.info
warning = _logger.warning
error = _logger.error
debug = _logger.debug
