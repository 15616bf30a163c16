"""The port's logger (a single stream logger, as in ``unionml_tpu._logging``)."""

import logging

logger = logging.getLogger("unionml_tpu_torch")

if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("[%(name)s] %(asctime)s %(levelname)s: %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
