"""Colored logging for the command line (counterpart of tapqir_tpu/logger.py)."""

import logging
import sys
from pathlib import Path

try:
    import colorama

    _COLORS = {
        logging.DEBUG: colorama.Fore.CYAN,
        logging.INFO: colorama.Fore.GREEN,
        logging.WARNING: colorama.Fore.YELLOW,
        logging.ERROR: colorama.Fore.RED,
        logging.CRITICAL: colorama.Fore.RED + colorama.Style.BRIGHT,
    }
    _RESET = colorama.Fore.RESET + colorama.Style.RESET_ALL
except ImportError:  # pragma: no cover
    _COLORS = {}
    _RESET = ""


class ColorFormatter(logging.Formatter):
    """Level-colored log formatter."""

    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        msg = super().format(record)
        return f"{color}{record.levelname}{_RESET} - {msg}" if color else msg


def init_logger(workdir: Path, name: str = "tapqir_tpu_torch") -> logging.Logger:
    """The package logger ``name``: INFO to stdout and DEBUG to
    ``<workdir>/.tapqir/loginfo``; the loggers of the package's modules
    propagate into it. Handlers of an earlier call are closed."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()

    ch = logging.StreamHandler(sys.stdout)
    ch.setLevel(logging.INFO)
    ch.setFormatter(ColorFormatter(fmt="%(message)s"))
    logger.addHandler(ch)

    fh = logging.FileHandler(Path(workdir) / ".tapqir" / "loginfo")
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(
        logging.Formatter(
            fmt="%(asctime)s - %(levelname)s - %(message)s",
            datefmt="%m/%d/%Y %I:%M %p",
        )
    )
    logger.addHandler(fh)
    return logger
