"""Training output: console messages and a plain-text ``logs.txt``.

Port of the console printers and ``TextLog`` of
``tactilesimulation_tpu/utils/logging.py``.
"""

from __future__ import annotations

import os


def print_ok(*message):
    print("\033[92m", *message, "\033[0m", flush=True)


def print_info(*message):
    print("\033[96m", *message, "\033[0m", flush=True)


def print_warning(*message):
    print("\033[93m", *message, "\033[0m", flush=True)


def print_error(*message):
    print("\033[91m", *message, "\033[0m", flush=True)
    raise RuntimeError(" ".join(str(m) for m in message))


class TextLog:
    """Plain-text training log, one line per append."""

    def __init__(self, path, append: bool = False):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        if not append:
            open(path, "w").close()

    def append(self, line):
        with open(self.path, "a") as fp:
            fp.write(line + "\n")
