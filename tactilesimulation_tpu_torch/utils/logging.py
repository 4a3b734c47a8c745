"""Training output: console messages, a plain-text ``logs.txt`` and
scalar streams.

Port of ``tactilesimulation_tpu/utils/logging.py``: the console printers,
``TextLog`` and ``SummaryWriter`` (TensorBoard scalars through
``torch.utils.tensorboard``, else a ``scalars.jsonl`` file), and
``read_scalars``, which reads either back.
"""

from __future__ import annotations

import glob
import json
import os
import struct
import time


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


def _tensorboard_writer():
    """``torch.utils.tensorboard.SummaryWriter``, or None where the
    ``tensorboard`` package is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter as TBWriter
    except ImportError:
        return None
    return TBWriter


class SummaryWriter:
    """Scalar streams into ``logdir``: TensorBoard event files where
    ``torch.utils.tensorboard`` imports (``backend`` "tensorboard"), else
    one JSON object a line in ``scalars.jsonl`` (``backend`` "jsonl")."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        tb = _tensorboard_writer()
        self.backend = "jsonl" if tb is None else "tensorboard"
        if tb is None:
            self._tb = None
            self._fp = open(os.path.join(logdir, "scalars.jsonl"), "a")
        else:
            self._tb = tb(logdir)

    def add_scalar(self, tag, value, step):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        else:
            self._fp.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        else:
            self._fp.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._fp.close()


def _records(path):
    """The payloads of a TFRecord file (length, its CRC, data, its CRC)."""
    with open(path, "rb") as fp:
        while True:
            head = fp.read(12)
            if len(head) < 12:
                return
            (n,) = struct.unpack("<Q", head[:8])
            data = fp.read(n)
            fp.read(4)
            yield data


def read_scalars(logdir):
    """{tag: [(step, value), ...]} of what a ``SummaryWriter`` wrote into
    ``logdir``, in write order, from either backend. TensorBoard stores the
    values in float32."""
    out = {}
    path = os.path.join(logdir, "scalars.jsonl")
    if os.path.exists(path):
        with open(path) as fp:
            for line in fp:
                rec = json.loads(line)
                out.setdefault(rec["tag"], []).append(
                    (rec["step"], rec["value"]))
    events = sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*")))
    if events:
        from tensorboard.compat.proto import event_pb2
        for ev_path in events:
            for data in _records(ev_path):
                ev = event_pb2.Event.FromString(data)
                for v in ev.summary.value:
                    if v.HasField("simple_value"):
                        x = v.simple_value
                    else:
                        x = v.tensor.float_val[0]
                    out.setdefault(v.tag, []).append((int(ev.step), float(x)))
    return out
