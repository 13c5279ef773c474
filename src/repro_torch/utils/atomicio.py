"""Crash-safe file publication: write-temp-then-``os.replace``.

Every artifact this repo publishes for another process to read — fleet
manifest shards, campaign reports, ``BENCH_*.json`` trend files — must
appear atomically: a reader (or a resumed CI job) either sees the complete
previous version or the complete new one, never a truncated half-write
from a killed writer.  These helpers are the one sanctioned way to do
that (the JAX package's analyzer flags plain ``open(path, "w")`` dumps
that bypass them as RPR301).

The temp file is created *next to* the destination (same directory, and
therefore the same filesystem) because ``os.replace`` is only atomic
within one filesystem — a ``tempfile.mkstemp()`` default of ``/tmp`` would
turn the rename into a copy+delete on many setups (RPR302).
"""

from __future__ import annotations

import json
import os
import socket
from typing import Any


def _tmp_path(path: str) -> str:
    """Sibling temp name, unique per (host, pid) so concurrent writers on a
    shared filesystem never collide on the temp file itself."""
    host = "".join(c if c.isalnum() else "_" for c in socket.gethostname())
    return f"{path}.tmp.{host}-{os.getpid()}"


def atomic_write_text(path: str, text: str) -> None:
    """Publish ``text`` at ``path`` atomically (temp sibling + fsync +
    ``os.replace``)."""
    tmp = _tmp_path(path)
    try:
        with open(tmp, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, payload: Any, indent: int = 1) -> None:
    """Publish ``payload`` as JSON at ``path`` atomically."""
    atomic_write_text(path, json.dumps(payload, indent=indent))
