"""Atomic durable-write primitives (the JAX package's ``durable.py``:
the functions the delta store and the flight recorder use).

Crash safety reduces to one idiom: write the full payload to a
temporary file in the destination directory, fsync it, rename it over
the destination, then fsync the directory so the rename itself is
durable. A reader then never observes a half-written artifact — it
sees either the old file or the new one.
"""

from __future__ import annotations

import os
import tempfile

__all__ = ["atomic_write_bytes", "atomic_write_text", "fsync_dir"]


def fsync_dir(path):
    """fsync a directory so renames inside it survive power loss.

    Best-effort: some platforms/filesystems refuse O_RDONLY fsync on
    directories; a failure there degrades durability, not correctness.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path, data):
    """Write ``data`` to ``path`` atomically (temp + fsync + rename).

    Returns ``path``. On any failure the destination is untouched and
    the temporary file is removed.
    """
    path = os.fspath(path)
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(directory)
    return path


def atomic_write_text(path, text, encoding="utf-8"):
    """Text-mode convenience wrapper over :func:`atomic_write_bytes`."""
    return atomic_write_bytes(path, text.encode(encoding))
