"""Atomic durable-write primitives shared by every on-disk artifact
(the JAX package's ``durable.py``).

Crash safety reduces to one idiom: write the full payload to a
temporary file in the destination directory, fsync it, rename it over
the destination, then fsync the directory so the rename itself is
durable. A reader then never observes a half-written artifact — it
sees either the old file or the new one.

The checkpoint writer, the flight recorder, the pack and delta stores
and the persisted executable tier all route through these helpers.
Only the serve journal's CRC-framed log writes in place (append mode);
its frames carry their own torn-tail recovery protocol.
"""

from __future__ import annotations

import json
import os
import tempfile

__all__ = ["atomic_write_bytes", "atomic_write_text", "atomic_write_json",
           "fsync_dir", "atomic_replace"]


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


def atomic_write_json(path, obj, **dumps_kwargs):
    """Serialize ``obj`` as JSON and write it atomically."""
    return atomic_write_text(path, json.dumps(obj, **dumps_kwargs))


def atomic_replace(src, dst):
    """Atomically move ``src`` over ``dst`` and fsync the directory.

    The single-syscall building block for snapshot rotation: a crash
    before the replace leaves ``dst`` intact, a crash after leaves the
    new generation — never a mixed pair.
    """
    os.replace(src, dst)
    fsync_dir(os.path.dirname(os.fspath(dst)) or ".")
