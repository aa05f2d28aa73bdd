"""One reader per metric, ``<metric name>.py`` with ``read(ctx)``,
found by name; a reader that finds nothing to read returns None."""
