"""One reader a per-layer metric: ``metrics/<metric>.py`` with ``read(record)``."""
