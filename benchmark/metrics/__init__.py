"""Per-layer metric readers: ``<metric>.py`` defines ``read(record)``,
returning the metric's value, or None where the run left nothing to read."""
