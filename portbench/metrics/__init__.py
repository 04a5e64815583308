"""Per-layer metrics, one reader a file: ``<name>.py`` defines
``read(window) -> float | None`` over one rank's
:class:`portbench.trace.Window`.  A reader that finds nothing to read
returns None, and the run leaves the metric out of its line."""
