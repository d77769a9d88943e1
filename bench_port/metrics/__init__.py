"""One reader a metric, named after it: ``UNIT``, ``LAYER``, ``MOVES`` and
``read(record) -> float | None`` over a run's record (the driver's window
record plus ``setup_s``).  A reader that finds nothing to read returns
None, and the metric is left out of the run's line.  Files that start with
``_`` are the yardstick the readers share: the operation count and the
table of peaks."""
