"""Per-layer metrics: ``<metric>.py`` defines ``read(run)`` (a
``radbench.run.Run``), which returns the metric's value or None where the
run holds nothing to read.  See radbench/README.md."""
