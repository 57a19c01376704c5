"""Traffic kinds: ``<kind>.py`` defines ``Traffic``, which a cell's
``traffic`` names.  See radbench/README.md."""
