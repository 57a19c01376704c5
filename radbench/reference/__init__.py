"""The plain float64 reference that decides ``correct``.  It imports
nothing of the program under test."""
