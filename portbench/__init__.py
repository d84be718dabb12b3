"""The port's benchmark: cells, traffic, metrics and the plain reference
that decides ``correct``.  ``run.py`` runs one cell once."""
