"""One reader a metric (``<name>.py``: ``read(run)``), and the shared
arithmetic (``arith.py``)."""
