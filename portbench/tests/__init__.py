"""CPU tests of the benchmark at a tiny size; the card-only test carries
the ``gpu`` marker."""
