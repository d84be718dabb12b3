"""Training: optimizers and the train step (port of ``repro.train``)."""
