"""Reusable test instrumentation (fault injection for the resilience
hierarchy lives in ``repro_torch.testing.faults``)."""
