"""Single-device subset of ``repro.distributed`` used by the manager."""
