"""The resumable synthetic token pipeline (port of ``repro.data``)."""
