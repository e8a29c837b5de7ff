"""Multi-device plane helpers (the twin of ``repro.parallel``)."""
