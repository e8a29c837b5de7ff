"""Model code of the port (the twin of ``repro.models``)."""
