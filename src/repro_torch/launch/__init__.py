"""Command-line drivers of the port (the twin of ``repro.launch``)."""
