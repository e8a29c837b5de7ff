"""Serving components over the splay index (the twin of ``repro.serve``)."""
