"""Mesh layouts (logical axes and the index plane), collectives and the
GPipe pipeline over ranks (the twin of ``repro.parallel``)."""
