"""The benchmark's general code: the run (``core``), the corpus generator
(``corpus``), the weights (``weights``), the trace reduction (``trace``),
the card's published peaks (``peaks``) and the comparison that decides
``correct`` (``compare``)."""
