"""One driver a traffic kind: ``run(cell)`` sets up, measures and
checks (``kwsbench.harness``)."""
