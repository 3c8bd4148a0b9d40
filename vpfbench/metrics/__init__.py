"""One reader a per-layer metric, named as the metric: ``read(record)``
returns the number, or None where the run recorded nothing to read (a
share of a roofline or a peak is then left out, never 0)."""
