"""Traffic: one data file a mix (``<mix>.json``: its ``kind`` and
parameters) and one generator a kind (``<kind>.py``, ``run(ctx)``)."""
