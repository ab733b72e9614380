"""Per-layer readers: ``read(ctx, **args)`` returns the metric's value,
or None where the run holds nothing for it to read (the metric is then
left out of the line). ``ctx`` is the run's record (``cells.py``)."""
