"""Observability of the parameter plane: trace context, the metrics
registry and structured events (copies of ``elephas_tpu/obs``'s
``context.py``, ``metrics.py`` and ``events.py``)."""
