"""Observability: trace context, the metrics registry, structured
events, trace spans with their critical-path attribution, the
engine-loop profiler, its stall watchdog and the SLO plane (copies of
``elephas_tpu/obs``'s ``context.py``, ``metrics.py``, ``events.py``,
``spans.py``, ``critical_path.py``, ``profiler.py``, ``watchdog.py`` and
``slo.py``)."""
