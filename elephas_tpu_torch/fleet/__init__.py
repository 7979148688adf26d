"""The parameter client's retry/backoff constants (a partial copy of
``elephas_tpu/fleet/resilience.py``)."""
