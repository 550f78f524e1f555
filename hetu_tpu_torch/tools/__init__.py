"""Operator tools over the port's telemetry artifacts (copies of
``hetu_tpu/tools/``'s jax-free readers)."""
