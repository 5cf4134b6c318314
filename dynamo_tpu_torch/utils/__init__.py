"""Cross-cutting utilities: logging configuration, layered settings.

Copied from dynamo_tpu/utils/__init__.py."""
