"""Prefill / decode of the LM substrate (``engine``)."""
