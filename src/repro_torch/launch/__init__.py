"""Entry points of the port (counterpart of repro.launch and examples/):
``serve_llm`` and ``tradeoff_sweep``."""
