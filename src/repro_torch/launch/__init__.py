"""Entry points of the port (counterpart of repro.launch, examples/ and the
paper's benchmarks): ``serve_llm``, ``tradeoff_sweep``, ``resume_sweep``,
``train`` and ``paper_figures``."""
